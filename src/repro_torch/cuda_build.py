"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface. At
first use it is compiled with ``nvcc`` for Hopper (``sm_90a``) into a
shared library under ``_build/`` beside this file (listed in
``.gitignore``), keyed by a hash of the source and the flags, and loaded
with ``ctypes``. The build uses the sources in the package and nothing
else. A failed build raises; nothing falls back to a plain version.

A kernel launched through ``ctypes`` writes into a tensor that autograd
knows nothing of, and none of the kernels has a backward (neither has
the TPU kernel it replaces). ``refuse_autograd`` is each wrapper's guard
against a gradient that would silently be missing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().with_name("_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_INFO: dict[str, dict] = {}   # name -> {"seconds", "cached", "log"}


def refuse_autograd(name: str, tensors) -> None:
    """Raise where autograd would record ``name``'s launch: grad mode on
    and an input that requires grad."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the hand-written CUDA kernel has no backward (nor has "
            f"the TPU kernel it replaces), so autograd would get no gradient "
            f"through it; call it under torch.no_grad() or on tensors that "
            f"do not require grad, and train through the plain route")


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(f"kernel source {src} is missing")
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: list[str] | tuple[str, ...]) -> None:
    """Compile every named kernel not built yet, one ``nvcc`` process per
    source, all started together; raises if any build fails."""
    todo = []
    for name in names:
        src, out = _target(name)
        if out.exists():
            BUILD_INFO.setdefault(name, {"seconds": 0.0, "cached": True,
                                         "log": ""})
            continue
        todo.append((name, src, out))
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = []
    for name, src, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs.append((name, out, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
        BUILD_INFO[name] = {"seconds": time.perf_counter() - t0,
                            "cached": False, "log": log}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)[1]))
        _LIBS[name] = lib
    return lib


def function(name: str, symbol: str, n_ptrs: int, n_ints: int):
    """The C launcher ``symbol`` of kernel library ``name``, typed: its
    ``n_ptrs`` device pointers, then ``n_ints`` ints, then the stream, all
    declared (a pointer passed untyped is cut to 32 bits); returns int."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p] * n_ptrs + [ctypes.c_int] * n_ints + [p]
        fn.restype = ctypes.c_int
    return fn

"""Time flash attention's tensor-core design at other tile shapes.

``csrc/flash_attention.cu`` runs its ``wgmma`` design with two consumer
warpgroups (128 query rows a block) and BK = 64 kv rows a stage: at hd
64 with a ring of 4 stages and two blocks an SM, at hd 128 with 2 stages
and one block. This script builds the same source with one more C entry
point that launches the design at the (BK, consumer warpgroups, stages,
blocks an SM) the caller names, and a second time with p's high part
truncated rather than rounded to bfloat16; prints each variant's
registers and spills (``ptxas -v``); and times each beside
``F.scaled_dot_product_attention`` and the CUDA-core design at the bf16
serve shapes of qwen2-0.5b (8, 2048, 14, 64) and moonshot-v1-16b-a3b (4,
1024, 16, 128), causal, checking each output against ``attention_ref``.
Needs a CUDA card and ``nvcc``:

    python scripts/flash_tile_variants.py
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

SRC = Path(__file__).resolve().parents[1] / "src"
sys.path.insert(0, str(SRC))

from repro_torch import cuda_build  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402

# (hd, BK, consumer warpgroups, stages, blocks an SM); the first of each
# head dim is the design's own
VARIANTS = ((64, 64, 2, 4, 2), (64, 64, 2, 2, 2), (64, 64, 2, 3, 1),
            (64, 128, 2, 3, 1), (64, 128, 2, 2, 1), (64, 64, 3, 3, 1),
            (64, 64, 1, 3, 3), (128, 64, 2, 2, 1), (128, 64, 2, 3, 1),
            (128, 64, 2, 4, 1), (128, 64, 3, 3, 1), (128, 64, 1, 2, 2),
            (128, 128, 2, 2, 1))
# The design splits p into hi = bf16(p), rounded, and lo = bf16(p - hi);
# the "trunc" build takes hi as p truncated to bfloat16 instead (the upper
# 16 bits of each float: one byte permute for two values in place of a
# conversion).
SPLIT_TRUNC = """__device__ __forceinline__ void split_p(float p0, float p1, uint32_t& hi,
                                        uint32_t& lo) {
  const uint32_t u0 = __float_as_uint(p0), u1 = __float_as_uint(p1);
  hi = __byte_perm(u0, u1, 0x7632);
  const __nv_bfloat162 rest =
      __floats2bfloat162_rn(p0 - __uint_as_float(u0 & 0xffff0000u),
                            p1 - __uint_as_float(u1 & 0xffff0000u));
  memcpy(&lo, &rest, sizeof(lo));
}
"""
SHAPES = ((8, 2048, 14, 64), (4, 1024, 16, 128))


def entry() -> str:
    cases = "\n".join(
        f"  if (variant == {i}) return tc::launch<{hd}, {bk}, {nc}, {st}, "
        f"{mb}>(q, k, v, o, B, H, Sq, Sk, causal, window, st_);"
        for i, (hd, bk, nc, st, mb) in enumerate(VARIANTS))
    return f"""
extern "C" int flash_wgmma_at(const void* q, const void* k, const void* v,
                              void* o, int B, int H, int Sq, int Sk,
                              int causal, int window, int variant,
                              void* stream) {{
  cudaStream_t st_ = static_cast<cudaStream_t>(stream);
{cases}
  return static_cast<int>(cudaErrorInvalidValue);
}}
"""


def build(split: str):
    """The source with the variants' entry point; p split as the design
    splits it ("round") or with a truncated hi ("trunc")."""
    text = (cuda_build.CSRC / "flash_attention.cu").read_text()
    if split == "trunc":
        start = text.index("__device__ __forceinline__ void split_p(")
        end = text.index("\n}\n", start) + 3
        text = text[:start] + SPLIT_TRUNC + text[end:]
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = cuda_build.BUILD_DIR / f"flash_tile_variants_{split}.cu"
    src.write_text(text + entry())
    lib = cuda_build.BUILD_DIR / f"libflash_tile_variants_{split}.so"
    out = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                          "-o", str(lib), str(src)], check=True,
                         capture_output=True, text=True)
    log = out.stdout + out.stderr
    fn = ctypes.CDLL(str(lib)).flash_wgmma_at
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, log


def ptxas_lines(log: str) -> dict:
    """(hd, BK, NC, STAGES, MINB) -> "registers, spill bytes" of each
    instantiation of the tensor-core kernel."""
    found = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"flash_wgmma_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)"
                      r"ELi(\d+)E", line)
        if m and "Compiling entry" in line:
            name = tuple(int(x) for x in m.groups())
        elif name and "spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores", line).group(1)
            found[name] = f"spill {spill} B"
        elif name and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            found[name] = f"{regs} regs, {found.get(name, '')}"
            name = None
    return found


def ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    builds = {}
    for split in ("round", "trunc"):
        builds[split], log = build(split)
        for var, line in ptxas_lines(log).items():
            print(f"ptxas {split} {var}: {line}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for b, s, h, hd in SHAPES:
        q, k, v = (torch.randn((b, s, h, hd), generator=gen, device="cuda")
                   .bfloat16() for _ in range(3))
        want = ref.attention_ref(q, k, v, causal=True).float()
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        cells = [
            f"sdpa={ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)):.6f}",  # noqa: E501
            f"simt={ms(lambda: ops.flash_attention_simt(q, k, v), 5):.6f}"]
        out = torch.empty_like(q)
        for i, var in enumerate(VARIANTS):
            if var[0] != hd:
                continue
            args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    b, h, s, s, 1, 0, i, stream)
            for split, launch in builds.items():
                rc = launch(*args)
                torch.cuda.synchronize()
                if rc != 0:
                    cells.append(f"{split} {var[1:]}=launch failed ({rc})")
                    continue
                d = out.float() - want
                rms = float(d.pow(2).mean().sqrt()
                            / want.pow(2).mean().sqrt())
                cells.append(f"{split} BK,NC,ST,MINB={var[1:]}: "
                             f"{ms(lambda: launch(*args)):.6f} "
                             f"(rel_rms={rms:.3g})")
        print(f"{b}x{s}x{h}x{hd}: " + "; ".join(cells), flush=True)
        del q, k, v, qt, kt, vt, out, want


if __name__ == "__main__":
    main()

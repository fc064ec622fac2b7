"""Grouped expert matmul and FFN: the hand-written CUDA kernel on CUDA
tensors, the plain version on CPU tensors (port of
``repro.kernels.moe_gmm.ops``).

``grouped_matmul(x, w)`` is the expert-wise (E, C, D) @ (E, D, F). On CUDA
tensors it launches ``csrc/moe_gmm.cu`` (built with ``nvcc`` at first use)
or raises: there is no fallback. On CPU tensors it runs
``ref.grouped_matmul_ref``. On CUDA tensors it refuses autograd
(``cuda_build.refuse_autograd``): the kernel has no backward, so a
training loss takes the plain version, which is differentiable, as the
reference's training does off the TPU. ``grouped_ffn`` composes gate, up
and down through it; the activation and ``g * u`` stay plain torch, as
they sit outside the Pallas call in the reference.

The kernel has two designs, and which one runs is a pure function of type
and shape, ``gmm_design(dtype, d, f)``:

* ``"wgmma"``: bfloat16 with D and F multiples of 8 (the tensor maps that
  feed TMA want 16-byte strides), every shape of moonshot-v1-16b-a3b's
  serve path. Hopper's tensor cores (``wgmma``) on tiles that TMA brings
  into shared memory.
* ``"simt"``: float32, which stays exact float32 (a TF32 product would not
  keep phase 7 of ``chip_smoke.py``), and bfloat16 with D or F not a
  multiple of 8. The CUDA-core kernel.

Neither design stands in for the other: a build or launch error raises.
``KERNEL_LAUNCHES["grouped_matmul"]`` counts every launch,
``DESIGN_LAUNCHES`` which design ran. ``grouped_matmul_simt`` runs the
CUDA-core design at any shape, as the yardstick ``chip_smoke.py`` times
beside the tensor-core one.
"""

from __future__ import annotations

import torch

from repro_torch import cuda_build
from repro_torch.kernels.moe_gmm import ref

# launches of the kernel, counted by its wrapper: in all, and by design
KERNEL_LAUNCHES = {"grouped_matmul": 0}
DESIGN_LAUNCHES = {"wgmma": 0, "simt": 0}

_TYPES = (torch.float32, torch.bfloat16)
_MAX_GRID = 65535


def gmm_design(dtype: torch.dtype, d: int, f: int) -> str:
    """The design the kernel runs for x (E, C, d) @ w (E, d, f) of
    ``dtype``: "wgmma" for bfloat16 with d > 0 and d and f multiples of 8,
    else "simt" (``grouped_matmul_design`` in ``csrc/moe_gmm.cu``)."""
    aligned = d > 0 and d % 8 == 0 and f % 8 == 0
    return "wgmma" if dtype == torch.bfloat16 and aligned else "simt"


def grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E, C, D) @ w: (E, D, F) -> (E, C, F) in x's type."""
    if not (x.is_cuda or w.is_cuda):
        return ref.grouped_matmul_ref(x, w)
    return grouped_matmul_kernel(x, w)


def grouped_matmul_kernel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/moe_gmm.cu`` in the design ``gmm_design`` names. x and
    w are contiguous CUDA tensors of one type (float32 or bfloat16) on one
    device. Raises on anything else, and if the launch fails."""
    return _launch(x, w, simt=False)


def grouped_matmul_simt(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The CUDA-core design at any shape and type (the yardstick)."""
    return _launch(x, w, simt=True)


def _launch(x, w, *, simt: bool) -> torch.Tensor:
    if not (x.is_cuda and w.is_cuda):
        raise ValueError("grouped_matmul's kernel runs on CUDA tensors only")
    cuda_build.refuse_autograd("grouped_matmul", (x, w))
    if x.device != w.device:
        raise ValueError("grouped_matmul inputs lie on different devices")
    if x.dim() != 3 or w.dim() != 3 or w.shape[:2] != (x.shape[0],
                                                      x.shape[2]):
        raise ValueError(f"grouped_matmul wants x (E, C, D) and w (E, D, F), "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in _TYPES or w.dtype != x.dtype:
        raise TypeError(f"grouped_matmul wants x and w both float32 or both "
                        f"bfloat16, got {x.dtype} and {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("grouped_matmul wants contiguous tensors")
    e, c, d = x.shape
    f = w.shape[2]
    design = "simt" if simt else gmm_design(x.dtype, d, f)
    if e > _MAX_GRID or -(-c // 16) > _MAX_GRID or -(-f // 128) > _MAX_GRID:
        raise ValueError(f"grouped_matmul takes E <= 65535, C <= 1048560 "
                         f"and F <= 8388480, got E={e}, C={c}, F={f}")
    if design == "wgmma" and (x.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError("grouped_matmul's tensor-core design wants x and w "
                         "16-byte aligned (TMA)")
    out = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    symbol = "grouped_matmul_simt_launch" if simt else "grouped_matmul_launch"
    launch = cuda_build.function("moe_gmm", symbol, 3, 5)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(x.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, d, f,
                    int(x.dtype == torch.bfloat16), stream)
    if rc >= 100000:
        raise RuntimeError(f"grouped_matmul: cuTensorMapEncodeTiled failed: "
                           f"CUresult {rc - 100000}")
    if rc == 99999:
        raise RuntimeError("grouped_matmul: the driver has no "
                           "cuTensorMapEncodeTiled")
    if rc != 0:
        raise RuntimeError(f"grouped_matmul launch failed: cudaError {rc}")
    KERNEL_LAUNCHES["grouped_matmul"] += 1
    DESIGN_LAUNCHES[design] += 1
    return out


def grouped_ffn(eb, w_gate, w_up, w_down, *, mlp: str = "swiglu"):
    """Expert FFN act(eb @ w_gate) * (eb @ w_up) @ w_down through
    ``grouped_matmul``: eb (E, C, D); w_gate/w_up (E, D, F); w_down
    (E, F, D)."""
    act = ref.activation(mlp)
    g = act(grouped_matmul(eb, w_gate))
    u = grouped_matmul(eb, w_up)
    return grouped_matmul((g * u).to(eb.dtype), w_down)

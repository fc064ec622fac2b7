"""Flash attention: the hand-written CUDA kernel on CUDA tensors, the plain
version on CPU tensors (port of ``repro.kernels.flash_attention.ops``).

``flash_attention(q, k, v, causal=, window=)`` takes q (B, Sq, H, hd) and
k, v (B, Sk, H, hd) with the heads already GQA-expanded by the caller, as
the TPU kernel does. On CUDA tensors it launches ``csrc/flash_attention.cu``
(built with ``nvcc`` at first use) or raises: there is no fallback. On CPU
tensors it runs ``ref.attention_ref``.

The kernel has two designs, and which one runs is a pure function of type
and head dim, ``flash_design(dtype, hd)``:

* ``"wgmma"``: bfloat16 with hd 64 or 128 (qwen2-0.5b's and
  moonshot-v1-16b-a3b's serve paths). Hopper's tensor cores (``wgmma``)
  on q, k and v tiles that TMA brings into shared memory.
* ``"simt"``: float32, which stays exact float32 (phase 7 of
  ``chip_smoke.py`` holds it), and bfloat16 at other head dims. The
  CUDA-core kernel.

Neither design stands in for the other: a build, encode or launch error
raises. ``KERNEL_LAUNCHES["flash_attention"]`` counts every launch,
``DESIGN_LAUNCHES`` which design ran. ``flash_attention_simt`` runs the
CUDA-core design at any shape, as the yardstick ``chip_smoke.py`` times
beside the tensor-core one.
"""

from __future__ import annotations

import torch

from repro_torch import cuda_build
from repro_torch.kernels.flash_attention import ref

# launches of the kernel, counted by its wrapper: in all, and by design
KERNEL_LAUNCHES = {"flash_attention": 0}
DESIGN_LAUNCHES = {"wgmma": 0, "simt": 0}

_TYPES = (torch.float32, torch.bfloat16)


def flash_design(dtype: torch.dtype, hd: int) -> str:
    """The design the kernel runs for q, k, v of ``dtype`` and head dim
    ``hd``: "wgmma" for bfloat16 with hd 64 or 128, else "simt"
    (``flash_attention_design`` in ``csrc/flash_attention.cu``)."""
    return "wgmma" if dtype == torch.bfloat16 and hd in (64, 128) else "simt"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Blocked online-softmax attention -> (B, Sq, H, hd) in q's type."""
    ts = (q, k, v)
    if not any(t.is_cuda for t in ts):
        return ref.attention_ref(q, k, v, causal=causal, window=window)
    return flash_attention_kernel(q, k, v, causal=causal, window=window)


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = True,
                           window: int = 0) -> torch.Tensor:
    """Launch ``csrc/flash_attention.cu`` in the design ``flash_design``
    names. q, k, v are contiguous CUDA tensors of one type (float32 or
    bfloat16) on one device; hd is a multiple of 8 from 8 to 256. Raises
    on anything else, and if the launch fails."""
    return _launch(q, k, v, causal=causal, window=window, simt=False)


def flash_attention_simt(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    """The CUDA-core design at any shape and type (the yardstick)."""
    return _launch(q, k, v, causal=causal, window=window, simt=True)


def _launch(q, k, v, *, causal: bool, window: int,
            simt: bool) -> torch.Tensor:
    ts = (q, k, v)
    if not all(t.is_cuda for t in ts):
        raise ValueError("flash_attention's kernel runs on CUDA tensors only")
    if len({t.device for t in ts}) != 1:
        raise ValueError("flash_attention inputs lie on different devices")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or q.shape[0] != k.shape[0] or q.shape[2:] != k.shape[2:]:
        raise ValueError(f"flash_attention wants q (B, Sq, H, hd) and k, v "
                         f"(B, Sk, H, hd), got shapes "
                         f"{[tuple(t.shape) for t in ts]}")
    if q.dtype not in _TYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention wants q, k, v all float32 or all "
                        f"bfloat16, got {[t.dtype for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("flash_attention wants contiguous tensors")
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    if hd % 8 or not 8 <= hd <= 256:
        raise ValueError(f"flash_attention takes head dims that are "
                         f"multiples of 8 from 8 to 256, got {hd}")
    if b * h > 65535:
        raise ValueError(f"flash_attention takes B*H <= 65535, got {b * h}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if sk == 0:
        raise ValueError("flash_attention needs at least one key")
    design = "simt" if simt else flash_design(q.dtype, hd)
    if design == "wgmma" and any(t.data_ptr() % 16 for t in ts):
        raise ValueError("flash_attention's tensor-core design wants q, k "
                         "and v 16-byte aligned (TMA)")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    symbol = ("flash_attention_simt_launch" if simt
              else "flash_attention_launch")
    launch = cuda_build.function("flash_attention", symbol, 4, 8)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    b, h, sq, sk, hd, int(causal), int(window),
                    int(q.dtype == torch.bfloat16), stream)
    if rc >= 100000:
        raise RuntimeError(f"flash_attention: cuTensorMapEncodeTiled failed: "
                           f"CUresult {rc - 100000}")
    if rc == 99999:
        raise RuntimeError("flash_attention: the driver has no "
                           "cuTensorMapEncodeTiled")
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {rc}")
    KERNEL_LAUNCHES["flash_attention"] += 1
    DESIGN_LAUNCHES[design] += 1
    return out

"""Chunked WKV6 scan: the hand-written CUDA kernel on CUDA tensors, the
plain chunked version on CPU tensors (port of
``repro.kernels.rwkv6_scan.ops``).

``wkv6(r, k, v, w, u, chunk=, state0=)`` takes r, k, v, w (B, S, H, K)
and u (H, K), with ``chunk = min(chunk, S)`` dividing S, and returns (out
(B, S, H, K) in r's type, final state (B, H, K, K) float32). On CUDA
tensors it launches ``csrc/wkv6.cu`` (built with ``nvcc`` at first use) or
raises: there is no fallback. On CPU tensors it runs
``ref.wkv_chunked_ref``. The kernel starts from ``state0`` itself (zeros
when it is None), which is what the reference's wrapper computes by
folding state0 in by linearity after a zero-state kernel call.

The kernel has two designs, and which one runs is a pure function of
type, head dim and chunk length, ``wkv6_design(dtype, K, chunk)``:

* ``"mma"``: bfloat16 r, k, v at K = 64 with any chunk of 1 to 128 steps
  (rwkv6-3b's prefill, and a ragged prompt's tail block). Two kernels:
  the state pass computes each chunk's update in parallel over chunks
  and hands the state from chunk to chunk, with the CUDA-core design's
  arithmetic (so the final state is bitwise that design's), leaving the
  state before each chunk in a float32 scratch; the output pass runs in
  parallel over (chunk, b·h), with the chunk's products on the tensor
  cores (``mma.sync`` TF32, each float32 operand split in two) on tiles
  that TMA brings in.
* ``"simt"``: float32, and bfloat16 at other head dims. The CUDA-core
  kernel, one block per (b, h).

Neither design stands in for the other: a build, encode or launch error
raises. ``KERNEL_LAUNCHES["wkv6"]`` counts every launch,
``DESIGN_LAUNCHES`` which design ran. ``wkv6_simt`` runs the CUDA-core
design at any shape, as the yardstick ``chip_smoke.py`` times beside the
tensor-core one.
"""

from __future__ import annotations

import torch

from repro_torch import cuda_build
from repro_torch.kernels.rwkv6_scan import ref

# launches of the kernel, counted by its wrapper: in all, and by design
KERNEL_LAUNCHES = {"wkv6": 0}
DESIGN_LAUNCHES = {"mma": 0, "simt": 0}

_TYPES = (torch.float32, torch.bfloat16)
MAX_CHUNK = 128   # the kernel's shared-memory tiles hold up to 128 steps
MAX_K = 64


def wkv6_design(dtype: torch.dtype, K: int, chunk: int) -> str:
    """The design the kernel runs for r, k, v of ``dtype``, head dim ``K``
    and chunk length ``chunk``: "mma" for bfloat16 at K = 64 with a chunk
    of 1 to 128 steps, else "simt" (``wkv6_design`` in
    ``csrc/wkv6.cu``)."""
    return ("mma" if dtype == torch.bfloat16 and K == 64
            and 1 <= chunk <= MAX_CHUNK else "simt")


def _chunk(S: int, chunk: int) -> int:
    """``min(chunk, S)``; raises unless it divides S (the reference
    asserts the same)."""
    c = min(chunk, S)
    if c <= 0 or S % c:
        raise ValueError(f"wkv6: S={S} is not a multiple of chunk={c}")
    return c


def wkv6(r, k, v, w, u, *, chunk: int = 64, state0=None):
    """Chunked WKV6 -> (out (B, S, H, K) in r's type, state (B, H, K, K)
    float32)."""
    c = _chunk(r.shape[1], chunk)
    ts = (r, k, v, w, u) + (() if state0 is None else (state0,))
    if not any(t.is_cuda for t in ts):
        return ref.wkv_chunked_ref(r, k, v, w, u, chunk=c, state0=state0)
    return wkv6_kernel(r, k, v, w, u, chunk=c, state0=state0)


def wkv6_kernel(r, k, v, w, u, *, chunk: int, state0=None):
    """Launch ``csrc/wkv6.cu`` in the design ``wkv6_design`` names. r, k, v
    are contiguous (B, S, H, K) CUDA tensors, all float32 or all bfloat16;
    w (B, S, H, K), u (H, K) and state0 (B, H, K, K) are contiguous
    float32, all on one device; K is a multiple of 8 up to 64, chunk
    divides S and is at most 128, and B·H is at most 65535. Raises on
    anything else, and if the launch fails."""
    return _launch(r, k, v, w, u, chunk=chunk, state0=state0, simt=False)


def wkv6_simt(r, k, v, w, u, *, chunk: int, state0=None):
    """The CUDA-core design at any shape and type (the yardstick)."""
    return _launch(r, k, v, w, u, chunk=chunk, state0=state0, simt=True)


def _launch(r, k, v, w, u, *, chunk: int, state0, simt: bool):
    ts = (r, k, v, w, u) + (() if state0 is None else (state0,))
    if not all(t.is_cuda for t in ts):
        raise ValueError("wkv6's kernel runs on CUDA tensors only")
    if len({t.device for t in ts}) != 1:
        raise ValueError("wkv6 inputs lie on different devices")
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"wkv6 wants r, k, v, w of one shape (B, S, H, K), "
                         f"got shapes {[tuple(t.shape) for t in (r, k, v, w)]}")
    B, S, H, K = r.shape
    if u.shape != (H, K) or (state0 is not None
                             and state0.shape != (B, H, K, K)):
        raise ValueError(f"wkv6 wants u (H, K) = {(H, K)} and state0 "
                         f"(B, H, K, K), got {tuple(u.shape)} and "
                         f"{None if state0 is None else tuple(state0.shape)}")
    if r.dtype not in _TYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"wkv6 wants r, k, v all float32 or all bfloat16, "
                        f"got {[t.dtype for t in (r, k, v)]}")
    if any(t.dtype != torch.float32 for t in ts[3:]):
        raise TypeError(f"wkv6 wants w, u and state0 in float32, got "
                        f"{[t.dtype for t in ts[3:]]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("wkv6 wants contiguous tensors")
    if K % 8 or not 8 <= K <= MAX_K:
        raise ValueError(f"wkv6 takes head dims that are multiples of 8 up "
                         f"to {MAX_K}, got {K}")
    c = _chunk(S, chunk)
    if c > MAX_CHUNK:
        raise ValueError(f"wkv6 takes chunks of at most {MAX_CHUNK} steps, "
                         f"got {c}")
    if B * H > 65535:
        raise ValueError(f"wkv6 takes B*H <= 65535, got {B * H}")
    design = "simt" if simt else wkv6_design(r.dtype, K, c)
    if design == "mma" and any(t.data_ptr() % 16 for t in (r, k, v, w)):
        raise ValueError("wkv6's tensor-core design wants r, k, v and w "
                         "16-byte aligned (TMA)")
    out = torch.empty_like(r)
    state = torch.empty((B, H, K, K), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        args = (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), None if state0 is None else state0.data_ptr(),
                out.data_ptr(), state.data_ptr())
        ints = (B, S, H, K, c, int(r.dtype == torch.bfloat16), stream)
        if simt:
            rc = cuda_build.function("wkv6", "wkv6_simt_launch", 8, 6)(
                *args, *ints)
        else:
            # the "mma" design's scratch: the state before each chunk
            # (B·H, chunks, K, K), then a ticket counter and a flag per
            # chunk (the launcher zeroes them)
            n = B * H * (S // c)
            scratch = (torch.empty(n * K * K + 1 + n, dtype=torch.float32,
                                   device=r.device)
                       if design == "mma" else None)
            rc = cuda_build.function("wkv6", "wkv6_launch", 9, 6)(
                *args, None if scratch is None else scratch.data_ptr(),
                *ints)
    if rc >= 100000:
        raise RuntimeError(f"wkv6: cuTensorMapEncodeTiled failed: CUresult "
                           f"{rc - 100000}")
    if rc == 99999:
        raise RuntimeError("wkv6: the driver has no cuTensorMapEncodeTiled")
    if rc != 0:
        raise RuntimeError(f"wkv6 launch failed: cudaError {rc}")
    KERNEL_LAUNCHES["wkv6"] += 1
    DESIGN_LAUNCHES[design] += 1
    return out, state

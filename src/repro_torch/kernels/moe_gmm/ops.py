"""Grouped expert matmul and FFN: the hand-written CUDA kernel on CUDA
tensors, the plain version on CPU tensors (port of
``repro.kernels.moe_gmm.ops``).

``grouped_matmul(x, w)`` is the expert-wise (E, C, D) @ (E, D, F). On CUDA
tensors it launches ``csrc/moe_gmm.cu`` (built with ``nvcc`` at first use)
or raises: there is no fallback. On CPU tensors it runs
``ref.grouped_matmul_ref``. ``grouped_ffn`` composes gate, up and down
through it; the activation and ``g * u`` stay plain torch, as they sit
outside the Pallas call in the reference.
"""

from __future__ import annotations

import torch

from repro_torch import cuda_build
from repro_torch.kernels.moe_gmm import ref

# launches of the kernel, counted by its wrapper
KERNEL_LAUNCHES = {"grouped_matmul": 0}

_TYPES = (torch.float32, torch.bfloat16)


def grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (E, C, D) @ w: (E, D, F) -> (E, C, F) in x's type."""
    if not (x.is_cuda or w.is_cuda):
        return ref.grouped_matmul_ref(x, w)
    return grouped_matmul_kernel(x, w)


def grouped_matmul_kernel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/moe_gmm.cu``. x and w are contiguous CUDA tensors of
    one type (float32 or bfloat16) on one device. Raises on anything else,
    and if the launch fails."""
    if not (x.is_cuda and w.is_cuda):
        raise ValueError("grouped_matmul's kernel runs on CUDA tensors only")
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
    if e > 65535 or -(-c // 16) > 65535:
        raise ValueError(f"grouped_matmul takes E <= 65535 and C <= "
                         f"1048560, got E={e}, C={c}")
    out = torch.empty((e, c, f), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    launch = cuda_build.function("moe_gmm", "grouped_matmul_launch", 3, 5)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(x.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, d, f,
                    int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"grouped_matmul launch failed: cudaError {rc}")
    KERNEL_LAUNCHES["grouped_matmul"] += 1
    return out


def grouped_ffn(eb, w_gate, w_up, w_down, *, mlp: str = "swiglu"):
    """Expert FFN act(eb @ w_gate) * (eb @ w_up) @ w_down through
    ``grouped_matmul``: eb (E, C, D); w_gate/w_up (E, D, F); w_down
    (E, F, D)."""
    act = ref.activation(mlp)
    g = act(grouped_matmul(eb, w_gate))
    u = grouped_matmul(eb, w_up)
    return grouped_matmul((g * u).to(eb.dtype), w_down)

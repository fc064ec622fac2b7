"""Plain PyTorch version of the grouped expert FFN (port of
``repro.kernels.moe_gmm.ref``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def activation(mlp: str):
    """The gate's activation: silu for swiglu, tanh-approximated gelu
    otherwise (``jax.nn.gelu(approximate=True)``)."""
    if mlp == "swiglu":
        return F.silu
    return lambda u: F.gelu(u, approximate="tanh")


def grouped_ffn_ref(eb, w_gate, w_up, w_down, *, mlp: str = "swiglu"):
    """eb: (E, C, D); w_gate/w_up: (E, D, F); w_down: (E, F, D)."""
    act = activation(mlp)
    g = act(torch.einsum("ecd,edf->ecf", eb, w_gate.to(eb.dtype)))
    u = torch.einsum("ecd,edf->ecf", eb, w_up.to(eb.dtype))
    return torch.einsum("ecf,efd->ecd", g * u, w_down.to(eb.dtype))


def grouped_matmul_ref(x, w):
    """x: (E, C, D), w: (E, D, F) -> (E, C, F)."""
    return torch.einsum("ecd,edf->ecf", x, w.to(x.dtype))

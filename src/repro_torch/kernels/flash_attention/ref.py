"""Plain PyTorch version of the flash-attention kernel (port of
``repro.kernels.flash_attention.ref``)."""

from __future__ import annotations

import math

import torch


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, Sq, H, hd), k/v: (B, Sk, H, hd) -> (B, Sq, H, hd), in q's
    type. Full-precision softmax: scores, weights and the weighted sum are
    float32."""
    hd = q.shape[-1]
    logits = torch.einsum("bqhk,bshk->bhqs", q.float(),
                          k.float()) / math.sqrt(hd)
    sq, sk = q.shape[1], k.shape[1]
    qpos = torch.arange(sq, device=q.device)
    kpos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    logits = logits.masked_fill(~mask, float("-inf"))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqs,bshk->bqhk", w, v.float()).to(q.dtype)

"""Error-feedback int8 gradient compression (port of
``repro.train.compression``).

Per-tensor symmetric int8 quantization with an error-feedback residual
(Seide et al. / EF-SGD): the quantization error is carried into the next
step, so compression is unbiased in the long run. ``torch.round`` rounds
half to even, as ``jnp.round`` does, so ``q`` is the reference's.

Usage in a train step:
    c, new_resid = compress(grad + resid)
    grad_hat = decompress(c)          # what gets all-reduced
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.train.optimizer import tree_map


class Compressed(NamedTuple):
    q: torch.Tensor        # int8 payload
    scale: torch.Tensor    # f32 scalar per tensor


def compress(x: torch.Tensor) -> tuple[Compressed, torch.Tensor]:
    """Returns (compressed, residual error)."""
    xf = x.float()
    scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    err = xf - q.float() * scale
    return Compressed(q=q, scale=scale), err


def decompress(c: Compressed) -> torch.Tensor:
    return c.q.float() * c.scale


def compress_tree(grads, residuals):
    """EF-int8 on every leaf -> (decompressed grads, new residuals);
    ``residuals`` is a tree like ``grads`` (or ``zeros_like_residuals``)."""
    errs = []

    def one(g, r):
        c, err = compress(g.float() + r)
        errs.append(err)
        return decompress(c)

    ghat = tree_map(one, grads, residuals)
    it = iter(errs)
    return ghat, tree_map(lambda _: next(it), grads)


def zeros_like_residuals(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)

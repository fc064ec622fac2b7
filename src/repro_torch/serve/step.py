"""Family-dispatched serving steps: prefill and single-token decode (port
of ``repro.serve.step``).

Ported: the ``dense`` and ``moe`` families (``models.transformer``). The
other families raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig

PORTED = ("dense", "moe")


def not_ported(cfg: ModelConfig) -> NotImplementedError:
    item = ("item 9(b), RWKV-6" if cfg.family == "ssm"
            else "item 9(c), the other families")
    return NotImplementedError(
        f"repro_torch.serve: the {cfg.family!r} family ({cfg.name}) is not "
        f"ported yet (ROADMAP Queue 1, {item})")


def make_prefill_step(cfg: ModelConfig, *, use_flash: bool = False,
                      use_moe_kernel: bool = False):
    if cfg.family not in PORTED:
        raise not_ported(cfg)
    from repro_torch.models import transformer as T

    def prefill(params, tokens):
        return T.prefill(params, tokens, cfg, use_flash=use_flash,
                         use_moe_kernel=use_moe_kernel)
    return prefill


def make_decode_step(cfg: ModelConfig, *, use_moe_kernel: bool = False):
    if cfg.family not in PORTED:
        raise not_ported(cfg)
    from repro_torch.models import transformer as T

    def decode(params, token, caches, index):
        return T.decode_step(params, token, caches, index, cfg,
                             use_moe_kernel=use_moe_kernel)
    return decode


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """(B, S, V) logits -> (B, 1) int64 argmax of the last position (the
    first index among equal maxima, as ``jnp.argmax``)."""
    return torch.argmax(logits[:, -1, :], dim=-1)[:, None]

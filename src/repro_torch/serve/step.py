"""Family-dispatched serving steps: prefill and single-token decode (port
of ``repro.serve.step``).

Ported: the ``dense`` and ``moe`` families (``models.transformer``), the
``ssm`` family (``models.rwkv6``), the ``hybrid`` family
(``models.zamba2``) and the ``audio`` family (``models.encdec``). The
``vlm`` family raises ``NotImplementedError`` naming its ROADMAP item.

The prefill of every family returns (last-position logits, decode state):
the KV caches of the prompt for a transformer, the shift and WKV state
after the prompt for RWKV-6, and for Zamba2 the conv carries, SSD states
and shared-attention KV rings after the prompt (its prefill takes
``max_seq``, the length the rings are sized for; the reference's hybrid
prefill returns the logits only and its serve steps the prompt through
decode); for the encoder–decoder the cross K/V of the frames,
``{"xk", "xv"}`` (its prefill takes ``frames``). A transformer's, Zamba2's
and the encoder–decoder's decode take ``(params, token, state, index)``,
RWKV-6's ``(params, token, state)``, as in the reference.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig

PORTED = ("dense", "moe", "ssm", "hybrid", "audio")


def not_ported(cfg: ModelConfig) -> NotImplementedError:
    return NotImplementedError(
        f"repro_torch.serve: the {cfg.family!r} family ({cfg.name}) is not "
        f"ported yet (ROADMAP Queue 1, item 9(c), the other families)")


def make_prefill_step(cfg: ModelConfig, *, use_kernels: bool = False):
    """``prefill(params, tokens)`` (Zamba2's: ``prefill(params, tokens,
    max_seq=None)``; the encoder–decoder's: ``prefill(params, tokens,
    frames)``). ``use_kernels`` runs every hand-written kernel on the
    family's prefill: flash attention and the grouped expert matmul for a
    transformer, the WKV6 scan for RWKV-6, flash attention in Zamba2's
    shared block and in every attention of the encoder–decoder (on CPU
    tensors their plain versions)."""
    if cfg.family not in PORTED:
        raise not_ported(cfg)
    if cfg.family == "audio":
        from repro_torch.models import encdec as E

        def prefill(params, tokens, frames):
            """Encode once; the decoder over the prompt (the reference's
            ``decode_train``) on those cross K/V -> (last-position
            logits, {"xk", "xv"})."""
            enc = E.encode(params, frames, cfg, use_flash=use_kernels)
            xk, xv = E.precompute_cross_kv(params, enc, cfg)
            logits = E.decode_train(params, tokens, enc, cfg,
                                    use_flash=use_kernels, cross_kv=(xk, xv))
            return logits[:, -1:], {"xk": xk, "xv": xv}
        return prefill
    if cfg.family == "hybrid":
        from repro_torch.models import zamba2 as Z

        def prefill(params, tokens, max_seq=None):
            return Z.prefill(params, tokens, cfg, max_seq=max_seq,
                             use_kernels=use_kernels)
        return prefill
    if cfg.family == "ssm":
        from repro_torch.models import rwkv6 as R

        def prefill(params, tokens):
            return R.prefill(params, tokens, cfg, use_kernel=use_kernels)
        return prefill
    from repro_torch.models import transformer as T

    def prefill(params, tokens):
        return T.prefill(params, tokens, cfg, use_flash=use_kernels,
                         use_moe_kernel=use_kernels)
    return prefill


def make_decode_step(cfg: ModelConfig, *, use_kernels: bool = False):
    """One-token decode. ``use_kernels`` runs a transformer's MoE expert
    FFNs through the grouped matmul kernel; RWKV-6's and Zamba2's decode
    take the one-step recurrences and plain attention over the cache, the
    encoder–decoder's plain attention over its cache and cross K/V, which
    have no kernel."""
    if cfg.family not in PORTED:
        raise not_ported(cfg)
    if cfg.family == "audio":
        from repro_torch.models import encdec as E

        def decode(params, token, caches, index):
            return E.decode_step(params, token, caches, index, cfg)
        return decode
    if cfg.family == "hybrid":
        from repro_torch.models import zamba2 as Z

        def decode(params, token, state, index):
            return Z.decode_step(params, token, state, index, cfg)
        return decode
    if cfg.family == "ssm":
        from repro_torch.models import rwkv6 as R

        def decode(params, token, state):
            return R.decode_step(params, token, state, cfg)
        return decode
    from repro_torch.models import transformer as T

    def decode(params, token, caches, index):
        return T.decode_step(params, token, caches, index, cfg,
                             use_moe_kernel=use_kernels)
    return decode


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """(B, S, V) logits -> (B, 1) int64 argmax of the last position (the
    first index among equal maxima, as ``jnp.argmax``)."""
    return torch.argmax(logits[:, -1, :], dim=-1)[:, None]

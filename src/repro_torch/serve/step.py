"""Family-dispatched serving steps: prefill and single-token decode (port
of ``repro.serve.step``).

Every family is ported: ``dense``, ``moe`` and ``vlm``
(``models.transformer``), ``ssm`` (``models.rwkv6``), ``hybrid``
(``models.zamba2``) and ``audio`` (``models.encdec``).

The prefill of every family returns (last-position logits, decode state):
the KV caches of the prompt for a transformer, the shift and WKV state
after the prompt for RWKV-6, and for Zamba2 the conv carries, SSD states
and shared-attention KV rings after the prompt (its prefill takes
``max_seq``, the length the rings are sized for; the reference's hybrid
prefill returns the logits only and its serve steps the prompt through
decode); for the encoder–decoder the cross K/V of the frames,
``{"xk", "xv"}`` (its prefill takes ``frames``); for the VLM prefix
nothing (``{}``): its prefill takes ``patch_embeds`` (B, P, D) and is
``forward`` over the prefix and the prompt, as the reference's, whose
decode starts from an empty cache. A transformer's, Zamba2's
and the encoder–decoder's decode take ``(params, token, state, index)``,
RWKV-6's ``(params, token, state)``, as in the reference.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm_module


def make_prefill_step(cfg: ModelConfig, *, use_kernels: bool = False):
    """``prefill(params, tokens)`` (Zamba2's: ``prefill(params, tokens,
    max_seq=None)``; the encoder–decoder's: ``prefill(params, tokens,
    frames)``; the VLM's: ``prefill(params, tokens, patch_embeds)``).
    ``use_kernels`` runs every hand-written kernel on the family's
    prefill: flash attention and the grouped expert matmul for a
    transformer (every layer's attention over the P + S rows for the
    VLM), the WKV6 scan for RWKV-6, flash attention in Zamba2's shared
    block and in every attention of the encoder–decoder (on CPU tensors
    their plain versions). An unknown family raises ``ValueError``."""
    M = lm_module(cfg)
    if cfg.family == "vlm":
        def prefill(params, tokens, patch_embeds):
            """``forward`` over the patches and the prompt, unembedding
            the last row alone -> (its logits (B, 1, V_padded), {})."""
            logits = M.forward(params, tokens, cfg,
                               prefix_embeds=patch_embeds,
                               use_flash=use_kernels, last_only=True)
            return logits, {}
        return prefill
    if cfg.family == "audio":
        def prefill(params, tokens, frames):
            """Encode once; the decoder over the prompt (the reference's
            ``decode_train``) on those cross K/V -> (last-position
            logits, {"xk", "xv"})."""
            enc = M.encode(params, frames, cfg, use_flash=use_kernels)
            xk, xv = M.precompute_cross_kv(params, enc, cfg)
            logits = M.decode_train(params, tokens, enc, cfg,
                                    use_flash=use_kernels, cross_kv=(xk, xv))
            return logits[:, -1:], {"xk": xk, "xv": xv}
        return prefill
    if cfg.family == "hybrid":
        def prefill(params, tokens, max_seq=None):
            return M.prefill(params, tokens, cfg, max_seq=max_seq,
                             use_kernels=use_kernels)
        return prefill
    if cfg.family == "ssm":
        def prefill(params, tokens):
            return M.prefill(params, tokens, cfg, use_kernel=use_kernels)
        return prefill

    def prefill(params, tokens):
        return M.prefill(params, tokens, cfg, use_flash=use_kernels,
                         use_moe_kernel=use_kernels)
    return prefill


def make_decode_step(cfg: ModelConfig, *, use_kernels: bool = False):
    """One-token decode. ``use_kernels`` runs a transformer's MoE expert
    FFNs through the grouped matmul kernel; RWKV-6's and Zamba2's decode
    take the one-step recurrences and plain attention over the cache, the
    encoder–decoder's plain attention over its cache and cross K/V, which
    have no kernel; the VLM's is the transformer's. An unknown family
    raises ``ValueError``."""
    M = lm_module(cfg)
    if cfg.family in ("audio", "hybrid"):
        def decode(params, token, state, index):
            return M.decode_step(params, token, state, index, cfg)
        return decode
    if cfg.family == "ssm":
        def decode(params, token, state):
            return M.decode_step(params, token, state, cfg)
        return decode

    def decode(params, token, caches, index):
        return M.decode_step(params, token, caches, index, cfg,
                             use_moe_kernel=use_kernels)
    return decode


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """(B, S, V) logits -> (B, 1) int64 argmax of the last position (the
    first index among equal maxima, as ``jnp.argmax``)."""
    return torch.argmax(logits[:, -1, :], dim=-1)[:, None]

"""Decoder-only transformer LM, ``dense``, ``moe`` and ``vlm`` families
(port of ``repro.models.transformer``).

Parameters are a nested dict of tensors laid out as the reference's: the
per-layer leaves are STACKED on a leading L axis under ``"layers"``, and a
Python loop over layers takes the place of ``maybe_scan`` (layer ``i`` is a
dict of views; the helpers every family shares are in ``models.lm``).
``param_specs`` is that layout, leaf by leaf; ``init_lm`` fills it from a
``torch.Generator`` on the device and ``convert.lm_params`` from a
reference tree.

``forward``, ``prefill`` and ``decode_step`` take ``use_flash``/
``use_moe_kernel`` (named as in the reference's ``_layer_apply``) and pass
them to ``layers.attention`` and ``moe.apply_moe``: on CUDA tensors those
run the hand-written kernels, which have no backward (their wrappers
refuse autograd there), so a training loss takes the plain route, as the
reference's does. ``decode_step`` writes the KV cache IN PLACE at the
write index; the reference returns an updated copy.

The ``vlm`` family is this decoder with a prefix: ``forward`` and
``loss_fn`` take ``prefix_embeds`` (B, P, D), precomputed patch
embeddings (the reference's "ViT" is a stub that supplies them), cast to
the activation type and prepended to the token embeddings; positions run
over all P + S rows, and the loss drops the prefix's P rows.

The losses: ``loss_fn`` (log-softmax of the float32 logits, ``lm.xent``)
and ``vocab_parallel_xent`` (the cross-entropy from the final hidden state
without a gather over the vocabulary), with ``unembed_matrix``. Over a
split training step's tree a layer computes each ``model`` position's
share (``models.layers``, ``models.moe``) and the vocabulary's blocks
meet in ``parallel.model_split``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models.lm import (act_dtype, fill_specs, flatten,
                                   head_logits, layer, padded_vocab,
                                   remat_layer, stacked, unembed, xent)
from repro_torch.parallel import model_split as MS


def _layer_specs(cfg: ModelConfig) -> dict:
    p = {
        "attn_norm": L.init_norm(cfg),
        "attn": L.init_attention(cfg),
        "mlp_norm": L.init_norm(cfg),
    }
    if cfg.moe:
        p["moe"] = MOE.init_moe(cfg)
    else:
        p["mlp"] = L.init_mlp(cfg)
    return p


def param_specs(cfg: ModelConfig) -> dict:
    """The parameter layout: a nested dict of ``layers.Leaf`` (per-layer
    leaves stacked on a leading L axis), as the reference's ``init_lm``
    builds it."""
    specs = {
        "embed": L.init_embedding(cfg, padded_vocab(cfg)),
        "layers": stacked(_layer_specs(cfg), cfg.n_layers),
        "final_norm": L.init_norm(cfg),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = L._dense_init((cfg.d_model, padded_vocab(cfg)),
                                         scale=0.02)
    return specs


def flat_specs(cfg: ModelConfig) -> dict[str, L.Leaf]:
    """``param_specs`` flattened to ``{"a/b/c": Leaf}``."""
    return flatten(param_specs(cfg))


def init_lm(cfg: ModelConfig, *, seed: int = 0,
            device: str | torch.device = "cuda") -> dict:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``, on
    ``device``: matrices normal × the reference's init scale, cast to the
    activation type one layer at a time (no float32 copy of the whole
    model is made), norm scales 1 and biases 0. The values differ from the
    reference's ``init_lm`` (another generator); tests carry the
    reference's across with ``convert.lm_params``."""
    return fill_specs(flat_specs(cfg), cfg, seed=seed, device=device)


def _block(lp: dict, x: torch.Tensor, cfg: ModelConfig, *, positions,
           use_flash: bool, use_moe_kernel: bool, kv_cache=None,
           cache_index=None):
    h, kv = L.attention(
        lp["attn"], L.apply_norm(lp["attn_norm"], x, cfg.norm_eps, cfg.norm),
        cfg, causal=True, positions=positions, kv_cache=kv_cache,
        cache_index=cache_index, use_flash=use_flash)
    x = x + h
    hn = L.apply_norm(lp["mlp_norm"], x, cfg.norm_eps, cfg.norm)
    if cfg.moe:
        x = x + MOE.apply_moe(lp["moe"], hn, cfg, use_kernel=use_moe_kernel)
    else:
        x = x + L.apply_mlp(lp["mlp"], hn, cfg.mlp)
    return x, kv


def _embed(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
           start: int = 0) -> torch.Tensor:
    dtype = act_dtype(cfg)
    x = L.embed(params["embed"], tokens, dtype)
    if cfg.pos == "learned":
        x = x + params["embed"]["pos"][start:start + x.shape[1]].to(dtype)
    return x


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            prefix_embeds: Optional[torch.Tensor] = None,
            use_flash: bool = False, remat: str = "none",
            return_hidden: bool = False, last_only: bool = False,
            use_moe_kernel: bool = False) -> torch.Tensor:
    """Training/eval forward -> logits (B, P + S, V_padded), or with
    ``return_hidden`` the final-normed hidden state (B, P + S, D); P is
    the length of ``prefix_embeds`` (B, P, D), 0 without one.
    ``last_only`` unembeds the last row alone (B, 1, V_padded). The
    default is the plain route (``sdpa`` and einsum expert FFNs), as the
    reference's. remat: none | full | dots, the activation-checkpoint
    policy on each layer (``lm.remat_layer``)."""
    x = _embed(params, tokens, cfg)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]

    def body(lp, x):
        return _block(lp, x, cfg, positions=positions, use_flash=use_flash,
                      use_moe_kernel=use_moe_kernel)[0]

    body = remat_layer(body, remat)
    for i in range(cfg.n_layers):
        x = body(layer(params["layers"], i), x)
    if return_hidden:
        return L.apply_norm(params["final_norm"], x, cfg.norm_eps, cfg.norm)
    return unembed(params, x[:, -1:] if last_only else x, cfg)


def prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            use_flash: bool = False, use_moe_kernel: bool = False):
    """Prefill pass -> (last-position logits (B, 1, V_padded), stacked KV
    caches {"k", "v"}: (L, B, S, KV, hd), ready for decode_step writes at
    index S)."""
    x = _embed(params, tokens, cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    ks, vs = [], []
    for i in range(cfg.n_layers):
        x, kv = _block(layer(params["layers"], i), x, cfg,
                       positions=positions, use_flash=use_flash,
                       use_moe_kernel=use_moe_kernel)
        ks.append(kv["k"])
        vs.append(kv["v"])
    logits = unembed(params, x[:, -1:, :], cfg)
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}


def decode_step(params: dict, token: torch.Tensor, caches: dict,
                index: int, cfg: ModelConfig, *,
                use_moe_kernel: bool = False):
    """One decode step. token: (B, 1) int; caches: {"k", "v"}:
    (L, B, S, KV, hd), written IN PLACE at ``index`` (a Python int, the
    write position). -> (logits (B, 1, V_padded), caches)."""
    x = _embed(params, token, cfg, start=index)
    positions = torch.full((1, 1), index, device=x.device)
    for i in range(cfg.n_layers):
        cache = {"k": caches["k"][i], "v": caches["v"][i]}
        x, _ = _block(layer(params["layers"], i), x, cfg,
                      positions=positions, use_flash=False,
                      use_moe_kernel=use_moe_kernel, kv_cache=cache,
                      cache_index=index)
    return unembed(params, x, cfg), caches


def init_kv_caches(cfg: ModelConfig, batch: int, max_seq: int, *,
                   device: str | torch.device = "cuda") -> dict:
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=act_dtype(cfg), device=dev),
            "v": torch.zeros(shape, dtype=act_dtype(cfg), device=dev)}


def loss_fn(params: dict, tokens: torch.Tensor, labels: torch.Tensor,
            cfg: ModelConfig, *, prefix_embeds=None, use_flash: bool = False,
            remat: str = "dots", use_moe_kernel: bool = False
            ) -> torch.Tensor:
    """Mean next-token cross-entropy over the S token rows (B, S), from
    the float32 log-softmax of the logits; the rows of ``prefix_embeds``
    carry no label."""
    logits = forward(params, tokens, cfg, prefix_embeds=prefix_embeds,
                     use_flash=use_flash, remat=remat,
                     use_moe_kernel=use_moe_kernel)
    if prefix_embeds is not None:
        rows = slice(prefix_embeds.shape[1], None)
        logits = ([b[:, rows] for b in logits] if isinstance(logits, list)
                  else logits[:, rows])
    return xent(logits, labels)


def unembed_matrix(params: dict, cfg: ModelConfig, dtype) -> torch.Tensor:
    """The (D, V_padded) unembedding: the tied table transposed, or
    ``lm_head``."""
    if cfg.tie_embeddings:
        return params["embed"]["table"].to(dtype).T
    return params["lm_head"].to(dtype)


def vocab_parallel_xent(hidden: torch.Tensor, params: dict,
                        labels: torch.Tensor, cfg: ModelConfig
                        ) -> torch.Tensor:
    """Cross-entropy without gathering over the vocabulary axis: the
    reductions (max, sum-exp, the label's logit by a one-hot einsum) run
    over it, and the vocab padding is masked additively, as the
    reference's (whose vocab axis is sharded over ``model``). A head
    split over ``model`` (``model_split.Blocks``) takes each position's
    block of the logits (``lm.head_logits``) and reduces across them
    (``lm.xent``)."""
    head = (params["embed"]["table"] if cfg.tie_embeddings
            else params["lm_head"])
    if isinstance(head, MS.Blocks):
        return xent(MS.shares(head.n, lambda j: head_logits(
            hidden, head.block(j), cfg, j)), labels)
    w = unembed_matrix(params, cfg, hidden.dtype)        # (D, Vp)
    logits = (hidden @ w).float()                        # (B, S, Vp)
    pv, v = logits.shape[-1], cfg.vocab_size
    if pv != v:
        pad = torch.arange(pv, device=logits.device) >= v
        logits = logits + pad.float() * -1e30
    m = torch.amax(logits, dim=-1, keepdim=True)
    lse = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m[..., 0]
    onehot = F.one_hot(labels.long(), pv).float()
    label_logit = torch.einsum("bsv,bsv->bs", logits, onehot)
    return torch.mean(lse - label_logit)

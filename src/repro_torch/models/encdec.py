"""Whisper-style encoder–decoder (arXiv:2212.04356), the ``audio`` family
(port of ``repro.models.encdec``).

The conv frontend is a stub, as in the reference: the inputs are frame
embeddings (B, n_frames, d_model). LayerNorm and GELU MLPs, learned
positions, a bidirectional encoder, and a causal decoder with cross
attention to the encoder's output; the embedding table is tied to the
unembedding.

Parameters are laid out as the reference's (``param_specs``): per-layer
leaves stacked on a leading L axis under ``enc_layers`` and
``dec_layers``, norm scales and biases in float32. A Python loop over
layers takes the place of ``maybe_scan``, and ``lm.remat_layer`` wraps
each layer body of a training forward.

``use_flash`` runs the encoder's attention, the decoder's self-attention
and its cross attention through the flash kernel (on CUDA tensors; its
plain version on CPU tensors); the reference's ``encdec`` has no such
switch and takes ``sdpa``. ``decode_step`` writes the self-attention
cache IN PLACE and attends over the precomputed cross K/V on the plain
route, as the transformer's decode does.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import lm


def _enc_layer_specs(cfg: ModelConfig) -> dict:
    return {
        "attn_norm": L.init_norm(cfg, with_bias=True),
        "attn": L.init_attention(cfg),
        "mlp_norm": L.init_norm(cfg, with_bias=True),
        "mlp": L.init_mlp(cfg),
    }


def _dec_layer_specs(cfg: ModelConfig) -> dict:
    return {
        "attn_norm": L.init_norm(cfg, with_bias=True),
        "attn": L.init_attention(cfg),
        "xattn_norm": L.init_norm(cfg, with_bias=True),
        "xattn": L.init_attention(cfg),
        "mlp_norm": L.init_norm(cfg, with_bias=True),
        "mlp": L.init_mlp(cfg),
    }


def param_specs(cfg: ModelConfig) -> dict:
    """The parameter layout of the reference's ``init_lm``: a nested dict
    of ``layers.Leaf``, per-layer leaves stacked on a leading L axis."""
    enc = cfg.encoder
    return {
        "enc_pos": L._dense_init((enc.n_frames, cfg.d_model), scale=0.02),
        "enc_layers": lm.stacked(_enc_layer_specs(cfg), enc.n_layers),
        "enc_final_norm": L.init_norm(cfg, with_bias=True),
        "embed": L.init_embedding(cfg, lm.padded_vocab(cfg)),
        "dec_layers": lm.stacked(_dec_layer_specs(cfg), cfg.n_layers),
        "final_norm": L.init_norm(cfg, with_bias=True),
    }


def flat_specs(cfg: ModelConfig) -> dict[str, L.Leaf]:
    return lm.flatten(param_specs(cfg))


def init_lm(cfg: ModelConfig, *, seed: int = 0,
            device: str | torch.device = "cuda") -> dict:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``
    (see ``lm.fill_specs``)."""
    return lm.fill_specs(flat_specs(cfg), cfg, seed=seed, device=device)


def _norm(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return L.apply_norm(p, x, cfg.norm_eps, "layernorm")


def encode(params: dict, frames: torch.Tensor, cfg: ModelConfig, *,
           remat: str = "none", use_flash: bool = False) -> torch.Tensor:
    """frames: (B, n_frames, D) stub embeddings -> encoder states."""
    x = frames.to(lm.act_dtype(cfg))
    x = x + params["enc_pos"][: x.shape[1]].to(x.dtype)

    def body(lp, x):
        h, _ = L.attention(lp["attn"], _norm(lp["attn_norm"], x, cfg), cfg,
                           causal=False, use_flash=use_flash)
        x = x + h
        return x + L.apply_mlp(lp["mlp"], _norm(lp["mlp_norm"], x, cfg),
                               cfg.mlp)

    body = lm.remat_layer(body, remat)
    for i in range(cfg.encoder.n_layers):
        x = body(lm.layer(params["enc_layers"], i), x)
    return _norm(params["enc_final_norm"], x, cfg)


def _cross_kv(lp: dict, enc_out: torch.Tensor, cfg: ModelConfig):
    """A decoder layer's cross-attention keys and values over the encoder
    states: each (B, n_frames, KV, hd)."""
    k = L._proj(enc_out, lp["xattn"]["wk"])
    v = L._proj(enc_out, lp["xattn"]["wv"])
    if "bk" in lp["xattn"]:
        k = k + lp["xattn"]["bk"]
        v = v + lp["xattn"]["bv"]
    return k, v


def precompute_cross_kv(params: dict, enc_out: torch.Tensor,
                        cfg: ModelConfig):
    """Every decoder layer's cross K/V once a request: (ks, vs), each
    (L, B, n_frames, KV, hd). A layer's slice is contiguous."""
    kvs = [_cross_kv(lm.layer(params["dec_layers"], i), enc_out, cfg)
           for i in range(cfg.n_layers)]
    return (torch.stack([k for k, _ in kvs]),
            torch.stack([v for _, v in kvs]))


def decode_train(params: dict, tokens: torch.Tensor, enc_out: torch.Tensor,
                 cfg: ModelConfig, *, remat: str = "none",
                 use_flash: bool = False, cross_kv=None) -> torch.Tensor:
    """Teacher-forced decoder pass -> logits (B, S, V_padded).
    ``cross_kv``: ``precompute_cross_kv``'s (ks, vs), or None to project
    each layer's from ``enc_out`` inside the layer, as the reference."""
    dtype = lm.act_dtype(cfg)
    x = L.embed(params["embed"], tokens, dtype)
    x = x + params["embed"]["pos"][: x.shape[1]].to(dtype)

    def body(lp, x):
        h, _ = L.attention(lp["attn"], _norm(lp["attn_norm"], x, cfg), cfg,
                           causal=True, use_flash=use_flash)
        x = x + h
        ck = ((lp["xk"], lp["xv"]) if "xk" in lp
              else _cross_kv(lp, enc_out, cfg))
        h, _ = L.attention(lp["xattn"], _norm(lp["xattn_norm"], x, cfg),
                           cfg, cross_kv=ck, use_flash=use_flash)
        x = x + h
        return x + L.apply_mlp(lp["mlp"], _norm(lp["mlp_norm"], x, cfg),
                               cfg.mlp)

    def layer(i):      # held by no name once its layer has run
        lp = lm.layer(params["dec_layers"], i)
        if cross_kv is None:
            return lp
        return dict(lp, xk=cross_kv[0][i], xv=cross_kv[1][i])

    body = lm.remat_layer(body, remat)
    for i in range(cfg.n_layers):
        x = body(layer(i), x)
    return lm.unembed(params, x, cfg)


def forward(params: dict, tokens: torch.Tensor, frames: torch.Tensor,
            cfg: ModelConfig, *, remat: str = "none",
            use_flash: bool = False) -> torch.Tensor:
    """Encode ``frames``, then the teacher-forced decoder over ``tokens``
    -> logits (B, S, V_padded). remat: none | full | dots, the
    activation-checkpoint policy on each layer of both stacks."""
    enc_out = encode(params, frames, cfg, remat=remat, use_flash=use_flash)
    return decode_train(params, tokens, enc_out, cfg, remat=remat,
                        use_flash=use_flash)


def init_kv_caches(cfg: ModelConfig, batch: int, max_seq: int, *,
                   device: str | torch.device = "cuda") -> dict:
    """Zeros: the self-attention caches "k", "v" (L, B, max_seq, KV, hd)
    and the cross K/V "xk", "xv" (L, B, n_frames, KV, hd)."""
    dev = resolve_device(device)
    dtype = lm.act_dtype(cfg)
    kv = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    xkv = (cfg.n_layers, batch, cfg.encoder.n_frames, cfg.n_kv_heads,
           cfg.hd)
    return {name: torch.zeros(shape, dtype=dtype, device=dev)
            for name, shape in (("k", kv), ("v", kv), ("xk", xkv),
                                ("xv", xkv))}


def decode_step(params: dict, token: torch.Tensor, caches: dict, index: int,
                cfg: ModelConfig):
    """One decoder step at position ``index`` (a Python int). token: (B,
    1). -> (logits (B, 1, V_padded), caches): the self-attention caches
    written IN PLACE at ``index`` (attention over the positions up to it),
    the learned position at ``index``, cross attention over ``caches``'
    "xk"/"xv"."""
    dtype = lm.act_dtype(cfg)
    idx = int(index)
    x = L.embed(params["embed"], token, dtype)
    x = x + params["embed"]["pos"][idx:idx + 1].to(dtype)[None]
    for i in range(cfg.n_layers):
        lp = lm.layer(params["dec_layers"], i)
        h, _ = L.attention(lp["attn"], _norm(lp["attn_norm"], x, cfg), cfg,
                           causal=True, cache_index=idx,
                           kv_cache={"k": caches["k"][i],
                                     "v": caches["v"][i]})
        x = x + h
        h, _ = L.attention(lp["xattn"], _norm(lp["xattn_norm"], x, cfg),
                           cfg, cross_kv=(caches["xk"][i], caches["xv"][i]))
        x = x + h
        x = x + L.apply_mlp(lp["mlp"], _norm(lp["mlp_norm"], x, cfg),
                            cfg.mlp)
    return lm.unembed(params, x, cfg), caches

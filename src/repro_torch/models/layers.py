"""Common layers: norms, RoPE, GQA attention (prefill/decode), MLPs (port
of ``repro.models.layers``).

Plain functions on tensors: ``apply(params, x, ...) -> y``, with parameters
in nested dicts as in the reference. The ``init_*`` functions return the
parameter layout as ``Leaf`` specs (shape, how the reference initialises
the leaf, and the type it is used in); ``transformer.init_lm`` fills them
from a ``torch.Generator`` and ``convert.lm_params`` from a reference
tree.

Matrices are kept in the activation type: the reference keeps float32
params and casts each matrix with ``.astype(x.dtype)`` at use, so storing
it cast gives the same values. Norm scales and biases stay float32, the
type the reference applies them in.

Prefill and cross attention with ``use_flash`` go through
``kernels.flash_attention.ops.flash_attention`` (the CUDA kernel on CUDA
tensors); everything else (decode, ``use_flash=False``) is plain torch.

In a training step over a mesh whose ``model`` axis splits a layer's
heads, d_ff or vocabulary, a leaf arrives as ``model_split.Blocks``:
``attention``, ``apply_mlp`` and ``embed`` compute each position's share
and join the shares there (``parallel.model_split``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.moe_gmm.ref import activation
from repro_torch.parallel import model_split as MS


class Leaf(NamedTuple):
    """One parameter: its shape; its init, normal(0, 1) × ``scale`` or, with
    ``scale`` 0, the constant ``fill``; and whether it is used in float32
    (norm scales and biases) rather than in the activation type."""
    shape: tuple[int, ...]
    scale: float = 0.0
    fill: float = 0.0
    f32: bool = False


# ------------------------------------------------------------------ inits


def _dense_init(shape, scale=None) -> Leaf:
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    return Leaf(tuple(shape), scale=scale)


def init_norm(cfg: ModelConfig, with_bias: Optional[bool] = None) -> dict:
    p = {"scale": Leaf((cfg.d_model,), fill=1.0, f32=True)}
    if with_bias if with_bias is not None else cfg.norm == "layernorm":
        p["bias"] = Leaf((cfg.d_model,), f32=True)
    return p


def apply_norm(p: dict, x: torch.Tensor, eps: float = 1e-5,
               kind: str = "rmsnorm") -> torch.Tensor:
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, unbiased=False, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
    else:
        y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    y = y * p["scale"]
    if "bias" in p:
        y = y + p["bias"]
    return y.to(x.dtype)


# ------------------------------------------------------------------- RoPE


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S). Half-split rotation, in
    float32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                # (hd/2,)
    ang = positions[..., None].float() * freqs             # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                     # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------------- attention


def init_attention(cfg: ModelConfig) -> dict:
    hd = cfg.hd
    p = {
        "wq": _dense_init((cfg.d_model, cfg.n_heads, hd)),
        "wk": _dense_init((cfg.d_model, cfg.n_kv_heads, hd)),
        "wv": _dense_init((cfg.d_model, cfg.n_kv_heads, hd)),
        "wo": _dense_init((cfg.n_heads, hd, cfg.d_model)),
    }
    if cfg.qkv_bias:
        p["bq"] = Leaf((cfg.n_heads, hd))
        p["bk"] = Leaf((cfg.n_kv_heads, hd))
        p["bv"] = Leaf((cfg.n_kv_heads, hd))
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one contiguous matmul."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).view(*x.shape[:-1], h, k)


def _qkv(p: dict, x: torch.Tensor, cfg: ModelConfig):
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return q, k, v


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=2)


def _mask(sq: int, sk: int, *, causal: bool, window: int, q_offset: int,
          device) -> torch.Tensor:
    qpos = torch.arange(sq, device=device) + q_offset
    kpos = torch.arange(sk, device=device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    return mask


def sdpa(q, k, v, *, causal: bool, window: int = 0,
         q_offset: int = 0) -> torch.Tensor:
    """Reference scaled-dot-product attention.
    q: (B,Sq,H,hd), k/v: (B,Sk,H,hd). q_offset: absolute pos of q[0]."""
    hd = q.shape[-1]
    logits = torch.einsum("bqhk,bshk->bhqs", q, k) / math.sqrt(hd)
    mask = _mask(q.shape[1], k.shape[1], causal=causal, window=window,
                 q_offset=q_offset, device=q.device)
    logits = torch.where(mask[None, None], logits.float(), -1e30)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshk->bqhk", w, v)


def attention(
    p: dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    causal: bool = True,
    positions: Optional[torch.Tensor] = None,
    kv_cache: Optional[dict] = None,
    cache_index: Optional[int] = None,
    cross_kv: Optional[tuple] = None,
    use_flash: bool = False,
):
    """GQA attention for prefill (kv_cache None), decode, or cross
    attention (``cross_kv``).

    prefill: returns (out, {"k", "v"}) with the layer's new (B,S,KV,hd)
    keys and values. ``use_flash`` runs the flash kernel (on CUDA tensors;
    its plain version on CPU tensors), else ``sdpa``.

    decode: x is (B,1,D); kv_cache = {"k": (B,Smax,KV,hd), "v": ...} is
    written IN PLACE at ``cache_index`` (a Python int) and attention runs
    over the whole cache with a length mask (and the sliding window).
    Returns (out, kv_cache), the same cache tensors.

    cross attention: ``cross_kv`` = (k, v), each (B,Sk,KV,hd), the other
    sequence's keys and values. q is projected (with its bias, no rope)
    and attends to every key, without a causal mask or window, through
    the flash kernel under ``use_flash``. Returns (out, None).

    Query heads split over ``model`` (``model_split.Blocks``, training's
    split step; prefill and cross shapes): position j attends with its
    query heads and the KV heads they read, by global head index where
    the KV heads are not split, and the partial outputs of ``wo`` are
    summed across positions. Returns (out, None). Head counts come from
    the leaves' shapes.
    """
    n = MS.positions(p["wq"])
    if n > 1:
        kv_split = isinstance(p["wk"], MS.Blocks) and cross_kv is None

        def share(j, p, x, cross_kv):
            q = MS.at(p, j)
            hq = q["wq"].shape[1]
            n_kv = (cross_kv[0].shape[2] if cross_kv is not None
                    else q["wk"].shape[1] * (n if kv_split else 1))
            kv_heads = None if kv_split else (
                (j * hq + torch.arange(hq, device=x.device))
                // (hq * n // n_kv))
            return _attention(q, x, cfg, causal=causal, positions=positions,
                              cross_kv=cross_kv, use_flash=use_flash,
                              kv_heads=kv_heads)[0]

        return MS.psum(MS.shares(n, share, p, x, cross_kv)), None
    return _attention(p, x, cfg, causal=causal, positions=positions,
                      kv_cache=kv_cache, cache_index=cache_index,
                      cross_kv=cross_kv, use_flash=use_flash)


def _expand_kv(k: torch.Tensor, n_heads: int, kv_heads) -> torch.Tensor:
    """k's KV heads for each of ``n_heads`` query heads: repeated in
    groups, or the heads ``kv_heads`` names (global indices)."""
    if kv_heads is not None:
        return k.index_select(2, kv_heads)
    return repeat_kv(k, n_heads // k.shape[2])


def _attention(p, x, cfg, *, causal, positions, kv_cache=None,
               cache_index=None, cross_kv=None, use_flash=False,
               kv_heads=None):
    B, S, _ = x.shape
    wo = p["wo"].reshape(-1, p["wo"].shape[-1])             # (H*hd, D)
    if cross_kv is not None:
        q = _proj(x, p["wq"])
        if "bq" in p:
            q = q + p["bq"]
        kf, vf = (_expand_kv(t, q.shape[2], kv_heads) for t in cross_kv)
        if use_flash:
            out = flash_ops.flash_attention(q, kf, vf, causal=False,
                                            window=0)
        else:
            out = sdpa(q, kf, vf, causal=False)
        return out.reshape(B, S, -1) @ wo, None

    q, k, v = _qkv(p, x, cfg)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    if cfg.pos == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    if kv_cache is None:
        kf = _expand_kv(k, q.shape[2], kv_heads)
        vf = _expand_kv(v, q.shape[2], kv_heads)
        if use_flash:
            out = flash_ops.flash_attention(q, kf, vf, causal=causal,
                                            window=cfg.sliding_window)
        else:
            out = sdpa(q, kf, vf, causal=causal, window=cfg.sliding_window)
        return out.reshape(B, S, -1) @ wo, {"k": k, "v": v}

    # ---- decode: write the cache in place, attend over it
    idx = int(cache_index)
    ck, cv = kv_cache["k"], kv_cache["v"]
    ck[:, idx:idx + S] = k
    cv[:, idx:idx + S] = v
    Sk = ck.shape[1]
    kf = _expand_kv(ck, q.shape[2], kv_heads)
    vf = _expand_kv(cv, q.shape[2], kv_heads)
    hd = q.shape[-1]
    logits = torch.einsum("bqhk,bshk->bhqs", q, kf) / math.sqrt(hd)
    kpos = torch.arange(Sk, device=x.device)
    valid = kpos <= idx   # positions written so far (incl. current)
    if cfg.sliding_window:
        valid &= kpos > idx - cfg.sliding_window
    logits = torch.where(valid, logits.float(), -1e30)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhqs,bshk->bqhk", w, vf)
    return out.reshape(B, S, -1) @ wo, kv_cache


# ------------------------------------------------------------------- MLPs


def init_mlp(cfg: ModelConfig, d_ff: Optional[int] = None) -> dict:
    d_ff = d_ff or cfg.d_ff
    if cfg.mlp in ("swiglu", "geglu"):
        return {
            "w_gate": _dense_init((cfg.d_model, d_ff)),
            "w_up": _dense_init((cfg.d_model, d_ff)),
            "w_down": _dense_init((d_ff, cfg.d_model)),
        }
    return {
        "w_up": _dense_init((cfg.d_model, d_ff)),
        "b_up": Leaf((d_ff,)),
        "w_down": _dense_init((d_ff, cfg.d_model)),
        "b_down": Leaf((cfg.d_model,)),
    }


def apply_mlp(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    """The MLP. Its d_ff columns split over ``model``
    (``model_split.Blocks``): each position's partial output of
    ``w_down`` from its columns (``b_up`` with them), summed across
    positions, ``b_down`` added once after the sum."""
    n = MS.positions(p["w_up"])
    if n > 1:
        y = MS.psum(MS.shares(n, lambda j, p, x: _mlp(MS.at(p, j), x, kind),
                              p, x))
    else:
        y = _mlp(p, x, kind)
    return y + p["b_down"] if "b_down" in p else y


def _mlp(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind in ("swiglu", "geglu"):
        g = activation(kind)(x @ p["w_gate"])
        u = x @ p["w_up"]
        return (g * u) @ p["w_down"]
    h = F.gelu(x @ p["w_up"] + p["b_up"], approximate="tanh")
    return h @ p["w_down"]


# ------------------------------------------------------------- embeddings


def init_embedding(cfg: ModelConfig, padded_vocab: int) -> dict:
    p = {"table": _dense_init((padded_vocab, cfg.d_model), scale=0.02)}
    if cfg.pos == "learned":
        p["pos"] = _dense_init((cfg.max_seq, cfg.d_model), scale=0.02)
    return p


def embed(p: dict, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Rows ``tokens`` of the table; a table split over its vocabulary
    (``model_split.Blocks``) by the vocab-parallel lookup."""
    if isinstance(p["table"], MS.Blocks):
        return MS.vocab_lookup(p["table"], tokens).to(dtype)
    return p["table"][tokens].to(dtype)

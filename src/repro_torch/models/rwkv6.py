"""RWKV-6 "Finch" (arXiv:2404.05892), the ``ssm`` family: attention-free
LM with token shift and data-dependent per-channel decay (port of
``repro.models.rwkv6``).

Time-mix recurrence per head (head_dim K = V dim):

    S_t = diag(w_t) · S_{t-1} + k_t^T v_t          (S: K×V state)
    o_t = r_t · (S_{t-1} + diag(u) k_t^T v_t)

with w_t = exp(-exp(decay_t)) data-dependent (LoRA on the shifted input)
and u the "bonus" for the current token. A block of more than one token
is evaluated chunk by chunk (``wkv_chunked``); with ``use_kernel`` that
goes through ``kernels.rwkv6_scan.ops.wkv6``, the CUDA kernel on CUDA
tensors. A single token takes the one-step recurrence (``wkv_step``).

Parameters are laid out as the reference's (``param_specs``), per-layer
leaves stacked on a leading L axis. The blocks' norms are RMSNorm (with
the bias that a ``layernorm`` config gives them), as the reference's
``apply_norm`` default; only the final norm follows ``cfg.norm``.
``decode_step`` and ``prefill`` write the decode state IN PLACE; the
reference returns an updated copy.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
from repro_torch.kernels.rwkv6_scan import ref as wkv_ref
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.parallel import model_split as MS


def n_heads(cfg: ModelConfig) -> int:
    return cfg.d_model // cfg.rwkv.head_dim


def init_time_mix(cfg: ModelConfig) -> dict:
    D, r = cfg.d_model, cfg.rwkv.decay_lora
    H, K = n_heads(cfg), cfg.rwkv.head_dim
    half = L.Leaf((D,), fill=0.5, f32=True)
    return {
        # token-shift interpolation factors (per channel, per projection)
        "mu_r": half, "mu_k": half, "mu_v": half, "mu_w": half, "mu_g": half,
        "wr": L._dense_init((D, D)),
        "wk": L._dense_init((D, D)),
        "wv": L._dense_init((D, D)),
        "wg": L._dense_init((D, D)),
        "wo": L._dense_init((D, D)),
        # data-dependent decay: LoRA  w = base + tanh(x A) B, used in f32
        "decay_base": L.Leaf((D,), fill=-6.0, f32=True),
        "decay_A": L._dense_init((D, r))._replace(f32=True),
        "decay_B": L._dense_init((r, D), scale=0.01)._replace(f32=True),
        "bonus_u": L.Leaf((H, K), f32=True),
        "ln_x": L.Leaf((D,), fill=1.0, f32=True),  # group-norm scale
    }


def init_channel_mix(cfg: ModelConfig) -> dict:
    D, Fd = cfg.d_model, cfg.d_ff
    return {
        "mu_k": L.Leaf((D,), fill=0.5, f32=True),
        "w_in": L._dense_init((D, Fd)),
        "w_out": L._dense_init((Fd, D)),
    }


def _layer_specs(cfg: ModelConfig) -> dict:
    return {
        "tm_norm": L.init_norm(cfg),
        "time_mix": init_time_mix(cfg),
        "cm_norm": L.init_norm(cfg),
        "channel_mix": init_channel_mix(cfg),
    }


def param_specs(cfg: ModelConfig) -> dict:
    """The parameter layout of the reference's ``init_lm``: a nested dict
    of ``layers.Leaf``, per-layer leaves stacked on a leading L axis."""
    pv = lm.padded_vocab(cfg)
    return {
        "embed": L.init_embedding(cfg, pv),
        "layers": lm.stacked(_layer_specs(cfg), cfg.n_layers),
        "final_norm": L.init_norm(cfg),
        "lm_head": L._dense_init((cfg.d_model, pv), scale=0.02),
    }


def flat_specs(cfg: ModelConfig) -> dict[str, L.Leaf]:
    return lm.flatten(param_specs(cfg))


def init_lm(cfg: ModelConfig, *, seed: int = 0,
            device: str | torch.device = "cuda") -> dict:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``
    (see ``lm.fill_specs``)."""
    return lm.fill_specs(flat_specs(cfg), cfg, seed=seed, device=device)


# ------------------------------------------------------------ time mix


def _token_shift(x: torch.Tensor, prev: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """x: (B, S, D) -> x shifted right one step; prev: (B, 1, D) carry."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


def _mix(x, xs, mu):
    return x + (xs - x) * mu


def _project(p, x, xs, dtype):
    r = _mix(x, xs, p["mu_r"].to(dtype)) @ p["wr"].to(dtype)
    k = _mix(x, xs, p["mu_k"].to(dtype)) @ p["wk"].to(dtype)
    v = _mix(x, xs, p["mu_v"].to(dtype)) @ p["wv"].to(dtype)
    g = _mix(x, xs, p["mu_g"].to(dtype)) @ p["wg"].to(dtype)
    return r, k, v, g, _decay(p, x, xs, dtype)


def _decay(p, x, xs, dtype):
    xw = _mix(x, xs, p["mu_w"].to(dtype))
    decay = (p["decay_base"].float()
             + torch.tanh(xw.float() @ p["decay_A"].float())
             @ p["decay_B"].float())
    return torch.exp(-torch.exp(decay))   # (B, S, D) in (0, 1), float32


def wkv_chunked(r, k, v, w, u, chunk: int, state0=None,
                use_kernel: bool = False):
    """Chunked WKV evaluation. r, k, v, w: (B, S, H, K); u: (H, K).
    Returns (out (B, S, H, K), final state (B, H, K, K) float32).
    ``use_kernel`` goes through ``ops.wkv6`` (the CUDA kernel on CUDA
    tensors); otherwise, as the reference, the plain chunked version."""
    if use_kernel:
        return wkv_ops.wkv6(r, k, v, w, u, chunk=chunk, state0=state0)
    return wkv_ref.wkv_chunked_ref(r, k, v, w, u, chunk=chunk,
                                   state0=state0)


def wkv_step(r, k, v, w, u, state):
    """Single decode step. r, k, v, w: (B, H, K); state: (B, H, K, K) ->
    (out, state')."""
    rf, kf, vf = (a.float() for a in (r, k, v))
    kv = torch.einsum("bhk,bhv->bhkv", kf, vf)
    out = torch.einsum("bhk,bhkv->bhv", rf,
                       state + u.float()[None, :, :, None] * kv)
    new_state = w.float()[..., None] * state + kv
    return out.to(r.dtype), new_state


def time_mix(p, x, cfg: ModelConfig, *, shift_prev=None, state0=None,
             use_kernel: bool = False):
    """Full RWKV6 time-mix block. x: (B, S, D), already normed. Returns
    (y, (shift_carry, state)); the shift carry is x's last position.
    Heads split over ``model`` (``model_split.Blocks``: ``bonus_u`` and
    the projections' output columns): the decay LoRA runs whole once,
    position j mixes its heads' r, k, v, g, its columns of the decay and
    of ``ln_x`` (per head, so local), and the partial outputs of ``wo``
    are summed across positions; the state is the positions' heads in
    order. Projections split on columns that do not line up with heads
    are taken whole."""
    xs = _token_shift(x, shift_prev)
    n = MS.positions(p["wr"])
    if n > 1 and isinstance(p["bonus_u"], MS.Blocks):
        mixed = {name: _mix(x, xs, p["mu_" + name].to(x.dtype))
                 for name in "rkvg"}
        w = _decay(p, x, xs, x.dtype)

        def share(j):
            q = MS.at({k: p[k] for k in ("wr", "wk", "wv", "wg", "wo",
                                         "bonus_u")}, j)
            r, k, v, g = (mixed[c] @ q["w" + c].to(x.dtype)
                          for c in "rkvg")
            cols = slice(j * r.shape[-1], (j + 1) * r.shape[-1])
            h = q["bonus_u"].shape[0]
            return _heads_out(q, x, cfg, (r, k, v, g, w[..., cols]),
                              p["ln_x"][cols], None if state0 is None
                              else state0[:, j * h:(j + 1) * h], use_kernel)

        ys, states = zip(*MS.shares(n, share))
        return MS.psum(list(ys)), (x[:, -1:], torch.cat(states, 1))
    if n > 1:
        p = MS.whole(p)
    y, state = _heads_out(p, x, cfg, _project(p, x, xs, x.dtype), p["ln_x"],
                          state0, use_kernel)
    return y, (x[:, -1:], state)


def _heads_out(p, x, cfg, rkvgw, ln_x, state0, use_kernel):
    """The WKV scan over the heads of ``p["bonus_u"]`` (H, K), the
    per-head group norm (``ln_x``), the gate and ``wo`` -> (y, state)."""
    B, S, _ = x.shape
    H, K = p["bonus_u"].shape
    r, k, v, g, w = rkvgw
    rh, kh, vh, wh = (a.reshape(B, S, H, K) for a in (r, k, v, w))
    if S == 1 and state0 is not None:
        o, state = wkv_step(rh[:, 0], kh[:, 0], vh[:, 0], wh[:, 0],
                            p["bonus_u"], state0)
        o = o[:, None]
    else:
        o, state = wkv_chunked(rh, kh, vh, wh, p["bonus_u"],
                               chunk=min(cfg.rwkv.chunk, S), state0=state0,
                               use_kernel=use_kernel)
    # per-head group norm (ln_x)
    o32 = o.float()
    o32 = o32 * torch.rsqrt((o32 * o32).mean(-1, keepdim=True) + 1e-5)
    o = (o32.reshape(B, S, H * K) * ln_x).to(x.dtype)
    return (o * F.silu(g)) @ p["wo"].to(x.dtype), state


def channel_mix(p, x, *, shift_prev=None):
    """The channel mix. Its d_ff columns split over ``model``
    (``model_split.Blocks``): each position's partial output of
    ``w_out``, summed across positions."""
    xs = _token_shift(x, shift_prev)
    xk = _mix(x, xs, p["mu_k"].to(x.dtype))

    def out(q):
        h = torch.square(torch.relu(xk @ q["w_in"].to(x.dtype)))
        return h @ q["w_out"].to(x.dtype)

    n = MS.positions(p["w_in"])
    if n > 1:
        return MS.psum(MS.shares(n, lambda j: out(MS.at(p, j)))), x[:, -1:]
    return out(p), x[:, -1:]


# ----------------------------------------------------------------- full LM


def _block(lp, x, cfg: ModelConfig, *, use_kernel: bool, tm_shift=None,
           cm_shift=None, state0=None):
    """One layer -> (x, (tm_shift, cm_shift, wkv state))."""
    h, (tm_new, wkv_new) = time_mix(
        lp["time_mix"], L.apply_norm(lp["tm_norm"], x, cfg.norm_eps), cfg,
        shift_prev=tm_shift, state0=state0, use_kernel=use_kernel)
    x = x + h
    h, cm_new = channel_mix(
        lp["channel_mix"], L.apply_norm(lp["cm_norm"], x, cfg.norm_eps),
        shift_prev=cm_shift)
    return x + h, (tm_new, cm_new, wkv_new)


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            remat: str = "none", use_kernel: bool = False) -> torch.Tensor:
    """Teacher-forced forward from a zero state -> logits (B, S, V). The
    default is the plain chunked scan, as the reference's; ``use_kernel``
    runs ``ops.wkv6`` (the CUDA kernel on CUDA tensors, which has no
    backward). remat: none | full | dots (``lm.remat_layer``)."""
    x = L.embed(params["embed"], tokens, lm.act_dtype(cfg))

    def body(lp, x):
        return _block(lp, x, cfg, use_kernel=use_kernel)[0]

    body = lm.remat_layer(body, remat)
    for i in range(cfg.n_layers):
        x = body(lm.layer(params["layers"], i), x)
    return lm.unembed(params, x, cfg)


def init_decode_state(cfg: ModelConfig, batch: int, *,
                      device: str | torch.device = "cuda") -> dict:
    dev = resolve_device(device)
    H, K = n_heads(cfg), cfg.rwkv.head_dim
    shift, dtype = (cfg.n_layers, batch, 1, cfg.d_model), lm.act_dtype(cfg)
    return {
        "tm_shift": torch.zeros(shift, dtype=dtype, device=dev),
        "cm_shift": torch.zeros(shift, dtype=dtype, device=dev),
        "wkv": torch.zeros((cfg.n_layers, batch, H, K, K),
                           dtype=torch.float32, device=dev),
    }


def _run(params: dict, tokens: torch.Tensor, state: dict, cfg: ModelConfig,
         use_kernel: bool) -> torch.Tensor:
    """Run a block of tokens (B, S) through every layer from ``state``,
    which is updated IN PLACE; returns the last layer's output x."""
    x = L.embed(params["embed"], tokens, lm.act_dtype(cfg))
    for i in range(cfg.n_layers):
        x, (tm, cm, wkv) = _block(
            lm.layer(params["layers"], i), x, cfg, use_kernel=use_kernel,
            tm_shift=state["tm_shift"][i], cm_shift=state["cm_shift"][i],
            state0=state["wkv"][i])
        state["tm_shift"][i] = tm
        state["cm_shift"][i] = cm
        state["wkv"][i] = wkv
    return x


def decode_step(params: dict, token: torch.Tensor, state: dict,
                cfg: ModelConfig, *, use_kernel: bool = False):
    """O(1)-in-sequence decode. token: (B, S), usually S = 1 (the one-step
    recurrence); a longer block is evaluated chunk by chunk from the
    carried state. -> (logits (B, S, V), state), the state written IN
    PLACE."""
    x = _run(params, token, state, cfg, use_kernel)
    return lm.unembed(params, x, cfg), state


def prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            use_kernel: bool = False):
    """Prefill pass -> (last-position logits (B, 1, V), decode state).

    Runs the prompt as ``decode_step`` would from ``init_decode_state``:
    first the longest prefix whose length is a multiple of
    ``cfg.rwkv.chunk`` as one block, then the remaining ``S mod chunk``
    tokens as a second block carrying the shift and WKV state (one token
    takes the one-step recurrence). Only the last position is unembedded."""
    B, S = tokens.shape
    state = init_decode_state(cfg, B, device=tokens.device)
    head = S - S % cfg.rwkv.chunk
    x = None
    for a, b in ((0, head), (head, S)):
        if b > a:
            x = _run(params, tokens[:, a:b], state, cfg, use_kernel)
    return lm.unembed(params, x[:, -1:], cfg), state

"""Zamba2 (arXiv:2411.15242), the ``hybrid`` family: a Mamba2 (SSD)
backbone and one SHARED attention+MLP block, invoked every ``attn_every``
layers with the same weights each time (port of ``repro.models.zamba2``).

Mamba2 SSD block, per head (x: (P,), B, C: (N,), dt a scalar):

    in_proj -> [z (gate), x, B, C, dt]; a short depthwise conv on x
    h_t = exp(-A·dt_t) h_{t-1} + dt_t · (B_t ⊗ x_t)
    y_t = C_t · h_t + D ⊙ x_t;  y ⊙ silu(z) after an RMS norm; out_proj

A block of more than one token is evaluated chunk by chunk
(``ssd_chunked``: within a chunk the pairwise decays exp(cum_t − cum_s),
across chunks the carried (B, H, N, P) float32 state); one token takes
the one-step recurrence (``ssd_step``). The scan is plain PyTorch, as the
reference's is plain JAX. The shared block's attention takes the flash
kernel under ``use_flash`` (``layers.attention``).

Parameters are laid out as the reference's (``param_specs``), per-layer
leaves stacked on a leading L axis and the shared block's leaves at the
top (``shared_*``). ``decode_step`` and ``prefill`` write the decode state
IN PLACE; the reference returns an updated copy. The shared attention's
KV caches are rings of ``cache_len = min(sliding_window, max_seq)``
slots, one a shared-block invocation; a token at position ``index`` is
written at slot ``index mod cache_len`` and roped at that slot, and the
decode mask shows the slots up to it, as the reference's do (see
``decode_step``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.parallel import model_split as MS


def dims(cfg: ModelConfig):
    """(d_inner, SSD heads H, head size P, state size N)."""
    d_inner = cfg.ssm.expand * cfg.d_model
    H = d_inner // cfg.ssm.head_dim
    return d_inner, H, cfg.ssm.head_dim, cfg.ssm.state_dim


def n_attn(cfg: ModelConfig) -> int:
    """Shared-block invocations in a forward pass (one KV cache each)."""
    return cfg.n_layers // cfg.attn_every if cfg.attn_every else 0


def _is_attn(cfg: ModelConfig, i: int) -> bool:
    """Whether layer ``i`` is followed by the shared block."""
    return bool(cfg.attn_every) and i % cfg.attn_every == cfg.attn_every - 1


def init_mamba2(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    d_inner, H, P, N = dims(cfg)
    return {
        "w_in_z": L._dense_init((D, d_inner)),
        "w_in_x": L._dense_init((D, d_inner)),
        "w_in_B": L._dense_init((D, H, N)),
        "w_in_C": L._dense_init((D, H, N)),
        "w_in_dt": L._dense_init((D, H)),
        "dt_bias": L.Leaf((H,), f32=True),
        # log(linspace(1, 16, H)): set by ``init_lm``, not a constant
        "A_log": L.Leaf((H,), f32=True),
        "D_skip": L.Leaf((H, P), fill=1.0, f32=True),
        "conv_x": L._dense_init((cfg.ssm.conv_width, d_inner), scale=0.5),
        "out_norm": L.Leaf((d_inner,), fill=1.0, f32=True),
        "w_out": L._dense_init((d_inner, D)),
    }


def param_specs(cfg: ModelConfig) -> dict:
    """The parameter layout of the reference's ``init_lm``: a nested dict
    of ``layers.Leaf``, per-layer leaves stacked on a leading L axis, the
    shared block's once, an untied ``lm_head``."""
    pv = lm.padded_vocab(cfg)
    return {
        "embed": L.init_embedding(cfg, pv),
        "layers": lm.stacked({"norm": L.init_norm(cfg),
                              "mamba": init_mamba2(cfg)}, cfg.n_layers),
        "shared_norm": L.init_norm(cfg),
        "shared_attn": L.init_attention(cfg),
        "shared_mlp_norm": L.init_norm(cfg),
        "shared_mlp": L.init_mlp(cfg),
        "final_norm": L.init_norm(cfg),
        "lm_head": L._dense_init((cfg.d_model, pv), scale=0.02),
    }


def flat_specs(cfg: ModelConfig) -> dict[str, L.Leaf]:
    return lm.flatten(param_specs(cfg))


def init_lm(cfg: ModelConfig, *, seed: int = 0,
            device: str | torch.device = "cuda") -> dict:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``
    (see ``lm.fill_specs``); every layer's ``A_log`` is log(linspace(1,
    16, H)), as the reference's."""
    params = lm.fill_specs(flat_specs(cfg), cfg, seed=seed, device=device)
    a_log = params["layers"]["mamba"]["A_log"]
    a_log.copy_(torch.log(torch.linspace(1.0, 16.0, a_log.shape[-1],
                                         device=a_log.device)))
    return params


# ------------------------------------------------------------- Mamba2


def _short_conv(x: torch.Tensor, w: torch.Tensor,
                carry: torch.Tensor | None = None):
    """Depthwise causal conv. x: (B, S, C), w: (W, C), carry: (B, W-1, C),
    the last W-1 inputs before x. Returns (silu(conv), new carry)."""
    W = w.shape[0]
    if carry is None:
        carry = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    xp = torch.cat([carry, x], dim=1)
    S = x.shape[1]
    w = w.to(x.dtype)
    out = xp[:, 0:S] * w[0]
    for i in range(1, W):
        out = out + xp[:, i:i + S] * w[i]
    return F.silu(out), xp[:, -(W - 1):]


def ssd_chunked(xh, Bh, Ch, dt, A, chunk: int, state0=None):
    """Chunked SSD scan. xh: (B, S, H, P); Bh, Ch: (B, S, H, N); dt: (B, S,
    H); A: (H,), the positive decay rate; S a multiple of ``chunk``.
    Returns (y (B, S, H, P) in xh's type, final state (B, H, N, P)
    float32).

    Within a chunk, position t sees s ≤ t through the PAIRWISE decay
    exp(cum_t − cum_s), whose exponent is ≤ 0 inside the mask (the
    factored exp(cum_t)·exp(−cum_s) overflows under strong decay); the
    carried state enters each position decayed by exp(cum_t). The terms
    of every chunk are computed at once; only the state's recurrence over
    the chunks is a loop."""
    Bsz, S, H, P = xh.shape
    N = Bh.shape[-1]
    n, c = S // chunk, chunk
    xf = xh.float().reshape(Bsz, n, c, H, P)
    Bf = Bh.float().reshape(Bsz, n, c, H, N)
    Cf = Ch.float().reshape(Bsz, n, c, H, N)
    dtf = dt.float().reshape(Bsz, n, c, H)
    logw = -A * dtf                                  # (B, n, c, H)
    cum = torch.cumsum(logw, dim=2)
    # intra-chunk: exp(cum_t − cum_s) for s ≤ t (inclusive mask)
    dec = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B, n, t, s, H)
    mask = torch.ones((c, c), dtype=torch.bool, device=xh.device).tril()
    dec = dec.masked_fill(~mask[:, :, None], float("-inf"))
    att = torch.einsum("bgthn,bgshn->bghts", Cf, Bf) * torch.exp(
        dec.permute(0, 1, 4, 2, 3))
    xdt = xf * dtf[..., None]
    y_intra = torch.einsum("bghts,bgshp->bgthp", att, xdt)
    # each chunk's contribution to the state, decayed to the chunk's end
    cum_end = cum[:, :, -1:, :]
    B_dec = Bf * torch.exp(cum_end - cum)[..., None]      # exponent ≤ 0
    upd = torch.einsum("bgshn,bgshp->bghnp", B_dec, xdt)
    decay = torch.exp(cum_end[:, :, 0])                   # (B, n, H)
    state = (xh.new_zeros((Bsz, H, N, P), dtype=torch.float32)
             if state0 is None else state0.float())
    entering = []
    for g in range(n):
        entering.append(state)
        state = decay[:, g, :, None, None] * state + upd[:, g]
    # inter-chunk: the state entering the chunk, decayed by Π_{u≤t} w_u
    C_dec = Cf * torch.exp(cum)[..., None]
    y_inter = torch.einsum("bgthn,bghnp->bgthp", C_dec,
                           torch.stack(entering, dim=1))
    y = (y_inter + y_intra).reshape(Bsz, S, H, P)
    return y.to(xh.dtype), state


def ssd_step(xh, Bh, Ch, dt, A, state):
    """One decode step. xh: (B, H, P), Bh, Ch: (B, H, N), dt: (B, H),
    state: (B, H, N, P) float32 -> (y, state')."""
    xf, Bf, Cf = (a.float() for a in (xh, Bh, Ch))
    dtf = dt.float()
    decay = torch.exp(-A[None] * dtf)                      # (B, H)
    upd = torch.einsum("bhn,bhp->bhnp", Bf, xf * dtf[..., None])
    state = decay[..., None, None] * state + upd
    y = torch.einsum("bhn,bhnp->bhp", Cf, state)
    return y.to(xh.dtype), state


def mamba2_block(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                 conv_carry=None, ssm_state=None):
    """x: (B, S, D), already normed -> (y, (conv carry, SSD state)). One
    token with a state takes ``ssd_step``; a block ``ssd_chunked`` in
    chunks of ``min(cfg.ssm.chunk, S)``. The sizes come from the leaves'
    shapes. d_inner and the heads split over ``model``
    (``model_split.Blocks``): position j runs its channels and heads up
    to the out-norm; the out-norm's RMS over the whole d_inner takes the
    positions' sums of squares summed across them; then each position
    normalises and gates its channels, and the partial outputs of
    ``w_out`` are summed. Carries and states are the positions' channels
    and heads in order. Channels split without their heads are taken
    whole."""
    n = MS.positions(p["w_in_x"])
    if n > 1 and isinstance(p["A_log"], MS.Blocks):
        inner = {k: v for k, v in p.items() if k not in ("out_norm", "w_out")}

        def scan(j, inner, x, conv_carry, ssm_state):
            q = MS.at(inner, j)
            h, c = q["A_log"].shape[0], q["conv_x"].shape[1]
            return _inner(q, x, cfg,
                          None if conv_carry is None
                          else conv_carry[..., j * c:(j + 1) * c],
                          None if ssm_state is None
                          else ssm_state[:, j * h:(j + 1) * h])

        ys, zs, convs, states = zip(*MS.shares(n, scan, inner, x,
                                               conv_carry, ssm_state))
        yfs = MS.each(ys, lambda y: y.float())
        # each position's sum of squares in float64 (a float32 square is
        # exact there), summed in position order: the whole d_inner's sum
        # rounds once, to float32, whatever the split. The unsplit path
        # below takes its mean in float32, so the two round differently:
        # float32 partials would round twice, and put zamba2's (2, 2)
        # step at 1.4156e-7 from the unsplit one, 1% over PARAM_ATOL in
        # tests/test_torch_train_model_split.py (1.27e-7 with these)
        ss = MS.psum(MS.shares(n, lambda j: torch.square(
            yfs[j].double()).sum(-1, keepdim=True))).float()
        rms = torch.rsqrt(ss / (MS.own(yfs).shape[-1] * n) + 1e-5)
        outer = {k: p[k] for k in ("out_norm", "w_out")}
        y = MS.psum(MS.shares(n, lambda j, outer, rms: _gate_out(
            MS.at(outer, j), yfs[j] * rms, zs[j], x.dtype), outer, rms))
        return y, (MS.cat(convs, -1), MS.cat(states, 1))
    if n > 1:
        p = MS.whole(p)
    y, z, new_conv, state = _inner(p, x, cfg, conv_carry, ssm_state)
    # RMS out-norm, then the gate
    yf = y.float()
    yf = yf * torch.rsqrt((yf * yf).mean(-1, keepdim=True) + 1e-5)
    return _gate_out(p, yf, z, x.dtype), (new_conv, state)


def _inner(p: dict, x: torch.Tensor, cfg: ModelConfig, conv_carry,
           ssm_state):
    """The block up to its out-norm, over the channels and heads of
    ``p`` -> (y (B, S, d_inner), the gate's input z, conv carry, SSD
    state)."""
    B, S, _ = x.shape
    H, P = p["D_skip"].shape
    dtype = x.dtype
    z = x @ p["w_in_z"].to(dtype)
    xi = x @ p["w_in_x"].to(dtype)
    xi, new_conv = _short_conv(xi, p["conv_x"], conv_carry)
    Bh = L._proj(x, p["w_in_B"].to(dtype))
    Ch = L._proj(x, p["w_in_C"].to(dtype))
    dt = F.softplus((x @ p["w_in_dt"].to(dtype)).float() + p["dt_bias"])
    A = torch.exp(p["A_log"])
    xh = xi.reshape(B, S, H, P)
    if S == 1 and ssm_state is not None:
        y, state = ssd_step(xh[:, 0], Bh[:, 0], Ch[:, 0], dt[:, 0], A,
                            ssm_state)
        y = y[:, None]
    else:
        y, state = ssd_chunked(xh, Bh, Ch, dt, A, chunk=min(cfg.ssm.chunk, S),
                               state0=ssm_state)
    y = y + xh * p["D_skip"].to(dtype)
    return y.reshape(B, S, H * P), z, new_conv, state


def _gate_out(p: dict, yn: torch.Tensor, z: torch.Tensor, dtype
              ) -> torch.Tensor:
    """The normalised ``yn`` (float32) scaled by ``out_norm``, gated by
    silu(z), through ``w_out``."""
    y = (yn * p["out_norm"]).to(dtype) * F.silu(z)
    return y @ p["w_out"].to(dtype)


# ---------------------------------------------------------------- model


def _shared_block(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                  kv_cache=None, cache_index=None, use_flash: bool = False):
    """The shared attention+MLP block. Prefill (``kv_cache`` None) ->
    (x, {"k", "v"} of the block); decode -> (x, the cache written in place
    at slot ``cache_index``, the token roped at that slot)."""
    positions = (None if cache_index is None else
                 torch.full((1, 1), int(cache_index), device=x.device))
    h, kv = L.attention(
        params["shared_attn"],
        L.apply_norm(params["shared_norm"], x, cfg.norm_eps), cfg,
        causal=True, positions=positions, kv_cache=kv_cache,
        cache_index=cache_index, use_flash=use_flash)
    x = x + h
    x = x + L.apply_mlp(params["shared_mlp"],
                        L.apply_norm(params["shared_mlp_norm"], x,
                                     cfg.norm_eps), cfg.mlp)
    return x, kv


def _mamba_layer(lp: dict, x: torch.Tensor, cfg: ModelConfig, **state):
    h, carry = mamba2_block(lp["mamba"],
                            L.apply_norm(lp["norm"], x, cfg.norm_eps), cfg,
                            **state)
    return x + h, carry


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            remat: str = "none", use_flash: bool = False) -> torch.Tensor:
    """Teacher-forced forward from a zero state -> logits (B, S, V_padded).
    The default is the plain route (``sdpa``), as the reference's;
    ``use_flash`` runs the shared attention through the flash kernel (on
    CUDA tensors, which has no backward). remat: none | full | dots, the
    activation-checkpoint policy on each layer, the shared block included
    where it follows (``lm.remat_layer``)."""
    x = L.embed(params["embed"], tokens, lm.act_dtype(cfg))

    def mamba(lp, x):
        return _mamba_layer(lp, x, cfg)[0]

    def mamba_attn(lp, x):
        return _shared_block(params, mamba(lp, x), cfg,
                             use_flash=use_flash)[0]

    bodies = (lm.remat_layer(mamba, remat),
              lm.remat_layer(mamba_attn, remat))
    for i in range(cfg.n_layers):
        x = bodies[_is_attn(cfg, i)](lm.layer(params["layers"], i), x)
    return lm.unembed(params, x, cfg)


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int, *,
                      device: str | torch.device = "cuda") -> dict:
    """Zeros: each layer's conv carry and SSD state, and one KV ring of
    ``min(sliding_window, max_seq)`` slots a shared-block invocation."""
    dev = resolve_device(device)
    d_inner, H, P, N = dims(cfg)
    cache_len = min(cfg.sliding_window or max_seq, max_seq)
    dtype = lm.act_dtype(cfg)
    kv = (max(n_attn(cfg), 1), batch, cache_len, cfg.n_kv_heads, cfg.hd)
    return {
        "conv": torch.zeros((cfg.n_layers, batch, cfg.ssm.conv_width - 1,
                             d_inner), dtype=dtype, device=dev),
        "ssm": torch.zeros((cfg.n_layers, batch, H, N, P),
                           dtype=torch.float32, device=dev),
        "attn_k": torch.zeros(kv, dtype=dtype, device=dev),
        "attn_v": torch.zeros(kv, dtype=dtype, device=dev),
    }


def _run(params: dict, tokens: torch.Tensor, state: dict, cfg: ModelConfig,
         index: int, use_flash: bool = False) -> torch.Tensor:
    """Run tokens (B, S) through every layer from ``state``, which is
    updated IN PLACE; returns the last layer's output x. One token (S = 1)
    is position ``index``: its keys and values go to ring slot ``index mod
    cache_len``. A block (S > 1) must start at position 0 from the zero
    state and fit the ring: its keys and values fill slots 0 .. S-1."""
    S = tokens.shape[1]
    cache_len = state["attn_k"].shape[2]
    if S > 1 and (index != 0 or S > cache_len):
        raise ValueError(f"a block of {S} tokens at position {index}: "
                         f"blocks start at 0 and fit the {cache_len}-slot "
                         f"ring")
    x = L.embed(params["embed"], tokens, lm.act_dtype(cfg))
    a = 0
    for i in range(cfg.n_layers):
        x, (conv, ssm) = _mamba_layer(
            lm.layer(params["layers"], i), x, cfg,
            conv_carry=state["conv"][i], ssm_state=state["ssm"][i])
        state["conv"][i] = conv
        state["ssm"][i] = ssm
        if not _is_attn(cfg, i):
            continue
        if S == 1:
            kv = {"k": state["attn_k"][a], "v": state["attn_v"][a]}
            x, _ = _shared_block(params, x, cfg, kv_cache=kv,
                                 cache_index=index % cache_len)
        else:
            x, kv = _shared_block(params, x, cfg, use_flash=use_flash)
            state["attn_k"][a, :, :S] = kv["k"]
            state["attn_v"][a, :, :S] = kv["v"]
        a += 1
    return x


def decode_step(params: dict, token: torch.Tensor, state: dict, index: int,
                cfg: ModelConfig):
    """One decode step at position ``index`` (a Python int). token: (B, 1).
    -> (logits (B, 1, V_padded), state), the state written IN PLACE.

    As the reference's, the shared block writes the token's keys and values
    at ring slot ``widx = index mod cache_len``, ropes its query and key at
    ``widx`` (not at ``index``), and attends to the slots ≤ ``widx``: once
    the ring has wrapped, the previous lap's slots above ``widx`` are
    hidden though they lie inside the window."""
    x = _run(params, token, state, cfg, index)
    return lm.unembed(params, x, cfg), state


def prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            max_seq: int | None = None, use_kernels: bool = False):
    """Prefill pass -> (last-position logits (B, 1, V_padded), decode
    state for a sequence of up to ``max_seq`` tokens, default S).

    The state is the one the reference's serve builds by stepping
    ``decode_step`` over the prompt from ``init_decode_state``: first the
    longest prefix that is a multiple of ``cfg.ssm.chunk`` and fits the
    KV ring runs as one block (chunked SSD, the shared attention through
    the flash kernel under ``use_kernels``), filling each layer's conv
    carry and SSD state and each invocation's KV cache; then the rest
    takes the one-step route from the carried state, token by token (past
    the ring's end that is the only route that keeps the reference's ring
    semantics; see ``decode_step``). Only the last position is
    unembedded."""
    B, S = tokens.shape
    state = init_decode_state(cfg, B, max_seq or S, device=tokens.device)
    head = min(S, state["attn_k"].shape[2])
    head -= head % cfg.ssm.chunk
    x = None
    if head:
        x = _run(params, tokens[:, :head], state, cfg, 0,
                 use_flash=use_kernels)
    for t in range(head, S):
        x = _run(params, tokens[:, t:t + 1], state, cfg, t)
    return lm.unembed(params, x[:, -1:], cfg), state

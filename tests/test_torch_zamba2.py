"""The port's Zamba2 (the ``hybrid`` family) against the reference, on the
CPU.

Configurations: the reduced ``zamba2-1.2b`` (2 layers, d64, 8 SSD heads
of P 16 and N 8, chunk 16, the shared block after every second layer, a
64-token window) and that config at 4 layers, where two shared-block
invocations each fill their own KV ring. Parameters: the reference's
``init_params`` tree with numpy noise where its init hides errors (norm
and out-norm scales 1, ``D_skip`` 1, ``dt_bias`` 0), carried across with
``convert.lm_params``; inputs from numpy with a seed.

* ``_short_conv`` (with and without a carry), ``ssd_chunked`` (several
  chunks, a carried state, strong decay: A·dt past 200 a step),
  ``ssd_step`` and ``mamba2_block`` against the reference's, and
  ``ssd_chunked`` against the one-step recurrence it stands for.
* ``forward`` against ``Z.forward``; the block prefill's logits against
  the reference's ``make_prefill_step``.
* ``decode_step`` stepped past the ring's end (prompt + new tokens > 64)
  against the reference's, logits and the whole state at every step.
* The port's served route (``launch.serve.generate``: block prefill, the
  rest of the prompt one token at a time, then decode) against the
  reference's token-by-token serve loop (``repro/launch/serve.py``'s
  ``hybrid`` branch): the state after the prompt, the logits and, in
  float32, the greedy tokens, at a prompt that is a multiple of the chunk
  (32), a ragged one (37), one whose decode wraps the ring (60) and one
  longer than the ring (70).
* ``model_loss`` and its gradients against ``jax.grad``, and every
  ``remat`` mode bitwise ``"none"``, at two invocations
  (``tests/test_torch_train.py`` holds the 2-layer model's gradients and
  3 train steps against the reference's jitted step).

Float32 within ``F32_ATOL`` (measured: logits 1.1e-6 at 2 layers, 3.7e-6
at 4, states 1e-6 or less), greedy tokens exactly equal; bfloat16 layers
within ``BF16_ATOL`` and bfloat16 logits within ``BF16_LOGITS_ATOL``, as
``tests/test_torch_rwkv6.py`` holds RWKV-6 (the two frameworks round
intermediates to bfloat16 at other places; measured: logits 0.021 at 2
layers, 0.035 at 4, against logits up to 0.67). The scan alone, in
float32 on unit-scale inputs, within ``SCAN_ATOL`` (relative to the
largest |output| under strong decay, whose outputs reach the hundreds).
The decode state after a prompt (conv carries, SSD states, KV rings): in
float32 the largest |Δ| within ``STATE_F32_REL`` of the largest |value|
(measured: 8.1e-6, the keys after the one-step tail); in bfloat16
rms(Δ)/rms within ``STATE_BF16_RMS`` (measured: 0.014-0.031; rounding
amplified over 4 layers, as the logits' 0.018 shows it is not a fault).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.models import zamba2 as JZ
from repro.serve.step import greedy_sample as jgreedy
from repro.serve.step import make_prefill_step as jprefill_step
from repro.train import step as JS
from repro.train.step import init_params
from repro_torch import convert
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.kernels.flash_attention import ops as tflash
from repro_torch.launch import serve as tserve
from repro_torch.models import lm, lm_module
from repro_torch.models import zamba2 as TZ
from repro_torch.train import optimizer as TO
from repro_torch.train import step as TS

jax.config.update("jax_threefry_partitionable", True)
torch.set_num_threads(1)   # small tensors: threads only contend

ARCH = "zamba2-1.2b"
F32_ATOL = 2e-5
BF16_ATOL = 3e-2
BF16_LOGITS_ATOL = 6e-2
SCAN_ATOL = 1e-5
STATE_F32_REL = 5e-5
STATE_BF16_RMS = 0.1
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _cfgs(dtype, n_layers=None):
    kw = dict(dtype=dtype)
    if n_layers:
        kw["n_layers"] = n_layers
    return (dataclasses.replace(ARCHS[ARCH].reduced(), **kw),
            dataclasses.replace(TARCHS[ARCH].reduced(), **kw))


def _perturbed_params(cfg, rng):
    """The reference's params with noise where its init is degenerate: the
    norm and out-norm scales N(0, 0.1) around 1, ``D_skip`` N(1, 0.3),
    ``dt_bias`` N(0, 0.5) and ``A_log`` N(0, 0.1) around its values."""
    def f(path, x):
        x = np.asarray(x, np.float32)
        name = getattr(path[-1], "key", "")
        noise = {
            "scale": lambda: x + rng.normal(0, 0.1, x.shape),
            "out_norm": lambda: x + rng.normal(0, 0.1, x.shape),
            "D_skip": lambda: x + rng.normal(0, 0.3, x.shape),
            "dt_bias": lambda: rng.normal(0, 0.5, x.shape),
            "A_log": lambda: x + rng.normal(0, 0.1, x.shape),
        }
        return noise[name]().astype(np.float32) if name in noise else x
    return jax.tree_util.tree_map_with_path(
        f, init_params(jax.random.PRNGKey(0), cfg))


def _setup(dtype, n_layers=None, seed=1):
    cfg, tcfg = _cfgs(dtype, n_layers)
    rng = np.random.default_rng(seed)
    tree = _perturbed_params(cfg, rng)
    return (cfg, tcfg, rng, jax.tree.map(jnp.asarray, tree),
            convert.lm_params(tree, tcfg, "cpu"))


def _x(rng, shape, dtype, scale=1.0):
    a = (rng.normal(size=shape) * scale).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _atol(dtype, logits=False):
    if dtype == "float32":
        return F32_ATOL
    return BF16_LOGITS_ATOL if logits else BF16_ATOL


def _close(got, want, atol):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)


# ---------------------------------------------------------------- Mamba2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_short_conv_matches_reference(dtype):
    rng = np.random.default_rng(0)
    jx, tx = _x(rng, (2, 20, 24), dtype)
    jw, tw = _x(rng, (4, 24), "float32", 0.5)
    jc, tc = _x(rng, (2, 3, 24), dtype)
    tol = 1e-6 if dtype == "float32" else BF16_ATOL
    for kj, kt in (({}, {}), ({"carry": jc}, {"carry": tc})):
        jy, jcarry = JZ._short_conv(jx, jw, **kj)
        ty, tcarry = TZ._short_conv(tx, tw, **kt)
        assert ty.dtype == DTYPES[dtype][1] and ty.shape == (2, 20, 24)
        _close(ty, jy, tol)
        np.testing.assert_array_equal(_np(tcarry), _np(jcarry))
    # one token: the carry is the last three inputs
    ty, tcarry = TZ._short_conv(tx[:, :1], tw, tc)
    jy, jcarry = JZ._short_conv(jx[:, :1], jw, jc)
    _close(ty, jy, tol)
    np.testing.assert_array_equal(_np(tcarry), _np(jcarry))


def _scan_inputs(shape, n, seed, *, a_hi=16.0, state=False):
    """x, B, C ~ N(0, 1); dt = softplus(N(0, 1)); A log-spaced in (1,
    a_hi); state0 ~ N(0, 0.3): numpy arrays."""
    Bsz, S, H, P = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    Bm, Cm = (rng.normal(size=(Bsz, S, H, n)).astype(np.float32)
              for _ in range(2))
    dt = np.log1p(np.exp(rng.normal(size=(Bsz, S, H)))).astype(np.float32)
    A = np.exp(np.linspace(0.0, np.log(a_hi), H)).astype(np.float32)
    st = ((rng.normal(size=(Bsz, H, n, P)) * 0.3).astype(np.float32)
          if state else None)
    return x, Bm, Cm, dt, A, st


@pytest.mark.parametrize("case", ["plain", "state0", "strong_decay"])
def test_ssd_chunked_matches_reference(case):
    """Four chunks of 16; with a carried state; and strong decay (A up to
    128, so A·dt passes 200 a step and a chunk's cumulative log-decay
    falls below -1000, where exp(-cum) overflows: only the pairwise form
    stays finite)."""
    arrs = _scan_inputs((2, 64, 3, 8), 5, 7, state=case != "plain",
                        a_hi=128.0 if case == "strong_decay" else 16.0)
    if case == "strong_decay":
        assert float(np.max(arrs[4] * arrs[3])) > 200
    jy, js = JZ.ssd_chunked(*(None if a is None else jnp.asarray(a)
                              for a in arrs[:5]), chunk=16,
                            state0=None if arrs[5] is None
                            else jnp.asarray(arrs[5]))
    ty, ts = TZ.ssd_chunked(*(torch.from_numpy(a) for a in arrs[:5]),
                            chunk=16, state0=None if arrs[5] is None
                            else torch.from_numpy(arrs[5]))
    assert bool(torch.isfinite(ty).all() and torch.isfinite(ts).all())
    for got, want in ((ty, jy), (ts, js)):
        want = _np(want)
        _close(got, want, SCAN_ATOL * max(1.0, np.abs(want).max()))


def test_ssd_chunked_is_the_one_step_recurrence():
    """The chunked scan against ``ssd_step`` stepped over the sequence (the
    recurrence it evaluates), from a carried state."""
    x, Bm, Cm, dt, A, st = (torch.from_numpy(a) for a in _scan_inputs(
        (2, 48, 3, 8), 5, 3, state=True))
    y, s = TZ.ssd_chunked(x, Bm, Cm, dt, A, chunk=16, state0=st)
    state, ys = st, []
    for t in range(48):
        yt, state = TZ.ssd_step(x[:, t], Bm[:, t], Cm[:, t], dt[:, t], A,
                                state)
        ys.append(yt)
    _close(y, torch.stack(ys, 1), SCAN_ATOL)
    _close(s, state, SCAN_ATOL)


def test_ssd_step_matches_reference():
    x, Bm, Cm, dt, A, st = _scan_inputs((3, 1, 4, 8), 6, 11, state=True)
    args = (x[:, 0], Bm[:, 0], Cm[:, 0], dt[:, 0], A, st)
    jy, js = JZ.ssd_step(*(jnp.asarray(a) for a in args))
    ty, ts = TZ.ssd_step(*(torch.from_numpy(a) for a in args))
    _close(ty, jy, 1e-6)
    _close(ts, js, 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_block_matches_reference(dtype):
    """A 32-token block from zero, the same block from carried conv and
    SSD states, and one token from them (the one-step route)."""
    cfg, tcfg, rng, jp, tp = _setup(dtype)
    jlp = jax.tree.map(lambda a: a[1], jp["layers"])["mamba"]
    tlp = lm.layer(tp["layers"], 1)["mamba"]
    d_inner, H, P, N = TZ.dims(tcfg)
    jx, tx = _x(rng, (2, 32, cfg.d_model), dtype)
    jc, tc = _x(rng, (2, cfg.ssm.conv_width - 1, d_inner), dtype)
    st = (rng.normal(size=(2, H, N, P)) * 0.3).astype(np.float32)
    atol = _atol(dtype)
    for xs, kw in (((jx, tx), {}),
                   ((jx, tx), dict(carry=True)),
                   ((jx[:, :1], tx[:, :1]), dict(carry=True))):
        kj = kt = {}
        if kw:
            kj = dict(conv_carry=jc, ssm_state=jnp.asarray(st))
            kt = dict(conv_carry=tc, ssm_state=torch.from_numpy(st))
        jy, (jconv, jst) = JZ.mamba2_block(jlp, xs[0], cfg, **kj)
        ty, (tconv, tst) = TZ.mamba2_block(tlp, xs[1], tcfg, **kt)
        assert ty.dtype == DTYPES[dtype][1] and tst.dtype == torch.float32
        _close(ty, jy, atol)
        _close(tconv, jconv, atol)
        _close(tst, jst, atol * 10)


# ---------------------------------------------------------------- model


@pytest.mark.parametrize("n_layers", [None, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(dtype, n_layers):
    cfg, tcfg, rng, jp, tp = _setup(dtype, n_layers)
    toks = rng.integers(0, cfg.vocab_size, (2, 48)).astype(np.int32)
    want = JZ.forward(jp, jnp.asarray(toks), cfg)
    got = TZ.forward(tp, torch.from_numpy(toks).long(), tcfg)
    assert got.shape == want.shape == (2, 48, lm.padded_vocab(tcfg))
    _close(got, want, _atol(dtype, logits=True))
    before = dict(tflash.KERNEL_LAUNCHES)
    flash = TZ.forward(tp, torch.from_numpy(toks).long(), tcfg,
                       use_flash=True)
    assert tflash.KERNEL_LAUNCHES == before     # CPU tensors: plain version
    _close(flash, want, _atol(dtype, logits=True))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_logits_match_reference_prefill_step(dtype):
    """A 48-token prompt (three chunks, inside the ring) through the block
    prefill against the reference's ``make_prefill_step`` (its forward's
    last position)."""
    cfg, tcfg, rng, jp, tp = _setup(dtype, 4)
    toks = rng.integers(0, cfg.vocab_size, (2, 48)).astype(np.int32)
    want = jprefill_step(cfg)(jp, jnp.asarray(toks))
    got, state = TZ.prefill(tp, torch.from_numpy(toks).long(), tcfg,
                            max_seq=60, use_kernels=True)
    assert got.shape == want.shape == (2, 1, lm.padded_vocab(tcfg))
    _close(got, want, _atol(dtype, logits=True))
    assert state["attn_k"].shape == (2, 2, 60, tcfg.n_kv_heads, tcfg.hd)
    assert not state["attn_k"][:, :, 48:].any()


def _reference_decode(cfg):
    return jax.jit(lambda p, tok, st, i: JZ.decode_step(p, tok, st, i, cfg))


def _state_np(state):
    return {k: _np(v) for k, v in state.items()}


def _assert_states_close(got, want, dtype, what=""):
    """Each part of the decode state: in float32 the largest |Δ| within
    ``STATE_F32_REL`` of the largest |value|; in bfloat16 rms(Δ)/rms within
    ``STATE_BF16_RMS``."""
    for key in ("conv", "ssm", "attn_k", "attn_v"):
        g, w = _np(got[key]).astype(np.float64), _np(want[key])
        d = np.abs(g - w)
        if dtype == "float32":
            assert d.max() <= STATE_F32_REL * np.abs(w).max(), (what, key)
        else:
            rms = np.sqrt(np.mean(d ** 2) / np.mean(w.astype(np.float64)
                                                    ** 2))
            assert rms <= STATE_BF16_RMS, (what, key, rms)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_wrap_the_ring_as_the_reference(dtype):
    """76 decode steps from the zero state with a 64-slot ring (max_seq
    80): past step 64 each token overwrites slot index mod 64, is roped at
    that slot and sees the slots up to it, as in the reference."""
    cfg, tcfg, rng, jp, tp = _setup(dtype, 4)
    B, steps = 2, 76
    toks = rng.integers(0, cfg.vocab_size, (B, steps)).astype(np.int32)
    decode = _reference_decode(cfg)
    jstate = JZ.init_decode_state(cfg, B, 80)
    tstate = TZ.init_decode_state(tcfg, B, 80, device="cpu")
    assert tstate["attn_k"].shape[2] == 64 == jstate["attn_k"].shape[2]
    for t in range(steps):
        jl, jstate = decode(jp, jnp.asarray(toks[:, t:t + 1]), jstate,
                            jnp.int32(t))
        tl, tstate = TZ.decode_step(tp, torch.from_numpy(toks[:, t:t + 1])
                                    .long(), tstate, t, tcfg)
        _close(tl, jl, _atol(dtype, logits=True))
    _assert_states_close(tstate, jstate, dtype)


def _reference_serve(params, prompts, cfg, gen):
    """``repro/launch/serve.py``'s ``hybrid`` branch: ``decode_step`` over
    the prompt one token at a time, then greedy decode. Returns (tokens,
    the prompt's last logits, the first decode logits, the state after the
    prompt)."""
    B, S = prompts.shape
    decode = _reference_decode(cfg)
    state = JZ.init_decode_state(cfg, B, S + gen)
    for t in range(S):
        logits, state = decode(params, jnp.asarray(prompts[:, t:t + 1]),
                               state, jnp.int32(t))
    after = jax.tree.map(np.asarray, state)
    pf, first = _np(logits), None
    token, out = jgreedy(logits), []
    for i in range(gen):
        out.append(token)
        logits, state = decode(params, token, state, jnp.int32(S + i))
        if i == 0:
            first = _np(logits)
        token = jgreedy(logits)
    return np.asarray(jnp.concatenate(out, axis=1)), pf, first, after


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("prompt_len", [32, 37, 60, 70])
def test_block_prefill_and_generate_match_reference_token_loop(prompt_len,
                                                               dtype):
    """The port's served route against the reference's token-by-token
    serve loop, 12 new tokens, 4 layers (two rings of min(64, S + 12)
    slots): 32 is two chunks; 37 two chunks and a 5-token tail; 60 three
    chunks and a 12-token tail, then a decode that wraps the ring; 70 a
    64-token block (the whole ring) and a 6-token tail past its end."""
    cfg, tcfg, rng, jp, tp = _setup(dtype, 4)
    B, G = 2, 12
    prompts = rng.integers(0, cfg.vocab_size, (B, prompt_len)).astype(
        np.int32)
    want_tok, want_pf, want_dec, want_state = _reference_serve(
        jp, prompts, cfg, G)
    tprompts = torch.from_numpy(prompts).long()
    logits, state = TZ.prefill(tp, tprompts, tcfg, max_seq=prompt_len + G,
                               use_kernels=True)
    _assert_states_close(state, want_state, dtype, f"S={prompt_len}")
    _close(logits, want_pf, _atol(dtype, logits=True))
    before = dict(tflash.KERNEL_LAUNCHES)
    res = tserve.generate(tp, tprompts, tcfg, G, use_kernels=True)
    assert tflash.KERNEL_LAUNCHES == before     # CPU tensors: plain version
    assert res["tokens"].shape == (B, G)
    for got, want in ((res["prefill_logits"], want_pf),
                      (res["decode_logits"], want_dec)):
        _close(got, want, _atol(dtype, logits=True))
    if dtype == "float32":
        np.testing.assert_array_equal(res["tokens"].numpy(), want_tok)


def test_block_prefill_takes_the_longest_chunked_prefix_that_fits(
        monkeypatch):
    """What runs as a block: the prompt's longest multiple of the chunk
    that fits the ring; the rest goes one token at a time."""
    _, tcfg, rng, _, tp = _setup("float32")
    seen = []
    run = TZ._run

    def spy(params, tokens, state, cfg, index, use_flash=False):
        seen.append((index, tokens.shape[1]))
        return run(params, tokens, state, cfg, index, use_flash)

    toks = torch.from_numpy(rng.integers(0, 256, (1, 70))).long()
    monkeypatch.setattr(TZ, "_run", spy)
    for S, max_seq in ((37, 40), (70, 80), (16, 16), (10, 20)):
        seen.clear()
        TZ.prefill(tp, toks[:, :S], tcfg, max_seq=max_seq)
        head = min(S, 64, max_seq) // 16 * 16
        want = ([(0, head)] if head else []) + [
            (t, 1) for t in range(head, S)]
        assert seen == want, (S, seen)
    monkeypatch.undo()
    state = TZ.init_decode_state(tcfg, 1, 80, device="cpu")
    with pytest.raises(ValueError, match="blocks start at 0"):
        TZ._run(tp, toks[:, :32], state, tcfg, 16)
    with pytest.raises(ValueError, match="fit"):
        TZ._run(tp, toks[:, :70], state, tcfg, 0)


# ------------------------------------------------------------- training


def test_model_loss_and_gradients_match_reference_at_two_invocations():
    """float32, 4 layers: the loss within 1e-5 relative and each leaf's
    gradient within 1e-4 rel_rms of ``jax.grad`` of the reference's
    ``model_loss`` (measured: 8.6e-8 and 6.4e-6 at most)."""
    cfg, tcfg, rng, jp, tp = _setup("float32", 4)
    from repro.configs.base import ShapeSpec as JShapeSpec
    from repro.train import data as JD
    jb = JD.make_batch_fn(cfg, JShapeSpec("t", 32, 4, "train"), seed=0)(0)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    jl, jg = jax.value_and_grad(
        lambda p: JS.model_loss(p, jb, cfg, remat="none"))(jp)
    alias = TO.tree_map(lambda x: x.detach().requires_grad_(), tp)
    tl = TS.model_loss(alias, tb, tcfg, remat="none")
    tg = torch.autograd.grad(tl, TO.leaves(alias))
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    jflat = lm.flatten(jg)
    for (path, _), g in zip(sorted(lm.flatten(tp).items()), tg):
        want = np.asarray(jflat[path], np.float64)
        assert np.any(want), path
        err = np.sqrt(np.mean((g.numpy() - want) ** 2))
        assert err <= 1e-4 * np.sqrt(np.mean(want ** 2)), path


def test_remat_modes_bitwise_equal_at_two_invocations():
    _, tcfg, rng, _, tp = _setup("float32", 4)
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.train.data import make_batch_fn
    batch = make_batch_fn(tcfg, ShapeSpec("t", 32, 2, "train"),
                          device="cpu")(0)
    runs = {}
    for remat in ("none", "full", "dots"):
        p = TO.tree_map(lambda x: x.clone(), tp)
        o = TO.init(p)
        step = TS.make_train_step(tcfg, remat=remat)
        for _ in range(2):
            p, o, m = step(p, o, batch)
        runs[remat] = (m, TO.leaves(p))
    for remat in ("full", "dots"):
        m, leaves = runs[remat]
        assert torch.equal(m["loss"], runs["none"][0]["loss"]), remat
        assert torch.equal(m["grad_norm"], runs["none"][0]["grad_norm"])
        assert all(torch.equal(a, b) for a, b in
                   zip(leaves, runs["none"][1])), remat


# --------------------------------------------------------------- layout


def test_lm_params_layout_dtypes_and_init():
    cfg, tcfg = _cfgs("bfloat16")
    tree = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0), cfg))
    params = convert.lm_params(tree, tcfg, "cpu")
    specs = lm_module(tcfg).flat_specs(tcfg)
    assert specs == TZ.flat_specs(tcfg)
    assert sorted(lm.flatten(params)) == sorted(specs)
    f32 = sorted(p for p, leaf in specs.items() if leaf.f32)
    assert f32 == sorted(
        ["final_norm/scale", "shared_norm/scale", "shared_mlp_norm/scale",
         "layers/norm/scale"] + [f"layers/mamba/{n}" for n in
                                 ("A_log", "dt_bias", "D_skip",
                                  "out_norm")])
    mamba = params["layers"]["mamba"]
    assert mamba["w_in_B"].dtype == torch.bfloat16
    assert mamba["w_in_B"].shape == (cfg.n_layers, cfg.d_model, 8, 8)
    assert torch.equal(mamba["A_log"],
                       torch.tensor(tree["layers"]["mamba"]["A_log"]))
    assert params["lm_head"].shape == (cfg.d_model, lm.padded_vocab(tcfg))
    assert params["shared_attn"]["wq"].shape == (cfg.d_model, 4, 16)
    init = TZ.init_lm(tcfg, seed=0, device="cpu")
    for path, t in lm.flatten(init).items():
        assert t.shape == specs[path].shape, path
        assert t.dtype == (torch.float32 if specs[path].f32
                           else torch.bfloat16), path
    # the reference's A_log init, and its constants
    np.testing.assert_allclose(init["layers"]["mamba"]["A_log"].numpy(),
                               tree["layers"]["mamba"]["A_log"], rtol=1e-6)
    assert bool((init["layers"]["mamba"]["D_skip"] == 1).all())
    assert not init["layers"]["mamba"]["dt_bias"].any()
    with pytest.raises(ValueError, match="missing.*shared_mlp/w_up"):
        convert.lm_params(dict(tree, shared_mlp={
            k: v for k, v in tree["shared_mlp"].items() if k != "w_up"}),
            tcfg, "cpu")

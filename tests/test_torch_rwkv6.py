"""The port's RWKV-6 against the reference, on the CPU.

The WKV6 scan: the port's plain chunked version (what
``kernels.rwkv6_scan.ops.wkv6`` runs on CPU tensors) against the
reference's Pallas kernel in interpret mode, its ``ops.wkv6`` (which folds
a carried state in by linearity), its jnp ``wkv_chunked`` and its
sequential ``wkv6_ref``; the port's own sequential ``wkv6_ref`` against
the reference's. (The CUDA kernel is held against the plain version on
the card by ``test_torch_cuda.py`` and ``chip_smoke.py``.) Tolerances for
the scan are those of the reference's kernel tests (out 2e-4, state 2e-5
absolute, inputs of unit scale): the two sides sum in other orders.

The model: the reduced ``rwkv6-3b`` (2 layers, d64, 4 heads of 16, chunk
16) with the reference's ``init_params`` tree perturbed with numpy noise
(the reference's init hides errors: ``bonus_u`` is 0, every ``mu`` 0.5,
``ln_x`` 1, and ``decay_base`` -6 gives w ≈ 0.9975 everywhere), carried
across with ``convert.lm_params``. ``time_mix``, ``channel_mix``,
``forward`` and ``decode_step`` against the reference's; the port's
served route (``launch.serve.generate``: block prefill with
``use_kernels``, then one-token decode) against the reference's serve loop,
which steps ``decode_step`` one prompt token at a time. Float32 within
``F32_ATOL`` and greedy tokens exactly equal; bfloat16 layers within
``BF16_ATOL`` (the two frameworks round intermediates to bfloat16 at
other places), as ``tests/test_torch_serve.py``, and bfloat16 logits at
the end of the two layers within ``BF16_LOGITS_ATOL``: measured here, the
two routes differ by single bfloat16 steps in every layer, but the
reference's own bfloat16 logits lie up to 0.032 from its float32 logits
(rel_rms 0.023) and the port's up to 0.036 (0.026), so the two bfloat16
routes may part by about twice that (measured worst case 0.039, at the
first position, against logits up to 0.66).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.kernels.rwkv6_scan import ops as jops
from repro.kernels.rwkv6_scan.kernel import wkv6 as jkernel
from repro.kernels.rwkv6_scan.ref import wkv6_ref as jwkv6_ref
from repro.models import rwkv6 as JR
from repro.serve.step import greedy_sample as jgreedy
from repro.train.step import init_params
from repro_torch import convert
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.kernels.rwkv6_scan import ops as tops
from repro_torch.kernels.rwkv6_scan import ref as tref
from repro_torch.launch import serve as tserve
from repro_torch.models import lm, lm_module
from repro_torch.models import rwkv6 as TR

jax.config.update("jax_threefry_partitionable", True)
torch.set_num_threads(1)   # small tensors: threads only contend

OUT_ATOL = 2e-4
STATE_ATOL = 2e-5
STRONG_REL = 1e-5
F32_ATOL = 2e-5
BF16_ATOL = 3e-2
BF16_LOGITS_ATOL = 6e-2
ARCH = "rwkv6-3b"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _scan_inputs(shape, seed, *, w_lo=0.45, w_hi=0.95, state=False):
    """r, k, v ~ N(0, 1), w uniform in (w_lo, w_hi) on a log-log scale
    (w = exp(-exp(z))), u ~ N(0, 0.1), state0 ~ N(0, 0.3): numpy arrays."""
    B, S, H, K = shape
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    z = rng.uniform(np.log(-np.log(w_hi)), np.log(-np.log(w_lo)), shape)
    w = np.exp(-np.exp(z)).astype(np.float32)
    u = (rng.normal(size=(H, K)) * 0.1).astype(np.float32)
    st = ((rng.normal(size=(B, H, K, K)) * 0.3).astype(np.float32)
          if state else None)
    return r, k, v, w, u, st


def _t(arrs):
    return [None if a is None else torch.from_numpy(a) for a in arrs]


def _j(arrs):
    return [None if a is None else jnp.asarray(a) for a in arrs]


# the reference's kernel-test shapes (tests/test_kernels.py)
@pytest.mark.parametrize("B,S,H,K,chunk", [
    (2, 128, 3, 16, 32), (1, 256, 2, 64, 64), (2, 64, 4, 8, 16),
])
def test_wkv6_plain_matches_reference_kernel(B, S, H, K, chunk):
    arrs = _scan_inputs((B, S, H, K), B + S)
    before = dict(tops.KERNEL_LAUNCHES)
    got_o, got_s = tops.wkv6(*_t(arrs[:5]), chunk=chunk)
    assert tops.KERNEL_LAUNCHES == before     # CPU tensors: plain version
    ker_o, ker_s = jkernel(*_j(arrs[:5]), chunk=chunk, interpret=True)
    ref_o, ref_s = jwkv6_ref(*_j(arrs[:5]))
    for want_o, want_s in ((ker_o, ker_s), (ref_o, ref_s)):
        np.testing.assert_allclose(_np(got_o), _np(want_o), atol=OUT_ATOL,
                                   rtol=0)
        np.testing.assert_allclose(_np(got_s), _np(want_s),
                                   atol=STATE_ATOL, rtol=0)


@pytest.mark.parametrize("B,S,H,K,chunk", [
    (2, 64, 4, 8, 16), (1, 48, 2, 16, 48), (2, 37, 3, 16, 37),
])
def test_wkv6_carried_state_matches_reference_ops(B, S, H, K, chunk):
    """With a carried state0: the reference's wrapper runs its kernel from
    a zero state and folds state0 in by linearity; the port's plain version
    (like its kernel) starts from state0. A 37-step tail block, as a
    ragged prompt's, is one chunk of 37."""
    arrs = _scan_inputs((B, S, H, K), 9 + S, state=True)
    got_o, got_s = tops.wkv6(*_t(arrs[:5]), chunk=chunk,
                             state0=torch.from_numpy(arrs[5]))
    want_o, want_s = jops.wkv6(*_j(arrs[:5]), chunk=chunk,
                               state0=jnp.asarray(arrs[5]),
                               force_interpret=True)
    np.testing.assert_allclose(_np(got_o), _np(want_o), atol=OUT_ATOL,
                               rtol=0)
    np.testing.assert_allclose(_np(got_s), _np(want_s), atol=STATE_ATOL,
                               rtol=0)


def test_wkv6_strong_decay_stays_finite_and_matches_reference():
    """w down to 1e-6: a 64-step chunk reaches cum ≈ -880, where the
    factored exp(cum_excl)·exp(-cum) overflows; the pairwise form stays
    finite. Against the reference's jnp ``wkv_chunked`` (same formula) and
    the sequential ``wkv6_ref``, with a carried state. The outputs reach
    45 here, so the tolerance is relative to the largest |output|:
    ``STRONG_REL`` of it (the reference's own chunked and sequential
    versions differ by 6.3e-6 of it: cum is rounded at |cum| up to 880,
    where a float32 step is 6e-5)."""
    shape, chunk = (2, 128, 3, 16), 64
    arrs = _scan_inputs(shape, 5, w_lo=1e-6, w_hi=0.95, state=True)
    assert arrs[3].min() < 1e-5
    got_o, got_s = tops.wkv6(*_t(arrs[:5]), chunk=chunk,
                             state0=torch.from_numpy(arrs[5]))
    assert bool(torch.isfinite(got_o).all() and torch.isfinite(got_s).all())
    ch_o, ch_s = JR.wkv_chunked(*_j(arrs[:5]), chunk=chunk,
                                state0=jnp.asarray(arrs[5]))
    sq_o, sq_s = jwkv6_ref(*_j(arrs[:5]), state0=jnp.asarray(arrs[5]))
    for want_o, want_s in ((ch_o, ch_s), (sq_o, sq_s)):
        for got, want in ((got_o, want_o), (got_s, want_s)):
            want = _np(want)
            np.testing.assert_allclose(
                _np(got), want, atol=STRONG_REL * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("state", [False, True])
def test_wkv6_sequential_ref_matches_reference(state):
    arrs = _scan_inputs((2, 40, 3, 8), 3, state=state)
    got_o, got_s = tref.wkv6_ref(*_t(arrs))
    want_o, want_s = jwkv6_ref(*_j(arrs))
    np.testing.assert_allclose(_np(got_o), _np(want_o), atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(got_s), _np(want_s), atol=1e-5, rtol=0)


def test_wkv6_refuses_a_chunk_that_does_not_divide_s():
    arrs = _t(_scan_inputs((1, 40, 2, 8), 0)[:5])
    with pytest.raises(ValueError, match="multiple of chunk"):
        tops.wkv6(*arrs, chunk=16)
    with pytest.raises(ValueError, match="CUDA"):
        tops.wkv6_kernel(*arrs, chunk=8)


# ------------------------------------------------------------------ model


def _cfgs(dtype):
    return (dataclasses.replace(ARCHS[ARCH].reduced(), dtype=dtype),
            dataclasses.replace(TARCHS[ARCH].reduced(), dtype=dtype))


def _perturbed_params(cfg, rng):
    """The reference's params with noise where its init is degenerate: norm
    scales and biases and ``ln_x`` N(0, 0.1) around their values, every
    ``mu`` uniform in (0, 1), ``bonus_u`` N(0, 0.5), and ``decay_base``
    uniform in (-6.9, 2.2), so that w = exp(-exp(decay)) spans about
    (1e-4, 0.999)."""
    def f(path, x):
        x = np.asarray(x, np.float32)
        name = getattr(path[-1], "key", "")
        noise = {
            "scale": lambda: x + rng.normal(0, 0.1, x.shape),
            "bias": lambda: x + rng.normal(0, 0.1, x.shape),
            "ln_x": lambda: x + rng.normal(0, 0.1, x.shape),
            "bonus_u": lambda: rng.normal(0, 0.5, x.shape),
            "decay_base": lambda: rng.uniform(-6.9, 2.2, x.shape),
        }
        if name.startswith("mu_"):
            return rng.uniform(0, 1, x.shape).astype(np.float32)
        return noise[name]().astype(np.float32) if name in noise else x
    return jax.tree_util.tree_map_with_path(
        f, init_params(jax.random.PRNGKey(0), cfg))


def _setup(dtype, seed=1):
    cfg, tcfg = _cfgs(dtype)
    rng = np.random.default_rng(seed)
    tree = _perturbed_params(cfg, rng)
    params = convert.lm_params(tree, tcfg, "cpu")
    jparams = jax.tree.map(jnp.asarray, tree)
    return cfg, tcfg, rng, jparams, params


def _x(rng, shape, dtype):
    a = rng.normal(size=shape).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _atol(dtype, logits=False):
    if dtype == "float32":
        return F32_ATOL
    return BF16_LOGITS_ATOL if logits else BF16_ATOL


def test_perturbed_decays_span_the_range():
    cfg, tcfg, rng, jp, tp = _setup("float32")
    lp = lm.layer(tp["layers"], 0)["time_mix"]
    x = torch.randn(2, 16, tcfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    w = TR._project(lp, x, TR._token_shift(x), torch.float32)[4]
    assert float(w.min()) < 1e-3 and float(w.max()) > 0.99


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_time_mix_and_channel_mix_match_reference(dtype):
    cfg, tcfg, rng, jp, tp = _setup(dtype)
    jlp = jax.tree.map(lambda a: a[1], jp["layers"])
    tlp = lm.layer(tp["layers"], 1)
    B, S, D = 2, 32, cfg.d_model
    H, K = TR.n_heads(tcfg), tcfg.rwkv.head_dim
    jx, tx = _x(rng, (B, S, D), dtype)
    jprev, tprev = _x(rng, (B, 1, D), dtype)
    st = (rng.normal(size=(B, H, K, K)) * 0.3).astype(np.float32)
    atol = _atol(dtype)
    for kw_j, kw_t in (({}, {}),
                       (dict(shift_prev=jprev, state0=jnp.asarray(st)),
                        dict(shift_prev=tprev, state0=torch.from_numpy(st)))):
        jy, (jsh, jst) = JR.time_mix(jlp["time_mix"], jx, cfg, **kw_j)
        ty, (tsh, tst) = TR.time_mix(tlp["time_mix"], tx, tcfg, **kw_t)
        np.testing.assert_allclose(_np(ty), _np(jy), atol=atol, rtol=0)
        np.testing.assert_array_equal(_np(tsh), _np(jsh))
        np.testing.assert_allclose(_np(tst), _np(jst), atol=atol * 10,
                                   rtol=0)
    # one token with a carried state: the one-step recurrence
    jy, (_, jst) = JR.time_mix(jlp["time_mix"], jx[:, :1], cfg,
                               shift_prev=jprev, state0=jnp.asarray(st))
    ty, (_, tst) = TR.time_mix(tlp["time_mix"], tx[:, :1], tcfg,
                               shift_prev=tprev, state0=torch.from_numpy(st))
    np.testing.assert_allclose(_np(ty), _np(jy), atol=atol, rtol=0)
    np.testing.assert_allclose(_np(tst), _np(jst), atol=atol, rtol=0)
    jh, jc = JR.channel_mix(jlp["channel_mix"], jx, shift_prev=jprev)
    th, tc = TR.channel_mix(tlp["channel_mix"], tx, shift_prev=tprev)
    np.testing.assert_allclose(_np(th), _np(jh), atol=atol, rtol=0)
    np.testing.assert_array_equal(_np(tc), _np(jc))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(dtype):
    cfg, tcfg, rng, jp, tp = _setup(dtype)
    toks = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    want = JR.forward(jp, jnp.asarray(toks), cfg)
    got = TR.forward(tp, torch.from_numpy(toks).long(), tcfg)
    assert got.shape == want.shape == (2, 32, lm.padded_vocab(tcfg))
    np.testing.assert_allclose(_np(got), _np(want),
                               atol=_atol(dtype, logits=True), rtol=0)


def _reference_stepwise(params, prompts, cfg, gen):
    """``repro/launch/serve.py``'s ``ssm`` branch: step ``decode_step``
    over the prompt one token at a time, then decode greedily. Returns
    (tokens, prompt's last logits, first decode logits, state after the
    prompt)."""
    B, S = prompts.shape
    decode = jax.jit(lambda p, tok, st: JR.decode_step(p, tok, st, cfg))
    state = JR.init_decode_state(cfg, B)
    logits = None
    for t in range(S):
        logits, state = decode(params, jnp.asarray(prompts[:, t:t + 1]),
                               state)
    after_prompt = jax.tree.map(np.asarray, state)
    pf_logits, first = _np(logits), None
    token, out = jgreedy(logits), []
    for i in range(gen):
        out.append(token)
        logits, state = decode(params, token, state)
        if i == 0:
            first = _np(logits)
        token = jgreedy(logits)
    return (np.asarray(jnp.concatenate(out, axis=1)), pf_logits, first,
            after_prompt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_reference(dtype):
    """``decode_step`` stepped over a prompt (one token, then a 5-token
    block from the carried state) against the reference's."""
    cfg, tcfg, rng, jp, tp = _setup(dtype)
    B = 2
    toks = rng.integers(0, cfg.vocab_size, (B, 8)).astype(np.int32)
    jstate = JR.init_decode_state(cfg, B)
    tstate = TR.init_decode_state(tcfg, B, device="cpu")
    atol = _atol(dtype)
    for a, b in ((0, 1), (1, 2), (2, 3), (3, 8)):
        jl, jstate = JR.decode_step(jp, jnp.asarray(toks[:, a:b]), jstate,
                                    cfg)
        tl, tstate = TR.decode_step(tp, torch.from_numpy(toks[:, a:b]).long(),
                                    tstate, tcfg, use_kernel=True)
        assert tl.shape == jl.shape == (B, b - a, lm.padded_vocab(tcfg))
        np.testing.assert_allclose(_np(tl), _np(jl),
                                   atol=_atol(dtype, logits=True), rtol=0)
        for key in ("tm_shift", "cm_shift", "wkv"):
            np.testing.assert_allclose(_np(tstate[key]), _np(jstate[key]),
                                       atol=atol * 10, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("prompt_len", [32, 37])
def test_prefill_and_generate_match_reference_token_loop(prompt_len, dtype):
    """The port's block prefill (a 32-token prompt is two chunks of 16; a
    37-token one is two chunks and a 5-token tail from the carried state)
    and greedy decode against the reference's token-by-token serve loop:
    the state after the prompt, the logits and, in float32, the tokens."""
    cfg, tcfg, rng, jp, tp = _setup(dtype)
    B, G = 2, 8
    prompts = rng.integers(0, cfg.vocab_size, (B, prompt_len)).astype(
        np.int32)
    want_tok, want_pf, want_dec, want_state = _reference_stepwise(
        jp, prompts, cfg, G)
    atol = _atol(dtype)
    tprompts = torch.from_numpy(prompts).long()
    _, state = TR.prefill(tp, tprompts, tcfg, use_kernel=True)
    for key in ("tm_shift", "cm_shift", "wkv"):
        np.testing.assert_allclose(_np(state[key]), want_state[key],
                                   atol=atol * 10, rtol=0)
    before = dict(tops.KERNEL_LAUNCHES)
    res = tserve.generate(tp, tprompts, tcfg, G, use_kernels=True)
    assert tops.KERNEL_LAUNCHES == before     # CPU tensors: plain version
    assert res["tokens"].shape == (B, G)
    assert res["prefill_logits"].shape == (B, 1, lm.padded_vocab(tcfg))
    for got, want in ((res["prefill_logits"], want_pf),
                      (res["decode_logits"], want_dec)):
        np.testing.assert_allclose(_np(got), want,
                                   atol=_atol(dtype, logits=True), rtol=0)
    if dtype == "float32":
        np.testing.assert_array_equal(res["tokens"].numpy(), want_tok)


def test_lm_params_layout_dtypes_and_refusals():
    cfg, tcfg = _cfgs("bfloat16")
    tree = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0), cfg))
    params = convert.lm_params(tree, tcfg, "cpu")
    tm = params["layers"]["time_mix"]
    assert tm["wr"].dtype == torch.bfloat16
    for name in ("mu_r", "decay_base", "decay_A", "decay_B", "bonus_u",
                 "ln_x"):
        assert tm[name].dtype == torch.float32, name
        assert torch.equal(tm[name], torch.tensor(
            tree["layers"]["time_mix"][name]))
    assert params["layers"]["tm_norm"]["bias"].dtype == torch.float32
    specs = lm_module(tcfg).flat_specs(tcfg)
    assert specs == TR.flat_specs(tcfg)
    assert sorted(lm.flatten(params)) == sorted(specs)
    init = TR.init_lm(tcfg, seed=0, device="cpu")
    for path, t in lm.flatten(init).items():
        assert t.shape == specs[path].shape, path
        assert t.dtype == (torch.float32 if specs[path].f32
                           else torch.bfloat16), path
    extra = dict(tree, pos=np.zeros((4,), np.float32))
    with pytest.raises(ValueError, match="left over.*pos"):
        convert.lm_params(extra, tcfg, "cpu")
    missing = dict(tree, final_norm={"scale": tree["final_norm"]["scale"]})
    with pytest.raises(ValueError, match="missing.*final_norm/bias"):
        convert.lm_params(missing, tcfg, "cpu")
    layers = dict(tree["layers"], time_mix=dict(
        tree["layers"]["time_mix"],
        bonus_u=np.zeros((cfg.n_layers, 3, 16), np.float32)))
    with pytest.raises(ValueError, match="bonus_u has shape"):
        convert.lm_params(dict(tree, layers=layers), tcfg, "cpu")
    with pytest.raises(ValueError, match="missing"):
        convert.lm_params(tree, TARCHS["qwen2-0.5b"].reduced(), "cpu")

"""The port's encoder–decoder (the ``audio`` family, whisper-tiny) against
the reference, on the CPU.

Configuration: the reduced ``whisper-tiny`` (2 encoder and 2 decoder
layers, d64, 4 query heads over 2 KV heads of 16, 16 frames, vocabulary
256, 128 decoder positions), in float32 and bfloat16. Parameters: the
reference's ``init_params`` tree with numpy noise where its init hides
errors (LayerNorm scales N(1, 0.1), LayerNorm and MLP biases N(0, 0.1)),
carried across with ``convert.lm_params``; tokens and frames from numpy
with a seed.

* ``encode``, each layer's ``_cross_kv`` and ``precompute_cross_kv``,
  ``decode_train`` (cross K/V projected inside the layer, and given
  precomputed: bitwise the same) and ``forward`` against the reference's.
* ``decode_step`` over 6 steps from the empty cache the reference's serve
  starts from, at positions 5 to 10: the logits and both caches after
  every step.
* The served route (``launch.serve.generate``: one encode, one set of
  cross K/V for prefill and decode) against the reference's audio serve
  path (``repro/launch/serve.py``: the jitted prefill step, which encodes,
  then a second encode for the cross K/V, then the jitted decode step)
  run step by step with the same weights and frames: the prefill logits,
  the first decode logits and the greedy tokens.
* ``use_kernels`` on CPU tensors (the flash kernel's plain version in
  every attention of prefill) against the plain route.

Float32 within ``F32_ATOL`` of logits up to about 0.6 and encoder
states up to 3.8 (measured: logits 2.4e-7 for ``forward`` and over the
served route, the encoder's states 1.4e-6), greedy tokens equal.
bfloat16 within ``BF16_ATOL`` (measured: logits 0.0059, the encoder's
states 0.031 at values up to 3.8, one bfloat16 step there): the two
frameworks round intermediates to bfloat16 at other places, as
``tests/test_torch_zamba2.py`` holds Zamba2. bfloat16 greedy tokens are
compared only where the reference's top two logits are more than
``BF16_ATOL`` apart. The plain and flash-plain routes in float32 within
``F32_ATOL`` (they differ in where the softmax's weights are rounded).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.models import encdec as JE
from repro.serve.step import greedy_sample as jgreedy
from repro.serve.step import make_decode_step as jdecode_step
from repro.serve.step import make_prefill_step as jprefill_step
from repro.train.step import init_params
from repro_torch import convert
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.launch import serve as tserve
from repro_torch.models import encdec as TE
from repro_torch.models import lm, lm_module
from repro_torch.serve import step as tstep

jax.config.update("jax_threefry_partitionable", True)
torch.set_num_threads(1)   # small tensors: threads only contend

ARCH = "whisper-tiny"
F32_ATOL = 1e-5
BF16_ATOL = 6e-2
DTYPES = ("float32", "bfloat16")
B, S = 2, 12


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _atol(dtype: str) -> float:
    return F32_ATOL if dtype == "float32" else BF16_ATOL


def _close(got, want, dtype: str, what: str) -> None:
    np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                               atol=_atol(dtype), err_msg=what)


def _setup(dtype: str, seed: int = 1):
    cfg = dataclasses.replace(ARCHS[ARCH].reduced(), dtype=dtype)
    tcfg = dataclasses.replace(TARCHS[ARCH].reduced(), dtype=dtype)
    rng = np.random.default_rng(seed)

    def noise(path, x):
        x = np.asarray(x, np.float32)
        name = getattr(path[-1], "key", "")
        if name == "scale":
            return (x + rng.normal(0, 0.1, x.shape)).astype(np.float32)
        if name in ("bias", "b_up", "b_down"):
            return rng.normal(0, 0.1, x.shape).astype(np.float32)
        return x

    tree = jax.tree_util.tree_map_with_path(
        noise, init_params(jax.random.PRNGKey(seed), cfg))
    frames = rng.standard_normal(
        (B, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jframes = jnp.asarray(frames).astype(jnp.dtype(dtype))
    tframes = torch.from_numpy(frames).to(lm.act_dtype(tcfg))
    return (cfg, tcfg, tree, convert.lm_params(tree, tcfg), jframes,
            tframes, jnp.asarray(toks), torch.from_numpy(toks).long())


def test_param_layout_is_the_reference():
    cfg, tcfg, tree, tp, *_ = _setup("float32")
    assert lm_module(tcfg) is TE
    specs = TE.flat_specs(tcfg)
    ref = {k: np.shape(v) for k, v in lm.flatten(tree).items()}
    assert {k: v.shape for k, v in specs.items()} == ref
    f32 = sorted(k for k, v in specs.items() if v.f32)
    assert f32 and all(k.endswith(("norm/scale", "norm/bias")) for k in f32)
    assert sorted(k for k in specs if k.startswith("dec_layers/xattn/")) == [
        "dec_layers/xattn/wk", "dec_layers/xattn/wo", "dec_layers/xattn/wq",
        "dec_layers/xattn/wv"]
    init = TE.init_lm(tcfg, seed=0, device="cpu")
    assert {k: v.shape for k, v in lm.flatten(init).items()} == ref


@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_and_cross_kv_match_reference(dtype):
    cfg, tcfg, tree, tp, jf, tf, _, _ = _setup(dtype)
    jenc = JE.encode(tree, jf, cfg)
    tenc = TE.encode(tp, tf, tcfg)
    assert tenc.dtype == lm.act_dtype(tcfg)
    _close(tenc, jenc, dtype, "encode")
    jks, jvs = JE.precompute_cross_kv(tree, jenc, cfg)
    tks, tvs = TE.precompute_cross_kv(tp, tenc, tcfg)
    assert tks.shape == (cfg.n_layers, B, cfg.encoder.n_frames,
                         cfg.n_kv_heads, cfg.hd)
    _close(tks, jks, dtype, "xk")
    _close(tvs, jvs, dtype, "xv")
    for i in range(cfg.n_layers):
        k, v = TE._cross_kv(lm.layer(tp["dec_layers"], i), tenc, tcfg)
        assert torch.equal(k, tks[i]) and torch.equal(v, tvs[i])
        assert tks[i].is_contiguous()


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_train_and_forward_match_reference(dtype):
    cfg, tcfg, tree, tp, jf, tf, jt, tt = _setup(dtype)
    jenc = JE.encode(tree, jf, cfg)
    tenc = TE.encode(tp, tf, tcfg)
    want = JE.decode_train(tree, jt, jenc, cfg)
    got = TE.decode_train(tp, tt, tenc, tcfg)
    assert got.shape == (B, S, lm.padded_vocab(tcfg))
    _close(got, want, dtype, "decode_train")
    given = TE.decode_train(tp, tt, tenc, tcfg,
                            cross_kv=TE.precompute_cross_kv(tp, tenc, tcfg))
    assert torch.equal(given, got)
    _close(TE.forward(tp, tt, tf, tcfg), JE.forward(tree, jt, jf, cfg), dtype,
           "forward")


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_step_matches_reference(dtype):
    cfg, tcfg, tree, tp, jf, tf, jt, tt = _setup(dtype)
    max_seq, start, steps = 16, 5, 6
    jc = JE.init_kv_caches(cfg, B, max_seq)
    jc["xk"], jc["xv"] = JE.precompute_cross_kv(
        tree, JE.encode(tree, jf, cfg), cfg)
    tc = TE.init_kv_caches(tcfg, B, max_seq, device="cpu")
    tc["xk"], tc["xv"] = TE.precompute_cross_kv(
        tp, TE.encode(tp, tf, tcfg), tcfg)
    jdec = jax.jit(lambda p, t, c, i: JE.decode_step(p, t, c, i, cfg))
    for n in range(steps):
        idx = start + n
        jl, jc = jdec(tree, jt[:, n:n + 1], jc, jnp.int32(idx))
        tl, tc2 = TE.decode_step(tp, tt[:, n:n + 1], tc, idx, tcfg)
        assert tc2 is tc and tl.shape == (B, 1, lm.padded_vocab(tcfg))
        _close(tl, jl, dtype, f"logits at step {n}")
        for k in ("k", "v"):
            _close(tc[k], jc[k], dtype, f"{k} cache at step {n}")
        assert not tc["k"][:, :, idx + 1:].any()   # nothing past idx


def _reference_serve(cfg, tree, jframes, prompts, gen: int) -> dict:
    """The reference's audio route (``repro/launch/serve.py``), step by
    step: prefill, then encode again for the cross K/V of decode from a
    zero self-attention cache, decode at S + i."""
    prefill = jax.jit(jprefill_step(cfg))
    decode = jax.jit(jdecode_step(cfg))
    logits = prefill(tree, prompts, jframes)
    out = {"prefill_logits": logits}
    token = jgreedy(logits)
    caches = JE.init_kv_caches(cfg, prompts.shape[0], S + gen)
    enc = JE.encode(tree, jframes, cfg)
    caches["xk"], caches["xv"] = JE.precompute_cross_kv(tree, enc, cfg)
    generated = []
    for i in range(gen):
        generated.append(token)
        logits, caches = decode(tree, token, caches, jnp.int32(S + i))
        if i == 0:
            out["decode_logits"] = logits
        token = jgreedy(logits)
    out["tokens"] = np.asarray(jnp.concatenate(generated, axis=1))
    return out


@pytest.mark.parametrize("dtype", DTYPES)
def test_served_route_matches_reference_audio_path(dtype):
    cfg, tcfg, tree, tp, jf, tf, jt, tt = _setup(dtype)
    gen = 6
    want = _reference_serve(cfg, tree, jf, jt, gen)
    got = tserve.generate(tp, tt, tcfg, gen, frames=tf)
    assert got["tokens"].shape == (B, gen)
    _close(got["prefill_logits"], want["prefill_logits"], dtype, "prefill")
    _close(got["decode_logits"], want["decode_logits"], dtype, "decode")
    if dtype == "float32":
        np.testing.assert_array_equal(got["tokens"].numpy(), want["tokens"])
    else:
        # the first token, where the reference's top two logits part by
        # more than the bfloat16 limit
        top2 = np.sort(_np(want["prefill_logits"])[:, -1], axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > BF16_ATOL
        np.testing.assert_array_equal(got["tokens"][clear, 0].numpy(),
                                      want["tokens"][clear, 0])
    with pytest.raises(ValueError, match="frames"):
        tserve.generate(tp, tt, tcfg, gen)


@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_switch_on_cpu_matches_plain_route(dtype):
    """``use_kernels`` on CPU tensors: every attention of prefill through
    the flash kernel's plain version, against ``sdpa``'s route."""
    _, tcfg, _, tp, _, tf, _, tt = _setup(dtype)
    plain = tstep.make_prefill_step(tcfg)(tp, tt, tf)
    flash = tstep.make_prefill_step(tcfg, use_kernels=True)(tp, tt, tf)
    _close(flash[0], plain[0], dtype, "prefill logits")
    for k in ("xk", "xv"):
        _close(flash[1][k], plain[1][k], dtype, k)
    dec = tstep.make_decode_step(tcfg, use_kernels=True)
    caches = TE.init_kv_caches(tcfg, B, S + 1, device="cpu")
    caches["xk"], caches["xv"] = plain[1]["xk"], plain[1]["xv"]
    logits, _ = dec(tp, tt[:, :1], caches, S)
    assert logits.shape == (B, 1, lm.padded_vocab(tcfg))


def test_serve_entry_point_on_cpu():
    res = tserve.serve(ARCH, batch=2, prompt_len=8, gen=3, device="cpu")
    cfg = res["cfg"]
    assert res["tokens"].shape == (2, 3)
    assert res["frames"].shape == (2, cfg.encoder.n_frames, cfg.d_model)
    assert res["frames"].dtype == torch.bfloat16
    assert res["prefill_logits"].shape == (2, 1, lm.padded_vocab(cfg))
    again = tserve.serve(ARCH, batch=2, prompt_len=8, gen=3, device="cpu")
    assert torch.equal(res["tokens"], again["tokens"])   # from the seed
    assert torch.equal(res["frames"], again["frames"])

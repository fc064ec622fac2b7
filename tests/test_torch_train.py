"""The port's training pieces against the reference, on the CPU.

* AdamW (``train.optimizer``): ``update`` from the same numpy gradients
  over 5 steps, m, v and the parameters within 1e-6 of each leaf's
  largest magnitude (XLA may contract a multiply-add into one FMA, a
  rounding the port does not make, and where ``b1·m + (1 − b1)·g``
  cancels, that one rounding is large against the element); the grad
  norm, ``cosine_lr`` and ``clip_by_global_norm`` within 1e-6 relative.
* Compression (``train.compression``): ``q`` bitwise, the scale and the
  residual within float32 rounding.
* Data (``train.data``): tokens and labels bitwise for 3 seeds × 3 steps,
  at the reduced vocabulary and at qwen2's, and with the Gumbel noise
  drawn in many blocks of rows.
* Losses: ``loss_fn``, ``vocab_parallel_xent`` and
  ``aux_load_balance_loss`` within 1e-5 relative.
* ``model_loss``'s gradients for the reduced qwen2-0.5b, moonshot,
  rwkv6-3b, zamba2-1.2b and whisper-tiny (with the batch's frames) in
  float32, from the reference's parameters perturbed with numpy noise
  (its init hides errors: RWKV-6's ``bonus_u`` is 0, its mix factors
  0.5, every norm scale 1), each leaf within 1e-4 rel_rms (measured: at
  most 1.2e-6, 1.3e-6, 1.4e-5, 2.6e-6 and 1.2e-6).
* 3 ``make_train_step`` steps (accum 1 and 2) against the reference's
  jitted step on the same five models in float32: losses within 1e-5
  relative, parameters within max-abs 4e-5. That is twice the sum of the
  first three learning rates (3e-6, 6e-6, 9e-6): Adam's first steps move
  a weight by about its learning rate whatever the gradient's size, so a
  gradient near zero whose sign differs between the two frameworks moves
  the weight by up to twice that. Measured: 3.0e-8 to 1.4e-7, the losses
  within 1.7e-7.
* Every ``remat`` mode bitwise equal to ``"none"`` (loss, grad norm,
  parameters after two steps).
* The kernel switches on CPU tensors: the plain versions, whose gradients
  equal the no-switch route's.
* The reference's contracts rerun on the port: the six of
  ``tests/test_optimizer_data.py`` that are not about sharding rules
  (``tests/test_torch_runtime.py`` holds that one), and
  ``tests/test_models_smoke.py``'s ``test_reduced_train_step`` for every
  arch of the registry (the ``vlm`` family's pixtral-12b included) and
  ``test_vocab_parallel_xent_matches_naive``.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import ARCHS as JARCHS
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.models import moe as JMOE
from repro.models import transformer as JT
from repro.train import compression as JC
from repro.train import data as JD
from repro.train import optimizer as JO
from repro.train import step as JS
from repro_torch import convert
from repro_torch.configs import ARCHS
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import prng
from repro_torch.models import lm
from repro_torch.models import moe as TMOE
from repro_torch.models import transformer as TT
from repro_torch.train import compression as TC
from repro_torch.train import data as TD
from repro_torch.train import optimizer as TO
from repro_torch.train import step as TS

jax.config.update("jax_threefry_partitionable", True)
torch.set_num_threads(1)   # small tensors: threads only contend

MODELS = ("qwen2-0.5b", "moonshot-v1-16b-a3b", "rwkv6-3b", "zamba2-1.2b",
          "whisper-tiny")
TRAIN_ARCHS = sorted(ARCHS)
CPU = torch.device("cpu")


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want),
                                                        1e-30)))


def _rel_scale(got, want) -> float:
    """Largest |Δ| over the largest |want|: relative to the leaf's scale
    (an elementwise ratio blows up where ``b1·m + (1 − b1)·g`` cancels)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


def _rel_rms(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = np.sqrt(np.mean(want ** 2))
    return float(np.sqrt(np.mean((got - want) ** 2)) / max(den, 1e-30))


def _f32(arch: str):
    return (dataclasses.replace(JARCHS[arch].reduced(), dtype="float32"),
            dataclasses.replace(ARCHS[arch].reduced(), dtype="float32"))


def _perturbed_params(jcfg, seed: int = 0):
    """The reference's init tree with numpy noise on every leaf (0.02 ×
    N(0, 1), the matrices' init scale), as numpy float32."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, JS.init_params(jax.random.PRNGKey(seed),
                                                   jcfg))
    return jax.tree.map(
        lambda a: (a + 0.02 * rng.standard_normal(a.shape)).astype(
            np.float32), tree)


def _both_params(arch: str, seed: int = 0):
    jcfg, tcfg = _f32(arch)
    tree = _perturbed_params(jcfg, seed)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            convert.lm_params(tree, tcfg, dtype=torch.float32))


def _batch(jcfg, seed: int = 0, step: int = 0, b: int = 4, s: int = 32):
    jb = JD.make_batch_fn(jcfg, JShapeSpec("t", s, b, "train"),
                          seed=seed)(step)
    return jb, {k: _t(v) for k, v in jb.items()}


# ----------------------------------------------------------------- AdamW


def _opt_tree(rng):
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "b": {"z": rng.standard_normal((5,)).astype(np.float32),
                  "a": rng.standard_normal((2, 3, 4)).astype(np.float32)}}


def test_adamw_update_matches_reference():
    rng = np.random.default_rng(7)
    tree = _opt_tree(rng)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = TO.tree_map(_t, tree)
    js, ts = JO.init(jp), TO.init(tp)
    for _ in range(5):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            np.float32) * 3.0, tree)
        jp, js, jn = JO.update(jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts, tn = TO.update(tp, TO.tree_map(_t, g), ts)
        assert _rel(tn, jn) <= 1e-6
    assert ts.step.dtype == torch.int32 and int(ts.step) == int(js.step) == 5
    for want, got in ((jp, tp), (js.m, ts.m), (js.v, ts.v)):
        for a, b in zip(jax.tree.leaves(want), TO.leaves(got)):
            assert b.dtype == torch.float32
            assert _rel_scale(b.numpy(), a) <= 1e-6


def test_adamw_update_keeps_bfloat16_leaves():
    """A bfloat16 leaf (the port's ``init_lm`` stores matrices so) updates
    in float32 and is stored back rounded, as the reference updates one:
    within one bfloat16 step of the reference's. ``launch.train`` keeps
    float32 parameters instead, as the reference's ``init_params`` does:
    at the first steps' learning rates (3e-6 × step) an update is below
    half a bfloat16 step of most weights and would be lost."""
    rng = np.random.default_rng(11)
    tree = {"w": rng.standard_normal((8, 16)).astype(np.float32)}
    jp = {"w": jnp.asarray(tree["w"], jnp.bfloat16)}
    tp = {"w": _t(tree["w"]).bfloat16()}
    js, ts = JO.init(jp), TO.init(tp)
    for _ in range(3):
        g = rng.standard_normal((8, 16)).astype(np.float32)
        jp, js, _ = JO.update(jp, {"w": jnp.asarray(g, jnp.bfloat16)}, js,
                              lr=1e-2)
        tp, ts, _ = TO.update(tp, {"w": _t(g).bfloat16()}, ts, lr=1e-2)
    assert tp["w"].dtype == torch.bfloat16
    want = np.asarray(jp["w"]).astype(np.float32)
    got = tp["w"].float().numpy()
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=0)
    assert _rel_scale(ts.m["w"].numpy(), js.m["w"]) <= 1e-6


def test_cosine_lr_matches_reference():
    steps = np.array([0, 1, 2, 50, 99, 100, 101, 4000, 9999, 10_000,
                      20_000], np.int32)
    want = np.asarray(JO.cosine_lr(jnp.asarray(steps)))
    got = TO.cosine_lr(torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32 and _rel(got, want) <= 1e-6


@pytest.mark.parametrize("scale", [1e-3, 100.0])
def test_clip_by_global_norm_matches_reference(scale):
    tree = _opt_tree(np.random.default_rng(3))
    tree = jax.tree.map(lambda a: a * scale, tree)
    jc, jn = JO.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), 1.0)
    tc, tn = TO.clip_by_global_norm(TO.tree_map(_t, tree), 1.0)
    assert _rel(tn, jn) <= 1e-6
    assert _rel(TO.global_norm(tc), JO.global_norm(jc)) <= 1e-6
    for a, b in zip(jax.tree.leaves(jc), TO.leaves(tc)):
        assert _rel(b.numpy(), a) <= 1e-6


# ----------------------------------------------------------- compression


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_matches_reference(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((257,)) * 10 ** rng.uniform(-3, 3)).astype(
        np.float32)
    jc, jerr = JC.compress(jnp.asarray(x))
    tc, terr = TC.compress(_t(x))
    np.testing.assert_array_equal(tc.q.numpy(), np.asarray(jc.q))
    assert tc.q.dtype == torch.int8
    assert float(tc.scale) == float(jc.scale)
    np.testing.assert_allclose(terr.numpy(), np.asarray(jerr), rtol=0,
                               atol=float(jc.scale) * 1e-6)
    np.testing.assert_array_equal(TC.decompress(tc).numpy(),
                                  np.asarray(JC.decompress(jc)))
    tree = {"a": x, "b": {"c": x[:10] * 3}}
    resid = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.01)
                         .astype(np.float32), tree)
    jg, jr = JC.compress_tree(jax.tree.map(jnp.asarray, tree),
                              jax.tree.map(jnp.asarray, resid))
    tg, tr = TC.compress_tree(TO.tree_map(_t, tree), TO.tree_map(_t, resid))
    for a, b in zip(jax.tree.leaves(jg), TO.leaves(tg)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=0)
    for a, b in zip(jax.tree.leaves(jr), TO.leaves(tr)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-6 * float(np.max(np.abs(x))))
    z = TC.zeros_like_residuals(TO.tree_map(_t, tree))
    assert all(t.dtype == torch.float32 and not t.any() for t in
               TO.leaves(z))


# ------------------------------------------------------------------ data


@pytest.mark.parametrize("seed", [0, 3, 2024])
def test_batches_bitwise_equal_to_reference(seed, monkeypatch):
    cfg, jcfg = ARCHS["qwen2-0.5b"].reduced(), JARCHS["qwen2-0.5b"].reduced()
    t_fn = TD.make_batch_fn(cfg, ShapeSpec("t", 64, 4, "train"), seed=seed,
                            device="cpu")
    j_fn = JD.make_batch_fn(jcfg, JShapeSpec("t", 64, 4, "train"),
                            seed=seed)
    for step in (0, 1, 37):
        jb, tb = j_fn(step), t_fn(step)
        for k in ("tokens", "labels"):
            assert tb[k].dtype == torch.int32 and tb[k].shape == (4, 64)
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    # the published vocabulary, and the noise drawn 7 rows at a time
    monkeypatch.setattr(prng, "_GUMBEL_BLOCK", 7 * 151_936)
    for step in (0, 5):
        want = JD._gen(seed, step, batch=2, seq=20, vocab=151_936)
        got = TD._gen(seed, step, batch=2, seq=20, vocab=151_936,
                      device=CPU)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_unported_families_raise():
    """Every family trains now: the hybrid and the vlm family (the last
    one ported) take a step on the CPU, and an unknown family is
    refused."""
    for arch in ("zamba2-1.2b", "pixtral-12b"):
        cfg = ARCHS[arch].reduced()
        params = TO.tree_map(lambda x: x.float(),
                             TS.init_params(cfg, seed=0, device="cpu"))
        batch = TD.make_batch_fn(cfg, ShapeSpec("t", 32, 2, "train"),
                                 device="cpu")(0)
        opt = TO.init(params)
        params, opt, m = TS.make_train_step(cfg, remat="none")(params, opt,
                                                               batch)
        assert math.isfinite(float(m["loss"])) and int(opt.step) == 1
    with pytest.raises(ValueError, match="unknown"):
        TS.model_loss({}, {}, dataclasses.replace(
            ARCHS["pixtral-12b"].reduced(), family="unknown"))


# ---------------------------------------------------------------- losses


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "moonshot-v1-16b-a3b"])
def test_losses_match_reference(arch):
    jcfg, tcfg, jp, tp = _both_params(arch)
    jb, tb = _batch(jcfg)
    want = JT.loss_fn(jp, jb["tokens"], jb["labels"], jcfg, remat="none")
    got = TT.loss_fn(tp, tb["tokens"], tb["labels"], tcfg, remat="none")
    assert _rel(float(got), float(want)) <= 1e-5
    jh = JT.forward(jp, jb["tokens"], jcfg, return_hidden=True)
    th = TT.forward(tp, tb["tokens"], tcfg, return_hidden=True)
    want = JT.vocab_parallel_xent(jh, jp, jb["labels"], jcfg)
    got = TT.vocab_parallel_xent(th, tp, tb["labels"], tcfg)
    assert _rel(float(got), float(want)) <= 1e-5
    np.testing.assert_allclose(
        TT.unembed_matrix(tp, tcfg, torch.float32).numpy(),
        np.asarray(JT.unembed_matrix(jp, jcfg, jnp.float32)), rtol=0,
        atol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_aux_load_balance_loss_matches_reference(seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((96, 8)).astype(np.float32) * 2
    idx = np.argsort(-logits, axis=1)[:, :2].astype(np.int32)
    want = JMOE.aux_load_balance_loss(jnp.asarray(logits), jnp.asarray(idx),
                                      8, 2)
    got = TMOE.aux_load_balance_loss(_t(logits), _t(idx), 8, 2)
    assert _rel(float(got), float(want)) <= 1e-5


# ------------------------------------------------------- gradients, steps


@pytest.mark.parametrize("arch", MODELS)
def test_model_loss_gradients_match_reference(arch):
    jcfg, tcfg, jp, tp = _both_params(arch)
    jb, tb = _batch(jcfg)
    jl, jg = jax.value_and_grad(
        lambda p: JS.model_loss(p, jb, jcfg, remat="none"))(jp)
    alias = TO.tree_map(lambda x: x.detach().requires_grad_(), tp)
    tl = TS.model_loss(alias, tb, tcfg, remat="none")
    tg = torch.autograd.grad(tl, TO.leaves(alias))
    assert _rel(float(tl.detach()), float(jl)) <= 1e-5
    jflat = lm.flatten(jg)
    for (path, _), g in zip(sorted(lm.flatten(tp).items()), tg):
        want = np.asarray(jflat[path])
        if np.any(want):
            assert _rel_rms(g.numpy(), want) <= 1e-4, path
        else:
            assert not g.any(), path


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", MODELS)
def test_train_steps_match_reference(arch, accum):
    jcfg, tcfg, jp, tp = _both_params(arch)
    jb, tb = _batch(jcfg)
    jstep = jax.jit(JS.make_train_step(jcfg, remat="none", accum=accum))
    tstep = TS.make_train_step(tcfg, remat="none", accum=accum)
    jo, to = JO.init(jp), TO.init(tp)
    for _ in range(3):
        jp, jo, jm = jstep(jp, jo, jb)
        tp, to, tm = tstep(tp, to, tb)
        assert tm["loss"].dim() == 0 and tm["grad_norm"].dim() == 0
        assert _rel(float(tm["loss"]), float(jm["loss"])) <= 1e-5
    jflat = lm.flatten(jp)
    for path, x in lm.flatten(tp).items():
        np.testing.assert_allclose(x.numpy(), np.asarray(jflat[path]),
                                   rtol=0, atol=4e-5, err_msg=path)
    assert int(to.step) == int(jo.step) == 3


@pytest.mark.parametrize("arch", MODELS)
def test_remat_modes_bitwise_equal(arch):
    cfg = ARCHS[arch].reduced()
    params = TO.tree_map(lambda x: x.float(),
                         TS.init_params(cfg, seed=1, device="cpu"))
    batch = TD.make_batch_fn(cfg, ShapeSpec("t", 32, 2, "train"),
                             device="cpu")(0)
    runs = {}
    for remat in ("none", "full", "dots"):
        p = TO.tree_map(lambda x: x.clone(), params)
        o = TO.init(p)
        step = TS.make_train_step(cfg, remat=remat)
        for _ in range(2):
            p, o, m = step(p, o, batch)
        runs[remat] = (m, TO.leaves(p))
    for remat in ("full", "dots"):
        m, leaves = runs[remat]
        assert torch.equal(m["loss"], runs["none"][0]["loss"]), remat
        assert torch.equal(m["grad_norm"], runs["none"][0]["grad_norm"])
        assert all(torch.equal(a, b) for a, b in
                   zip(leaves, runs["none"][1])), remat
    with pytest.raises(ValueError, match="remat"):
        TS.model_loss(params, batch, cfg, remat="everything")


@pytest.mark.parametrize("arch", MODELS)
def test_kernel_switches_on_cpu_give_the_plain_gradients(arch):
    """On CPU tensors ``use_flash``/``use_moe_kernel``/``use_kernel`` run
    the kernels' plain versions, which autograd differentiates: the loss
    and every gradient equal the no-switch route's (the same float32
    operations)."""
    jcfg, tcfg, _, tp = _both_params(arch)
    _, tb = _batch(jcfg)
    out = []
    for on in (False, True):
        alias = TO.tree_map(lambda x: x.detach().requires_grad_(), tp)
        loss = TS.model_loss(alias, tb, tcfg, remat="none", use_flash=on,
                             use_moe_kernel=on, use_kernel=on)
        out.append((loss, torch.autograd.grad(loss, TO.leaves(alias))))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    assert any(g.any() for g in g1)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-9)


# ------------------------------------- the reference's contracts, rerun


def test_adamw_minimizes_quadratic():
    params = {"w": torch.tensor([5.0, -3.0, 2.0])}
    opt = TO.init(params)
    for _ in range(200):
        grads = TO.tree_map(lambda p: 2 * p, params)
        params, opt, _ = TO.update(params, grads, opt, lr=0.1,
                                   weight_decay=0.0)
    assert float(torch.sum(torch.square(params["w"]))) < 1e-2


def test_grad_clip_bounds_norm():
    g = {"a": torch.full((10,), 100.0)}
    clipped, norm = TO.clip_by_global_norm(g, 1.0)
    assert float(norm) > 1.0
    assert float(TO.global_norm(clipped)) <= 1.0 + 1e-5


def test_cosine_schedule_shape():
    lr0 = float(TO.cosine_lr(torch.tensor(0, dtype=torch.int32)))
    lr_peak = float(TO.cosine_lr(torch.tensor(100, dtype=torch.int32)))
    lr_end = float(TO.cosine_lr(torch.tensor(10_000, dtype=torch.int32)))
    assert lr0 < lr_peak
    assert lr_end < lr_peak


def test_data_determinism_and_shapes():
    cfg = ARCHS["qwen2-0.5b"].reduced()
    fn = TD.make_batch_fn(cfg, ShapeSpec("t", 64, 4, "train"), seed=3,
                          device="cpu")
    b1, b2 = fn(5), fn(5)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert b1["tokens"].shape == (4, 64)
    b3 = fn(6)
    assert not torch.equal(b1["tokens"], b3["tokens"])
    assert int(b1["tokens"].max()) < cfg.vocab_size


@given(st.integers(min_value=0, max_value=1000))
@settings(max_examples=10, deadline=None)
def test_int8_compression_error_bounded(seed):
    x = prng.normal(prng.PRNGKey(seed), (128,)) * 10
    c, err = TC.compress(x)
    xhat = TC.decompress(c)
    # max quantization error is scale/2 per element
    assert float(torch.max(torch.abs(x - xhat))) <= float(c.scale) * 0.5 \
        + 1e-6
    np.testing.assert_allclose(err.numpy(), (x - xhat).numpy(), atol=1e-6)


def test_error_feedback_preserves_sum():
    """With EF, the accumulated applied signal tracks the true signal."""
    g = {"w": prng.normal(prng.PRNGKey(0), (64,))}
    resid = TC.zeros_like_residuals(g)
    applied = torch.zeros((64,))
    total = torch.zeros((64,))
    for i in range(50):
        gi = TO.tree_map(lambda x: x * (1.0 + 0.1 * torch.sin(i * x)), g)
        ghat, resid = TC.compress_tree(gi, resid)
        applied = applied + ghat["w"]
        total = total + gi["w"]
    # residual is bounded -> applied ≈ total
    err = float(torch.max(torch.abs(applied - total)))
    assert err <= float(torch.max(torch.abs(resid["w"]))) + 1e-4


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_reduced_train_step(arch):
    cfg = ARCHS[arch].reduced()
    params = TO.tree_map(lambda x: x.float(),
                         TS.init_params(cfg, seed=0, device="cpu"))
    opt = TO.init(params)
    batch = TD.make_batch_fn(cfg, ShapeSpec("t", 32, 2, "train"),
                             device="cpu")(0)
    step = TS.make_train_step(cfg, remat="none")
    params, opt, metrics = step(params, opt, batch)
    loss = float(metrics["loss"])
    assert math.isfinite(loss), arch
    # a single step on random data should land near ln(vocab)
    assert 0.2 * math.log(cfg.vocab_size) < loss < 3 * math.log(
        cfg.vocab_size)
    # params stay finite
    assert all(bool(torch.isfinite(x.float()).all())
               for x in TO.leaves(params)), arch


def test_vocab_parallel_xent_matches_naive():
    cfg = ARCHS["qwen2-0.5b"].reduced()
    params = TS.init_params(cfg, seed=0, device="cpu")
    b = TD.make_batch_fn(cfg, ShapeSpec("t", 32, 2, "train"),
                         device="cpu")(0)
    l1 = float(TS.model_loss(params, b, cfg, remat="none"))
    l2 = float(TS.model_loss(params, b, cfg, remat="none",
                             vocab_parallel=True))
    assert abs(l1 - l2) < 1e-3

"""The port's Algorithm 1 (``repro_torch.core.asa``) against the
reference's, on the CPU.

Sampled actions, PRNG keys, integer counters and ``log_p`` must be
identical call for call: the port's logsumexp, exp and log are XLA's
float32 ones bit for bit (``core.xla_f32``), and its multiply-adds round
where the reference's jitted programs round. So a MAP read
(``argmax log_p``) breaks an exact tie as the reference does, and the
greedy reads are equal everywhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import asa as jasa
from repro.core.bins import make_bins
from repro.core.losses import zero_one as j_zero_one
from repro.xsim import policies as jpolicies
from repro_torch import convert
from repro_torch.core import asa as tasa
from repro_torch.core import losses as tlosses
from repro_torch.core import prng
from repro_torch.xsim import policies as tpolicies

jax.config.update("jax_threefry_partitionable", True)
torch.set_num_threads(1)   # small tensors: threads only contend

B = 16
BINS = make_bins(53).astype(np.float32)


def _assert_state(t: tasa.ASAState, j) -> None:
    j = convert.asa_state(jax.tree.map(np.asarray, j))
    np.testing.assert_array_equal(t.key.numpy(), j.key.numpy())
    np.testing.assert_array_equal(t.t.numpy(), j.t.numpy())
    np.testing.assert_array_equal(t.rounds.numpy(), j.rounds.numpy())
    np.testing.assert_array_equal(t.round_loss.numpy(), j.round_loss.numpy())
    np.testing.assert_array_equal(t.log_p.numpy(), j.log_p.numpy())


def _fleets():
    js = jasa.init_batch(53, B, jax.random.PRNGKey(5))
    ts = tasa.init_batch(53, B, prng.PRNGKey(5))
    _assert_state(ts, js)
    return js, ts




@pytest.mark.parametrize("greedy", [False, True, "mixed"])
def test_learn_and_sample_sequence_matches(greedy):
    """300 rounds of (learn_wait_if, sample_wait_if) with random masks:
    identical sampled and greedy (MAP) draws, keys and ``log_p`` in every
    lane, every round. Random waits keep many bins exactly tied at the
    top (358 of about 2400 greedy reads flipped while the port's
    logsumexp rounded as torch does); none flips now."""
    rng = np.random.default_rng(1)
    js, ts = _fleets()
    jb, tb = jnp.asarray(BINS), torch.as_tensor(BINS)
    if greedy == "mixed":
        g_np = rng.random(B) < 0.5
        jg, tg = jnp.asarray(g_np), torch.as_tensor(g_np)
    else:
        jg = tg = greedy
    learn = jax.jit(jax.vmap(lambda s, w, d: jasa.learn_wait_if(s, jb, w, d)))
    if greedy == "mixed":
        draw = jax.jit(jax.vmap(
            lambda s, d, g: jasa.sample_wait_if(s, jb, d, g)))
    else:
        draw = jax.jit(jax.vmap(
            lambda s, d, g: jasa.sample_wait_if(s, jb, d, greedy),
            in_axes=(0, 0, None)))
    for _ in range(300):
        w = rng.exponential(2000.0, B).astype(np.float32)
        d = rng.random(B) < 0.7
        js = learn(js, w, d)
        ts = tasa.learn_wait_if(ts, tb, torch.as_tensor(w),
                                torch.as_tensor(d))
        d2 = rng.random(B) < 0.5
        js, ja = draw(js, d2, jg)
        ts, ta = tasa.sample_wait_if(ts, tb, torch.as_tensor(d2), tg)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        _assert_state(ts, js)


@pytest.mark.parametrize("policy", ["default", "greedy", "tuned"])
def test_step_policies_match(policy):
    rng = np.random.default_rng(2)
    js, ts = _fleets()
    g = 0.7
    fn = jax.jit(jax.vmap(lambda s, lv: jasa.step(s, lv, jnp.float32(g),
                                                  policy=policy)))
    for _ in range(60):
        lv = (rng.random((B, 53)) < 0.3).astype(np.float32)
        js, ja = fn(js, lv)
        ts, ta = tasa.step(ts, torch.as_tensor(lv), g, policy=policy)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    _assert_state(ts, js)


def test_posterior_reads_match():
    js, ts = _fleets()
    rng = np.random.default_rng(3)
    fn = jax.jit(jax.vmap(lambda s, lv: jasa.step(
        s, lv, jnp.float32(1.0), policy="tuned")))
    for _ in range(10):
        lv = (rng.random((B, 53)) < 0.5).astype(np.float32)
        js, _ = fn(js, lv)
        ts, _ = tasa.step(ts, torch.as_tensor(lv), 1.0, policy="tuned")
    jb, tb = jnp.asarray(BINS), torch.as_tensor(BINS)
    ref = np.asarray(jax.vmap(lambda s: jasa.posterior_features(s, jb))(js))
    got = tasa.posterior_features(ts, tb).numpy()
    np.testing.assert_array_equal(got[:, 0], ref[:, 0])
    np.testing.assert_allclose(got[:, 1:], ref[:, 1:], rtol=1e-4, atol=1e-4)


def test_zero_one_loss_matches():
    rng = np.random.default_rng(4)
    w = rng.exponential(3000.0, 2000).astype(np.float32)
    ref = np.asarray(jax.vmap(lambda x: j_zero_one(jnp.asarray(BINS), x))(w))
    got = tlosses.zero_one(torch.as_tensor(BINS), torch.as_tensor(w))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_fleet_update_and_scenario_estimators_match():
    """init_fleet → update_fleet (tuned steps, masked) → per-scenario
    slices with folded keys: the xsim policies' estimator plumbing."""
    rng = np.random.default_rng(5)
    jf = jpolicies.init_fleet(6)
    tf = tpolicies.init_fleet(6, device="cpu")
    _assert_state(tf, jf)
    w = rng.exponential(2000.0, (6, 8)).astype(np.float32)
    v = rng.random((6, 8)) < 0.8
    jf = jpolicies.update_fleet(jf, jnp.asarray(w), jnp.asarray(v))
    tf = tpolicies.update_fleet(tf, torch.as_tensor(w), torch.as_tensor(v))
    _assert_state(tf, jf)
    geo = np.repeat(np.arange(6), 5)
    je = jpolicies.scenario_estimators(jf, jnp.asarray(geo), 7)
    te = tpolicies.scenario_estimators(tf, torch.as_tensor(geo), 7)
    _assert_state(te, je)


@pytest.mark.parametrize("policy", ["default", "tuned"])
def test_fig5_convergence_matches(policy):
    """The Fig.-5 run (T=1000, seed 3, the step-changing truth of the
    reference): identical hits, rounds and regret; the posterior-mean
    estimate within 1e-5 relative (measured 1.4e-6)."""
    from repro.core import convergence as jconv
    from repro_torch.core import convergence as tconv

    ref = jconv.simulate(policy, T=1000, seed=3)
    got = tconv.simulate(policy, T=1000, seed=3,
                         truth=np.array(ref.true_wait), device="cpu")
    np.testing.assert_array_equal(got.hit, ref.hit)
    np.testing.assert_array_equal(got.rounds, ref.rounds)
    np.testing.assert_array_equal(got.regret, ref.regret)
    np.testing.assert_allclose(got.expected, ref.expected, rtol=1e-5)
    # the port's own truth schedule: same draws, log/exp rounding apart
    own = tconv.default_truth_schedule(prng.split(prng.PRNGKey(3))[0], 1000)
    np.testing.assert_allclose(own.numpy(), ref.true_wait, rtol=1e-5)


def test_fig5_greedy_follows_reference_until_a_near_tie():
    """The greedy policy acts on argmax log_p, so one tie broken another
    way changes its whole later trajectory. Stepped in lockstep with the
    reference on the Fig.-5 truth, the port takes the same action and
    holds the same state at every one of the 1000 iterations (while its
    logsumexp rounded as torch does, the first flip came at 681)."""
    from repro.core import convergence as jconv

    truth = np.array(jconv.simulate("greedy", T=1000, seed=3).true_wait)
    jb, tb = jnp.asarray(BINS), torch.as_tensor(BINS)
    js = jasa.init(53, jax.random.PRNGKey(0))
    ts = tasa.init(53, prng.PRNGKey(0))
    jstep = jax.jit(lambda s, w: jasa.step(
        s, j_zero_one(jb, w), jnp.float32(1.0), policy="greedy"))
    for i, w in enumerate(truth):
        js, ja = jstep(js, w)
        ts, ta = tasa.step(ts, tlosses.zero_one(tb, torch.tensor(w)), 1.0,
                           policy="greedy")
        assert int(ta) == int(ja), i
        _assert_state(ts, js)


# t from 0 to 10**6 (every t below 5000, then 20000 drawn), m from 2 to 53
GAMMA_T = np.unique(np.concatenate([
    np.arange(5000), np.random.default_rng(27).integers(0, 10 ** 6, 20000),
    [10 ** 6]])).astype(np.int32)


@pytest.mark.parametrize("scale", [1.0, 0.5, 0.37])
def test_gamma_schedules_bitwise_equal_reference(scale):
    """``gamma_sqrt`` bitwise the reference's over t in [0, 10**6] and m in
    [2, 53] (ln m as XLA's CPU backend rounds it, the root correctly
    rounded); ``gamma_constant`` a float32 0-d tensor of its value."""
    for m in range(2, 54):
        want = np.asarray(jasa.gamma_sqrt(jnp.asarray(GAMMA_T), m, scale))
        got = tasa.gamma_sqrt(torch.from_numpy(GAMMA_T), m, scale)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"m={m}")
        # a Python int t gives the 0-d value of the same element
        assert float(tasa.gamma_sqrt(7, m, scale)) == float(want[7])
    for t in (0, torch.tensor(5, dtype=torch.int32)):
        got = tasa.gamma_constant(t, scale)
        want = np.asarray(jasa.gamma_constant(jnp.int32(0), scale))
        assert got.dtype == torch.float32 and got.dim() == 0
        assert got.numpy().tobytes() == want.tobytes()

"""The learned submission policy (``repro_torch.rl``) on the CPU.

Two parts.

* The contracts of ``tests/test_rl.py`` other than training (its
  acceptance run is ``tests/test_torch_rl_train.py``), rerun on the port's
  own runs: the posterior features, the observation's shape and ranges,
  the head's shapes and log-probabilities, a peaked head's samples, the
  chain hook recording and steering, RL rows without a dependency edge,
  ``run_grid``'s refusals, ``params`` invisible to other policies, and
  the REINFORCE direction.
* Parity with ``repro.rl`` on the same inputs (reference-built states
  carried across with ``repro_torch.convert``, the reference's weights
  with ``convert.policy_params``): ``observe`` within ``OBS_ATOL`` or
  ``OBS_RTOL``; ``logits`` within ``HEAD_RTOL`` of each row's largest
|logit| and ``log_prob`` within ``HEAD_RTOL`` relative; greedy
  and sampled actions equal wherever the reference's top-two gap exceeds
  ``NEAR_TIE``; ``reinforce_step`` within ``STEP_RTOL``; ``run_grid`` of
  policies 2, 3 and 4 under ``clean`` and ``faulty`` in both
  ``rl_mode``s with every integer and event field exact (``rl_act`` and
  the estimator's key among them), ``rl_obs`` within ``OBS_RTOL`` and the
  other floats within ``test_torch_xsim``'s tolerances; ``collect``'s
  rewards within ``REWARD_RTOL``. Measured worst cases: ``observe``
  3.6e-7 absolute and 5.2e-7 relative (the posterior entropy), the
  sweeps' ``rl_obs`` 7.2e-7, no action flip here or in any sweep (the
  smallest top-two gap of the 512 greedy reads is 2.9e-4).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import asa as jasa
from repro.core.bins import make_bins
from repro.rl import features as JF
from repro.rl import policy as JP
from repro.rl import rollout as jrollout
from repro.rl import train as JT
from repro.xsim import compare as jcompare
from repro.xsim import events as jevents
from repro.xsim import families as jfamilies
from repro.xsim import grid as jgrid
from repro.xsim import policies as jpolicies
from repro.xsim import state as X
from repro.xsim.state import add_job, empty_table, freeze
from repro_torch import convert
from repro_torch.core import asa, prng
from repro_torch.rl import features as F
from repro_torch.rl import policy as P
from repro_torch.rl import rollout
from repro_torch.rl import train as T
from repro_torch.sched.workflows import STATISTICS
from repro_torch.xsim import events as tevents
from repro_torch.xsim import grid as tgrid
from repro_torch.xsim import policies as tpolicies
from repro_torch.xsim import state as S
from test_torch_xsim import CFG_KW, METRIC_RTOL, _compare_states, _rel

jax.config.update("jax_threefry_partitionable", True)
torch.set_num_threads(1)   # small tensors: threads only contend

CPU = "cpu"
BINS = torch.as_tensor(make_bins(53), dtype=torch.float32)
TINY_SIM = tgrid.XSimConfig(**CFG_KW)
OBS_ATOL, OBS_RTOL = 1e-6, 1e-5
HEAD_RTOL = 1e-6
STEP_RTOL = 1e-5
REWARD_RTOL = 1e-5
NEAR_TIE = 1e-4


def _params(p) -> P.PolicyParams:
    """The reference's weights as the port's."""
    return convert.policy_params(jax.tree.map(np.asarray, p))


def _port(ref_state):
    return convert.scenario_state(jax.tree.map(np.asarray, ref_state))


def _rl_scenario(seed=0):
    """A bare machine and one RL-policy statistics workflow (the port's
    ``freeze``)."""
    t = S.empty_table(32)
    tpolicies.add_workflow(t, 0, STATISTICS, 8, X.RL, t0=100.0)
    return S.freeze(t, total_cores=64.0, free_cores=64.0, policy=X.RL,
                    t0=100.0, est=asa.init(53, prng.PRNGKey(seed)),
                    device=CPU)


# ------------------------------------------------- the contracts, rerun
def test_posterior_features():
    st = asa.init(53, prng.PRNGKey(0))
    mw, ew, ent = asa.posterior_features(st, BINS).numpy()
    assert mw == pytest.approx(float(BINS[0]))      # uniform: argmax = bin 0
    assert ew == pytest.approx(float(BINS.mean()), rel=1e-5)
    assert ent == pytest.approx(np.log(53), rel=1e-5)


def test_observe_shape_and_ranges():
    s = _rl_scenario()
    zero = torch.zeros(1, dtype=torch.int32)
    obs = F.observe(s, zero, zero, torch.full((1,), -np.inf),
                    torch.full((1,), 100.0), BINS)
    assert obs.shape == (1, F.N_FEATURES) and obs.dtype == torch.float32
    assert len(F.FEATURE_NAMES) == F.N_FEATURES
    o = obs[0].numpy()
    assert np.all(np.isfinite(o))
    assert o[0] == 1.0                        # bias
    assert o[1] == pytest.approx(1.0)         # empty machine: all free
    assert o[8] == 0.0                        # no predecessor: eta = 0
    assert 0.0 <= o[11] <= 1.0 + 1e-6         # normalized entropy


def test_policy_head_shapes_and_logprob():
    params = P.init_params(prng.PRNGKey(1), hidden=16, device=CPU)
    obs = prng.normal(prng.PRNGKey(2), (5, F.N_FEATURES))
    lg = P.logits(params, obs)
    assert lg.shape == (5, X.M_BINS)
    a = P.act_greedy(params, obs)
    np.testing.assert_array_equal(a.numpy(), np.argmax(lg.numpy(), axis=-1))
    lp = P.log_prob(params, obs, a)
    ref = torch.log_softmax(lg, dim=-1).numpy()
    np.testing.assert_allclose(lp.numpy(), ref[np.arange(5), a.numpy()],
                               rtol=1e-6)
    np.testing.assert_allclose(np.exp(ref).sum(-1), 1.0, rtol=1e-5)
    assert P.n_params(params) == F.N_FEATURES * 16 + 16 + 16 * 53 + 53


def test_act_sample_follows_distribution():
    """A strongly peaked head samples its peak almost always."""
    params = P.init_params(prng.PRNGKey(0), hidden=8, device=CPU)
    params = params._replace(b2=params.b2.clone().index_fill_(0,
                             torch.tensor([17]), 50.0),
                             w2=torch.zeros_like(params.w2),
                             w1=torch.zeros_like(params.w1))
    obs = torch.zeros(F.N_FEATURES)
    keys = prng.split(prng.PRNGKey(3), 64)
    acts = P.act_sample(params, obs, keys)
    assert acts.shape == (64,) and bool((acts == 17).all())


def test_chain_hook_records_and_steers():
    """The RL branch records one (obs, action) per stage and its chosen
    bin is the lead actually applied: successor submitted at
    max(admission, E_y − bins[a_{y+1}])."""
    params = P.init_params(prng.PRNGKey(4), device=CPU)
    s = _rl_scenario()
    fin = tevents.simulate(s, n_steps=120, naive=True, params=params,
                           rl_mode="greedy")
    n_stages = len(STATISTICS.stages)
    acts = fin.rl_act[0].numpy()
    assert np.all(acts[:n_stages] >= 0)          # every stage drew an action
    assert np.all(acts[n_stages:] == -1)         # padding slots untouched
    obs = fin.rl_obs[0].numpy()
    assert np.all(np.isfinite(obs[:n_stages]))
    assert np.all(obs[:n_stages, 0] == 1.0)      # bias feature present
    # the recorded bin IS the lead the cascade used (pred_wait entry)
    pw = fin.pred_wait[0].numpy()[:n_stages]
    np.testing.assert_allclose(pw, BINS.numpy()[acts[:n_stages]])
    ee = fin.expected_end[0].numpy()[:n_stages]
    sub = fin.submit[0].numpy()[:n_stages]
    for y in range(1, n_stages):
        lead = float(BINS[acts[y]])
        assert sub[y] >= ee[y - 1] - lead - 1e-3
    assert int(fin.est.t[0]) >= 2 * n_stages     # estimator learned


def test_rl_rows_have_no_dependency_edge():
    grid = tgrid.make_grid(TINY_SIM, workflows=("statistics",),
                           policy_ids=(X.RL,), n_seeds=1, device=CPU)
    states = grid.build(tpolicies.scenario_estimators(
        tpolicies.init_fleet(int(grid.geo_idx.max()) + 1, device=CPU),
        torch.as_tensor(grid.geo_idx)))
    deps = states.start_dep.numpy()
    rows = states.wf_rows.numpy()
    assert np.all(deps[states.is_wf.numpy()] == -1)
    nxt = states.wf_next.numpy()
    for b in range(grid.n):
        valid = rows[b][rows[b] >= 0]
        assert np.all(nxt[b][valid[:-1]] == valid[1:])
        assert nxt[b][valid[-1]] == -1


def test_run_grid_requires_params_for_rl():
    grid = tgrid.make_grid(TINY_SIM, workflows=("statistics",),
                           policy_ids=(X.RL,), n_seeds=1, device=CPU)
    with pytest.raises(ValueError, match="params"):
        tgrid.run_grid(grid, device=CPU)
    with pytest.raises(ValueError, match="rl_mode"):
        tgrid.run_grid(grid, params=P.init_params(prng.PRNGKey(0),
                                                  device=CPU),
                       rl_mode="bogus", device=CPU)


def test_params_threading_invisible_to_other_policies():
    """A params head threaded through a sweep of policies 0-3 changes no
    lane: the RL branch is selected per lane by policy id."""
    grid = tgrid.make_grid(TINY_SIM, workflows=("statistics", "montage"),
                           policy_ids=(0, 1, 2, 3), n_seeds=2, device=CPU)
    final_a, m_a = tgrid.run_grid(grid, pred_seed=5, device=CPU)
    final_b, m_b = tgrid.run_grid(
        grid, pred_seed=5, params=P.init_params(prng.PRNGKey(9), device=CPU),
        device=CPU)
    for k in m_a:
        assert torch.equal(m_a[k], m_b[k]), k
    a, b = convert.to_numpy(final_a), convert.to_numpy(final_b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_reinforce_step_moves_logprob_with_advantage():
    """After one update, actions with positive advantage gain log-prob
    and negative-advantage actions lose it (the REINFORCE direction); the
    update builds new tensors and leaves its inputs as they were."""
    params = P.init_params(prng.PRNGKey(7), hidden=16, device=CPU)
    before = [p.clone() for p in params]
    b, n_s = 6, 4
    obs = prng.normal(prng.PRNGKey(8), (b, n_s, F.N_FEATURES))
    act = torch.as_tensor(np.random.default_rng(9).integers(
        0, X.M_BINS, (b, n_s)), dtype=torch.int32)
    act[0, -1] = -1                                  # one masked slot
    reward = torch.tensor([3.0, 2.0, 1.0, -1.0, -2.0, -3.0])
    new, ent = T.reinforce_step(params, obs, act, reward, 0.1)
    assert float(ent) > 0.0
    assert all(torch.equal(p, q) for p, q in zip(params, before))
    assert all(not p.requires_grad for p in new)
    mask = act.numpy() >= 0
    lp_old = P.log_prob(params, obs, act.clamp_min(0)).numpy()
    lp_new = P.log_prob(new, obs, act.clamp_min(0)).numpy()
    d_ep = ((lp_new - lp_old) * mask).sum(-1)
    assert d_ep[0] > 0.0 and d_ep[-1] < 0.0


# ------------------------------------------------ parity with repro.rl
@functools.cache
def _reference_grid(family: str):
    cfg = jgrid.XSimConfig(**CFG_KW)
    grid = jfamilies.family_grid(cfg, family, n_seeds=1, shrink=1 / 64.0,
                                 policy_ids=(2, 3, 4))
    fleet = jpolicies.init_fleet(int(grid.geo_idx.max()) + 1)
    ests = jpolicies.scenario_estimators(fleet, jnp.asarray(grid.geo_idx), 1)
    return grid, grid.build(ests)


def _reference_head(seed: int = 4, hidden: int = JP.HIDDEN_DEFAULT):
    return JP.init_params(jax.random.PRNGKey(seed), hidden=hidden)


def _close(got: np.ndarray, want: np.ndarray, atol: float, rtol: float):
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def test_observe_matches_reference():
    """``observe`` on a reference-built state a little way into its
    sweep (queues, running jobs and learned posteriors), at every stage
    slot of every lane, against the reference's under ``vmap``."""
    grid, st = _reference_grid("clean")
    st = jevents.sweep(st, n_steps=12, params=_reference_head(),
                       naive=True, chunk_steps=0)
    got_s = _port(st)
    b, n_s = st.wf_rows.shape
    bins = jnp.asarray(BINS.numpy())
    rng = np.random.default_rng(0)
    pred = rng.uniform(-3600.0, 7200.0, (n_s, b)).astype(np.float32)
    pred[0] = -np.inf
    for y in range(n_s):
        stage = np.full(b, y, np.int32)
        row = np.clip(np.array(st.wf_rows[:, y]), 0, None)
        now = np.array(st.t)
        want = jax.vmap(JF.observe, in_axes=(0, 0, 0, 0, 0, None))(
            st, jnp.asarray(stage), jnp.asarray(row), jnp.asarray(pred[y]),
            jnp.asarray(now), bins)
        got = F.observe(got_s, torch.as_tensor(stage), torch.as_tensor(row),
                        torch.as_tensor(pred[y]), torch.as_tensor(now), BINS)
        _close(got.numpy(), np.asarray(want), OBS_ATOL, OBS_RTOL)


def test_logits_and_log_prob_match_reference():
    jp = _reference_head(11, hidden=24)
    tp = _params(jp)
    obs = np.random.default_rng(1).normal(
        size=(7, 9, F.N_FEATURES)).astype(np.float32)
    act = np.random.default_rng(2).integers(0, 53, (7, 9)).astype(np.int32)
    want_lg = np.asarray(JP.logits(jp, jnp.asarray(obs)))
    got_lg = P.logits(tp, torch.as_tensor(obs)).numpy()
    # logits cross zero: relative to each row's largest |logit|
    scale = np.abs(want_lg).max(axis=-1, keepdims=True)
    assert np.all(np.abs(got_lg - want_lg) <= HEAD_RTOL * scale)
    want_lp = np.asarray(JP.log_prob(jp, jnp.asarray(obs), jnp.asarray(act)))
    got_lp = P.log_prob(tp, torch.as_tensor(obs), torch.as_tensor(act))
    _close(got_lp.numpy(), want_lp, 0.0, HEAD_RTOL)


def _top2_gap(scores: np.ndarray) -> np.ndarray:
    part = np.sort(scores, axis=-1)
    return part[..., -1] - part[..., -2]


def test_actions_match_reference():
    """Greedy and sampled actions on the same keys: equal wherever the
    reference's top-two gap (of the logits, or of logits + Gumbel noise)
    exceeds ``NEAR_TIE``; flips are counted with their gaps."""
    jp = _reference_head(5)
    tp = _params(jp)
    n = 512
    obs = np.random.default_rng(3).normal(
        size=(n, F.N_FEATURES)).astype(np.float32)
    keys = np.random.default_rng(4).integers(
        0, 2 ** 32, (n, 2), dtype=np.uint64).astype(np.uint32)
    lg = np.asarray(JP.logits(jp, jnp.asarray(obs)))
    want_g = np.asarray(JP.act_greedy(jp, jnp.asarray(obs)))
    got_g = P.act_greedy(tp, torch.as_tensor(obs)).numpy()
    # per-lane keys, as in the fleet simulator (vmap), and one key for
    # the whole batch
    want_s = np.asarray(jax.vmap(JP.act_sample, in_axes=(None, 0, 0))(
        jp, jnp.asarray(obs), jnp.asarray(keys)))
    got_s = P.act_sample(tp, torch.as_tensor(obs),
                         convert.tensor(keys)).numpy()
    noise = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (53,)))(
        jnp.asarray(keys)))
    one = jnp.asarray(keys[0])
    want_1 = np.asarray(JP.act_sample(jp, jnp.asarray(obs), one))
    got_1 = P.act_sample(tp, torch.as_tensor(obs),
                         convert.tensor(keys[0])).numpy()
    noise_1 = np.asarray(jax.random.gumbel(one, (n, 53)))
    for got, want, scores in ((got_g, want_g, lg), (got_s, want_s, lg + noise),
                              (got_1, want_1, lg + noise_1)):
        far = _top2_gap(scores) > NEAR_TIE
        np.testing.assert_array_equal(got[far], want[far])
    assert len(set(got_s.tolist())) > 10      # sampling, not argmax


def test_reinforce_step_matches_reference():
    """One update on a recorded rollout's buffers (reference-built, 72
    RL lanes, masked slots among them): new params and the entropy within
    ``STEP_RTOL`` of the reference's."""
    grid, st = _reference_grid("clean")
    jp = _reference_head()
    fin = jevents.sweep(st, n_steps=grid.cfg.n_steps, params=jp, naive=True,
                        rl_mode="sample")
    reward = -np.asarray(jcompare.batched_metrics(fin)["twt_s"]) / 3600.0
    rl = np.asarray(grid.policies) == X.RL
    obs, act = np.asarray(fin.rl_obs)[rl], np.asarray(fin.rl_act)[rl]
    reward = reward[rl].astype(np.float32)
    assert (act < 0).any() and (act >= 0).any()
    want, want_ent = JT.reinforce_step(jp, jnp.asarray(obs), jnp.asarray(act),
                                       jnp.asarray(reward), 0.3)
    got, got_ent = T.reinforce_step(_params(jp), torch.as_tensor(obs),
                                    torch.as_tensor(act),
                                    torch.as_tensor(reward), 0.3)
    for f in P.PolicyParams._fields:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert not np.array_equal(w, np.asarray(getattr(jp, f))) or \
            f == "b1"
        np.testing.assert_allclose(g, w, rtol=STEP_RTOL,
                                   atol=STEP_RTOL * np.abs(w).max())
    assert float(got_ent) == pytest.approx(float(want_ent), rel=STEP_RTOL)


class _CarriedGrid(tgrid.ScenarioGrid):
    """A port grid whose ``build`` returns the reference grid's states
    (after checking that the port's per-scenario estimators equal the
    reference's), so both packages' ``run_grid`` and ``collect`` start
    from one table."""

    reference = None

    def build(self, ests):
        jests = jpolicies.scenario_estimators(
            jpolicies.init_fleet(int(self.geo_idx.max()) + 1),
            jnp.asarray(self.geo_idx), self.pred_seed)
        want = convert.to_numpy(convert.asa_state(
            jax.tree.map(np.asarray, jests)))
        got = convert.to_numpy(ests)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        return _port(self.reference.build(jests))


def _carried(grid, pred_seed: int) -> _CarriedGrid:
    def t(x):
        return convert.tensor(np.asarray(x))
    out = _CarriedGrid(
        cfg=tgrid.XSimConfig(**dataclasses.asdict(grid.cfg)),
        keys=t(grid.keys),
        centers=tgrid.XCenter(*(t(v) for v in grid.centers)),
        wf_cores=t(grid.wf_cores), wf_durs=t(grid.wf_durs),
        wf_valid=t(grid.wf_valid), policies=t(grid.policies),
        fault_t=t(grid.fault_t), fault_c=t(grid.fault_c),
        fault_k=t(grid.fault_k), geo_idx=np.asarray(grid.geo_idx),
        labels=grid.labels)
    out.reference, out.pred_seed = grid, pred_seed
    return out


@pytest.mark.parametrize("rl_mode", ["sample", "greedy"])
@pytest.mark.parametrize("family", ["clean", "faulty"])
def test_rl_run_grid_matches_reference(family, rl_mode):
    """``run_grid(params=...)`` of policies 2, 3 and 4 in both packages
    from the same reference-built states and weights: every integer and
    event field exact (``rl_act`` included), floats and ``rl_obs`` within
    tolerance, the metrics within ``METRIC_RTOL``; every RL stage
    recorded."""
    grid, _ = _reference_grid(family)
    jp = _reference_head()
    ref, ref_m = jgrid.run_grid(grid, params=jp, rl_mode=rl_mode)
    got, got_m = tgrid.run_grid(_carried(grid, 1), params=_params(jp),
                                rl_mode=rl_mode, device=CPU)
    want = convert.to_numpy(_port(ref))
    g = convert.to_numpy(got)
    errs = _compare_states(g, want)
    assert errs["rl_obs"] <= OBS_RTOL
    rl = g["policy"] == X.RL
    assert np.all(g["rl_act"][rl][g["is_wf"][rl][:, -9:]] >= 0)
    assert np.all(g["rl_act"][~rl] == -1)
    assert g["misses"][rl].sum() > 0
    for k, v in ref_m.items():
        a, b = got_m[k].numpy(), np.asarray(v)
        if b.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            assert _rel(a, b) <= METRIC_RTOL, k
    np.testing.assert_array_equal(got_m["wf_done"].numpy(),
                                  got_m["wf_total"].numpy())


def test_collect_rewards_match_reference():
    """``collect`` of the reference's clean RL grid (cold fleet, sampled
    actions): rewards within ``REWARD_RTOL``, the trajectory's actions
    exact and its observations within ``OBS_RTOL``."""
    cfg = jgrid.XSimConfig(**CFG_KW)
    grid = jfamilies.family_grid(cfg, "clean", n_seeds=2, shrink=1 / 64.0,
                                 policy_ids=(X.RL,), seed=3)
    jp = _reference_head(6)
    _, _, want = jrollout.collect(grid, jp, pred_seed=3, rl_mode="sample")
    _, m, got = rollout.collect(_carried(grid, 3), _params(jp), pred_seed=3,
                                device=CPU)
    np.testing.assert_array_equal(got.act.numpy(), np.asarray(want.act))
    _close(got.obs.numpy(), np.asarray(want.obs), OBS_ATOL, OBS_RTOL)
    _close(got.reward.numpy(), np.asarray(want.reward), 0.0, REWARD_RTOL)
    assert not got.reward.requires_grad


# stage durations of a workflow whose stages are all submitted at t = 0 on
# an idle machine, so all start in the first step and its drain needs
# four iterations (tests/test_torch_xsim_naive.py's "hold" and "cancel")
DRAIN_DURS = {"hold": (100.0, 100.0, 100.0, 50.0),
              "cancel": (100.0, 400.0, 100.0, 100.0)}


def _same_instant(durs, key: int):
    t = empty_table(8)
    for y, d in enumerate(durs):
        add_job(t, y, cores=1.0, duration=d, submit=0.0, status=X.PENDING,
                wf_next=y + 1 if y + 1 < len(durs) else -1, is_wf=True)
    return freeze(t, total_cores=16.0, free_cores=16.0, policy=X.RL,
                  pred_mode="sample", est=jasa.init(53,
                                                    jax.random.PRNGKey(key)))


@pytest.mark.parametrize("rl_mode", ["sample", "greedy"])
def test_speculative_drain_rerun_holds_rl_buffers(monkeypatch, rl_mode):
    """RL lanes whose first step needs four drain iterations: a chunk
    first run with the drain cut at ``SPEC_HOOK_PAIRS`` is run again
    whole, and every chunk size (0: no cut) leaves the buffers, the keys
    and the whole state bitwise as the whole drain does, and as the
    reference's sweep within its tolerances."""
    assert tevents.SPEC_HOOK_PAIRS < 4
    ref0 = jax.tree.map(lambda *xs: jnp.stack(xs),
                        _same_instant(DRAIN_DURS["hold"], 3),
                        _same_instant(DRAIN_DURS["cancel"], 4))
    jp = _reference_head(8)
    want = convert.to_numpy(_port(jevents.sweep(
        ref0, n_steps=40, naive=True, params=jp, rl_mode=rl_mode)))
    redo = []
    step = tevents.sim_step

    def spy(s, bins, **kw):
        if kw.get("naive") and kw.get("hook_pairs") is None:
            redo.append(1)
        return step(s, bins, **kw)
    monkeypatch.setattr(tevents, "sim_step", spy)
    runs = {}
    for k in (0, 1, 8):
        redo.clear()
        got = tevents.sweep(_port(ref0), n_steps=40, chunk_steps=k,
                            naive=True, params=_params(jp), rl_mode=rl_mode,
                            device=CPU)
        runs[k] = convert.to_numpy(got)
        _compare_states(runs[k], want)
        if k:
            assert redo   # the cut chunk was run again with the whole drain
    assert np.all(runs[0]["rl_act"][:, :4] >= 0)
    for k in (1, 8):
        for f in runs[0]:
            np.testing.assert_array_equal(runs[k][f], runs[0][f], err_msg=f)


def test_sharded_paths_raise():
    """The sharded rollout is ported: it raises only on a shard count
    past the device inventory (the CPU counts one device), and
    ``TrainConfig`` takes ``n_shards``. Its bitwise contracts are in
    tests/test_torch_xsim_sharded.py."""
    grid = tgrid.make_grid(TINY_SIM, workflows=("statistics",),
                           policy_ids=(X.RL,), n_seeds=1, device=CPU)
    params = P.init_params(prng.PRNGKey(0), device=CPU)
    with pytest.raises(ValueError, match="device"):
        rollout.collect(grid, params, n_shards=2, device=CPU)
    assert T.TrainConfig(n_shards=2).n_shards == 2
    with pytest.raises(ValueError, match="family"):
        T.TrainConfig(family="bogus")


def test_policy_params_converts_and_checks_shapes():
    jp = _reference_head(2, hidden=8)
    tp = _params(jp)
    for f in P.PolicyParams._fields:
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)))
        assert getattr(tp, f).dtype == torch.float32
    with pytest.raises(ValueError, match="b2"):
        convert.policy_params(jp._replace(b2=jnp.zeros(52)))
    with pytest.raises(ValueError, match="w1"):
        convert.policy_params(jp._replace(w1=jnp.zeros((12, 8), jnp.int32)))


def test_init_params_draws_the_reference_stream():
    """``init_params`` draws from the port's threefry stream, which is
    the reference's to a few ULP (``prng.normal`` goes through erfinv),
    and never from the global torch generator."""
    torch.manual_seed(0)
    a = P.init_params(prng.PRNGKey(3), device=CPU)
    torch.manual_seed(1)
    b = P.init_params(prng.PRNGKey(3), device=CPU)
    want = JP.init_params(jax.random.PRNGKey(3))
    for f in P.PolicyParams._fields:
        assert torch.equal(getattr(a, f), getattr(b, f))
        _close(getattr(a, f).numpy(), np.asarray(getattr(want, f)), 1e-7,
               1e-5)

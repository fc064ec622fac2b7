"""The port's scheduling runners against the reference (CPU).

* ``QueueSim``: the port's copy and the reference, driven by one script
  of submit / cancel / at / on_start / on_end / run_until* calls from the
  same seed, end in equal states: every ``Job`` field, ``now``,
  ``free_cores``, the queue, the running heap, the finished set, the hook
  firings and the numpy RNG state.
* The strategies: each ``run_*`` of both packages on twin simulators,
  ASA with estimators of the same seed (the port's on ``device="cpu"``),
  gives equal ``RunMetrics``, prediction and wait sequences included.
  Exact: the port's posterior differs from the reference's by up to about
  1.3e-6 in ``log_p``, and a Gumbel draw could part only at a near-tie;
  none does on these inputs.
* The table runners: a reduced ``run_table1`` and ``run_table2`` give the
  reference's rows within one process (their estimator seeds come from
  ``hash()`` of strings, which differs between processes).
* Regret, the PRNG keys at the table runners' seeds, the reference's own
  contracts rerun on the port, and the device rule.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import asa as jasa
from repro.core import regret as jregret
from repro.core.bins import make_bins as jmake_bins
from repro.core.losses import zero_one as jzero_one
from repro.sched import centers as jcenters
from repro.sched import queue_sim as jqs
from repro.sched import runner as jrunner
from repro.sched import strategies as jstrat
from repro_torch import convert
from repro_torch.core import asa, prng, regret
from repro_torch.core.bins import make_bins
from repro_torch.core.losses import zero_one
from repro_torch.sched import centers, queue_sim, runner, strategies
from repro_torch.sched.workflows import BLAST, MONTAGE, STATISTICS, WORKFLOWS

jax.config.update("jax_threefry_partitionable", True)
torch.set_num_threads(1)   # small tensors: threads only contend

# tests/test_xsim.py's TINY center, as a profile of each package
_TINY_KW = dict(
    name="tiny", nodes=8, cores_per_node=4,
    bg_arrival_rate=1 / 200.0, bg_cores_mean=1.5, bg_cores_sigma=0.8,
    bg_duration_mean_s=7.0, bg_duration_sigma=0.8, bg_initial_backlog=12,
    bg_burst_mean=1.0, scales=(8,))


def _profiles(name: str):
    """(reference profile, port profile) of a center by name."""
    if name == "tiny":
        return (jcenters.CenterProfile(**_TINY_KW),
                centers.CenterProfile(**_TINY_KW))
    return jcenters.CENTERS[name], centers.CENTERS[name]


def _script(qs, profile, seed: int, log: list):
    """One script of calls on a QueueSim of module ``qs``; hook firings
    are appended to ``log``. Returns the simulator."""
    sim = qs.QueueSim(profile, seed=seed)
    w = max(1, profile.total_cores // 600)     # a small job of this center
    sim.run_until(1800.0)
    a = sim.submit(4 * w, 900.0, user="t")
    b = sim.submit(2 * w, 300.0, depend_on=a.id, user="t")
    sim.on_start(a, lambda j: log.append(("start", j.id, sim.now)))
    sim.on_end(a, lambda j: log.append(("end", j.id, sim.now)))
    c = sim.submit(w, 5000.0, user="t")

    def cancel_c():
        log.append(("at", sim.now))
        sim.cancel(c)          # queued or running: both paths are covered
        d = sim.submit(3 * w, 120.0, user="t")
        sim.on_start(d, lambda j: log.append(("start", j.id, sim.now)))

    sim.at(sim.now + 240.0, cancel_c)
    sim.run_until_job_starts(a)
    sim.run_until_job_ends(b)
    e = sim.submit(profile.total_cores // 4, 600.0, user="t")
    sim.run_until_job_starts(e)
    sim.cancel(e)              # a running job: its cores return at once
    sim.on_start(e, lambda j: log.append(("late", j.id)))   # fires now
    f = sim.submit(w, 60.0, user="t")
    sim.cancel(f)
    sim.run_until(sim.now + 7200.0)
    log.append(("util", sim.utilization()))
    return sim


def _sim_state(sim) -> dict:
    return dict(
        now=sim.now, free=sim.free_cores, queue=list(sim.queue),
        running=sorted(sim.running), finished=sorted(sim.finished),
        jobs={i: dataclasses.asdict(j) for i, j in sim.jobs.items()},
        rng=sim.rng.bit_generator.state, events=len(sim._events),
        pending_hooks=(sorted(sim._start_hooks), sorted(sim._end_hooks)))


# ------------------------------------------------------------- QueueSim
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("center", ["hpc2n", "uppmax", "tiny"])
def test_queue_sim_copy_equals_reference(center, seed):
    jp, tp = _profiles(center)
    jlog, tlog = [], []
    jsim = _script(jqs, jp, seed, jlog)
    tsim = _script(queue_sim, tp, seed, tlog)
    assert tlog == jlog and len(jlog) >= 4
    assert _sim_state(tsim) == _sim_state(jsim)


def test_core_conservation():
    sim = queue_sim.QueueSim(centers.HPC2N, seed=0)
    total = centers.HPC2N.total_cores
    for t in range(0, 20000, 2000):
        sim.run_until(t)
        running = sum(sim.jobs[j].cores for _, j in sim.running
                      if not sim.jobs[j].canceled)
        assert 0 <= sim.free_cores <= total
        assert running + sim.free_cores == total


def test_job_lifecycle_and_fcfs_wait():
    sim = queue_sim.QueueSim(centers.HPC2N, seed=1)
    sim.run_until(3600)
    j = sim.submit(28, 600, user="t")
    sim.run_until_job_ends(j)
    assert j.start_time is not None and j.end_time == j.start_time + 600
    assert j.wait_time >= 0


def test_dependency_blocks_start():
    sim = queue_sim.QueueSim(centers.HPC2N, seed=2)
    sim.run_until(1800)
    a = sim.submit(28, 900)
    b = sim.submit(28, 300, depend_on=a.id)
    sim.run_until_job_ends(b)
    assert b.start_time >= a.end_time


def test_cancel_queued_and_running():
    sim = queue_sim.QueueSim(centers.HPC2N, seed=3)
    sim.run_until(1800)
    a = sim.submit(28, 5000)
    sim.run_until_job_starts(a)
    sim.cancel(a)
    assert a.canceled and all(jid != a.id for _, jid in sim.running)
    b = sim.submit(28, 50)
    sim.cancel(b)
    assert b.canceled


def test_hooks_fire_even_if_already_started():
    sim = queue_sim.QueueSim(centers.HPC2N, seed=4)
    sim.run_until(1800)
    j = sim.submit(1, 100)
    sim.run_until_job_starts(j)
    fired = []
    sim.on_start(j, lambda job: fired.append(job.id))
    assert fired == [j.id]


@given(st.integers(min_value=0, max_value=10_000))
@settings(max_examples=5, deadline=None)
def test_random_streams_keep_invariants(seed):
    sim = queue_sim.QueueSim(centers.UPPMAX, seed=seed)
    sim.run_until(7200)
    running = sum(sim.jobs[j].cores for _, j in sim.running
                  if not sim.jobs[j].canceled)
    assert running + sim.free_cores == centers.UPPMAX.total_cores
    assert 0.0 <= sim.utilization() <= 1.0


# ----------------------------------------------------------- strategies
def _twins(center: str, seed: int, warm: float = 3600.0):
    jp, tp = _profiles(center)
    jsim, tsim = jqs.QueueSim(jp, seed=seed), queue_sim.QueueSim(tp, seed=seed)
    jsim.run_until(warm)
    tsim.run_until(warm)
    return jsim, tsim


def _run_both(kind: str, center: str, wf, scale: int, seed: int,
              warm: float = 3600.0, est_seed: int | None = None):
    jsim, tsim = _twins(center, seed, warm)
    if kind.startswith("asa"):
        deps = kind == "asa"
        es = seed + 17 if est_seed is None else est_seed
        want = jstrat.run_asa(jsim, wf, scale, center,
                              jstrat.ASAEstimator(seed=es),
                              use_dependencies=deps)
        got = strategies.run_asa(tsim, wf, scale, center,
                                 strategies.ASAEstimator(seed=es,
                                                         device="cpu"),
                                 use_dependencies=deps)
    else:
        want = getattr(jstrat, f"run_{kind}")(jsim, wf, scale, center)
        got = getattr(strategies, f"run_{kind}")(tsim, wf, scale, center)
    return got, want, tsim, jsim


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("kind", ["asa", "asa_naive"])
def test_run_asa_montage_uppmax_equals_reference(kind, seed):
    """MONTAGE at UPPMAX scale 160, where waits run to hours: every
    ``RunMetrics`` field equal; the naive world misses and cancels. (The
    estimator takes the simulator's seed: with seed 17 on simulator seed
    0 the reference's naive run never ends, ROADMAP Queue 3.)"""
    got, want, tsim, jsim = _run_both(kind, "uppmax", MONTAGE, 160, seed,
                                      est_seed=seed)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert _sim_state(tsim) == _sim_state(jsim)
    assert len(got.pred_waits) == len(MONTAGE.stages) - 1
    if kind == "asa_naive":
        cancelled = [j for j in tsim.jobs.values()
                     if j.user == "wf" and j.canceled]
        assert got.misses > 0 and got.oh_hours > 0.0 and cancelled
    else:
        assert got.oh_hours == 0.0


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", ["bigjob", "per_stage", "pilot", "asa",
                                  "asa_naive"])
@pytest.mark.parametrize("wf", [BLAST, STATISTICS], ids=lambda w: w.name)
@pytest.mark.parametrize("center,scale", [("hpc2n", 28), ("tiny", 8)])
def test_strategies_equal_reference(center, scale, wf, kind, seed):
    warm = 600.0 if center == "tiny" else 3600.0
    got, want, tsim, jsim = _run_both(kind, center, wf, scale, seed, warm)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert _sim_state(tsim) == _sim_state(jsim)


def test_pilot_cost_helpers_equal_reference():
    for wf in WORKFLOWS.values():
        for scale in (8, 28, 160, 640):
            assert strategies.pilot_duration(wf, scale) == \
                jstrat.pilot_duration(wf, scale)
            assert strategies.pilot_waste_cs(wf, scale) == \
                jstrat.pilot_waste_cs(wf, scale)
    for name in ("NAIVE_IDLE_THRESHOLD_S", "NAIVE_CANCEL_LATENCY_S",
                 "PILOT_STARTUP_S", "PILOT_TASK_LATENCY_S"):
        assert getattr(strategies, name) == getattr(jstrat, name)


def test_estimator_predict_learn_sequence_equals_reference():
    """Alternating ``predict`` / ``learn`` over random waits: the same
    draws and the same hit verdicts as the reference's estimator."""
    rng = np.random.default_rng(5)
    waits = np.exp(rng.uniform(np.log(5.0), np.log(2e5), 120))
    j, t = jstrat.ASAEstimator(seed=11), strategies.ASAEstimator(
        seed=11, device="cpu")
    for w in waits:
        a_j, a_t = j.predict(), t.predict()
        assert a_t == a_j
        assert t.was_hit(a_t, float(w)) == j.was_hit(a_j, float(w))
        j.learn(float(w))
        t.learn(float(w))
    np.testing.assert_array_equal(t.state.key.numpy(),
                                  np.asarray(j.state.key).astype(np.int64))
    assert int(t.state.t) == int(j.state.t)
    np.testing.assert_allclose(t.state.log_p.numpy(),
                               np.asarray(j.state.log_p), atol=2e-5)


def test_greedy_estimator_flips_only_at_map_near_ties():
    """``policy="greedy"``: the MAP read agrees with the reference's but
    where the reference's two best bins are within the rounding of
    logsumexp (ROADMAP Queue 3, MAP near-ties); each flip is counted."""
    rng = np.random.default_rng(6)
    waits = np.exp(rng.uniform(np.log(5.0), np.log(2e5), 80))
    j = jstrat.ASAEstimator(seed=3, policy="greedy")
    t = strategies.ASAEstimator(seed=3, policy="greedy", device="cpu")
    flips = 0
    for w in waits:
        a_j, a_t = j.predict(), t.predict()
        if a_t != a_j:
            lp = np.asarray(j.state.log_p)
            gap = lp.max() - lp[np.flatnonzero(t.bins_np == a_t)[0]]
            assert gap <= 2e-4, gap
            flips += 1
        j.learn(float(w))
        t.learn(float(w))
        # carry on from one state so a flip cannot compound
        t.state = convert.asa_state(j.state)
    assert flips <= len(waits) // 4


# --------------------------------------------------------- table runners
def test_run_table1_rows_equal_reference():
    kw = dict(seed=0, include_naive=True, include_pilot=True,
              workflows=("blast", "statistics"), n_warmup=4)
    want = jrunner.run_table1(**kw)
    got = runner.run_table1(**kw, device="cpu")
    assert len(got.runs) == 2 * 6 * 5 and got.rows() == want.rows()
    for g, w in zip(got.runs, want.runs):
        assert dataclasses.asdict(g) == dataclasses.asdict(w)
    sg, sw = runner.summarize_table1(got), jrunner.summarize_table1(want)
    assert sg.keys() == sw.keys()
    for s in sw:
        for k in sw[s]:
            assert sg[s][k] == pytest.approx(sw[s][k], abs=1e-12)


def test_run_table2_rows_equal_reference():
    want = jrunner.run_table2(n_submissions=3, n_warmup=3)
    got = runner.run_table2(n_submissions=3, n_warmup=3, device="cpu")
    assert len(got) == 18
    assert [dataclasses.asdict(r) for r in got] == \
        [dataclasses.asdict(r) for r in want]


def test_warmup_constant_equals_reference():
    assert runner.WARMUP_S == jrunner.WARMUP_S


# --------------------------------------------------------------- system
def test_asa_with_dependencies_has_no_overhead():
    sim = queue_sim.QueueSim(centers.UPPMAX, seed=0)
    sim.run_until(3600)
    est = strategies.ASAEstimator(seed=0, device="cpu")
    m = strategies.run_asa(sim, MONTAGE, 160, "uppmax", est,
                           use_dependencies=True)
    assert m.oh_hours == 0.0
    assert m.core_hours == pytest.approx(MONTAGE.core_seconds(160) / 3600.0)
    assert len(m.stage_waits) == 9


def test_bigjob_and_per_stage_accounting():
    sim = queue_sim.QueueSim(centers.HPC2N, seed=0)
    sim.run_until(3600)
    m = strategies.run_bigjob(sim, BLAST, 28, "hpc2n")
    assert len(m.stage_waits) == 1
    assert m.core_hours == pytest.approx(
        BLAST.bigjob_core_seconds(28) / 3600.0)
    sim = queue_sim.QueueSim(centers.HPC2N, seed=0)
    sim.run_until(3600)
    m = strategies.run_per_stage(sim, MONTAGE, 28, "hpc2n")
    assert len(m.stage_waits) == 9
    assert m.core_hours == pytest.approx(MONTAGE.core_seconds(28) / 3600.0)


def test_asa_beats_per_stage_on_busy_center():
    """The paper's core claim on the port: ASA's perceived waits ≪
    Per-Stage's waits when the queue is busy (UPPMAX)."""
    est = strategies.ASAEstimator(seed=1, device="cpu")
    sim0 = queue_sim.QueueSim(centers.UPPMAX, seed=7)
    sim0.run_until(3600)
    strategies.run_asa(sim0, MONTAGE, 320, "uppmax", est)
    sim1 = queue_sim.QueueSim(centers.UPPMAX, seed=8)
    sim1.run_until(3600)
    asa_m = strategies.run_asa(sim1, MONTAGE, 320, "uppmax", est)
    sim2 = queue_sim.QueueSim(centers.UPPMAX, seed=8)
    sim2.run_until(3600)
    ps_m = strategies.run_per_stage(sim2, MONTAGE, 320, "uppmax")
    assert asa_m.twt_s < 0.6 * ps_m.twt_s
    assert asa_m.core_hours <= ps_m.core_hours + 1e-6


def test_paper_ordering_on_busy_center():
    """CH(ASA) == CH(Per-Stage) < CH(BigJob) and makespan(ASA) ≈
    makespan(BigJob) < makespan(Per-Stage), on the port."""
    est = strategies.ASAEstimator(seed=0, device="cpu")
    sim = queue_sim.QueueSim(centers.UPPMAX, seed=21)
    sim.run_until(3600)
    strategies.run_asa(sim, MONTAGE, 640, "uppmax", est)
    r = {}
    for name, run in [
            ("bigjob", strategies.run_bigjob),
            ("per_stage", strategies.run_per_stage),
            ("asa", lambda s, w, n, c: strategies.run_asa(s, w, n, c, est))]:
        sim = queue_sim.QueueSim(centers.UPPMAX, seed=22)
        sim.run_until(3600)
        r[name] = run(sim, MONTAGE, 640, "uppmax")
    assert r["asa"].core_hours == pytest.approx(r["per_stage"].core_hours)
    assert r["asa"].core_hours < 0.6 * r["bigjob"].core_hours
    assert r["asa"].makespan_s < r["per_stage"].makespan_s
    assert r["asa"].makespan_s < 2.0 * r["bigjob"].makespan_s


# --------------------------------------------------------------- regret
def test_regret_functions_equal_reference():
    rng = np.random.default_rng(0)
    for _ in range(20):
        t, m, eta = (int(rng.integers(1, 5000)), int(rng.integers(2, 60)),
                     int(rng.integers(0, 200)))
        delta = float(rng.uniform(0.001, 0.999))
        assert regret.theorem1_bound(t, m, eta, delta) == \
            jregret.theorem1_bound(t, m, eta, delta)
        losses = rng.uniform(0, 1, (t % 97 + 1, m)).astype(np.float32)
        chosen = losses[np.arange(losses.shape[0]),
                        rng.integers(0, m, losses.shape[0])]
        assert regret.empirical_regret(chosen, losses) == \
            jregret.empirical_regret(chosen, losses)
    with pytest.raises(ValueError):
        regret.theorem1_bound(10, 53, 1, delta=1.0)


@given(st.integers(min_value=0, max_value=2**31 - 1),
       st.integers(min_value=3, max_value=16))
@settings(max_examples=15, deadline=None)
def test_regret_under_theorem1_bound(seed, m):
    """Random step-changing truth; the port's default (bandit) policy;
    δ=0.05: empirical regret stays under Theorem 1's bound."""
    T = 400
    rng = np.random.default_rng(seed)
    n_seg = rng.integers(1, 6)
    truth = np.repeat(
        np.exp(rng.uniform(np.log(10), np.log(1e5), n_seg)),
        -(-T // n_seg))[:T].astype(np.float32)
    bins = torch.as_tensor(make_bins(m), dtype=torch.float32)
    s = asa.init(m, prng.PRNGKey(seed % 2**31))
    all_losses = zero_one(bins, torch.as_tensor(truth))
    g = torch.tensor(1.0)
    chosen = []
    for t in range(T):
        s, a = asa.step(s, all_losses[t], g, policy="default")
        chosen.append(float(all_losses[t, int(a)]))
    lv = all_losses.numpy()
    reg = regret.empirical_regret(np.asarray(chosen), lv)
    assert reg <= regret.theorem1_bound(T, m, int(s.rounds), delta=0.05)
    # the loss vectors are the reference's, bit for bit
    jl = np.stack([np.asarray(jzero_one(jax.numpy.asarray(
        jmake_bins(m), jax.numpy.float32), jax.numpy.float32(w)))
        for w in truth[::50]])
    np.testing.assert_array_equal(lv[::50], jl)


def test_bound_monotone_in_t_and_rounds():
    assert regret.theorem1_bound(100, 53, 10) < \
        regret.theorem1_bound(1000, 53, 10)
    assert regret.theorem1_bound(100, 53, 10) < \
        regret.theorem1_bound(100, 53, 50)


# ----------------------------------------------------------------- keys
def _table_seeds() -> list[int]:
    seeds = {0, 17, 2**31 - 1}
    for c in centers.CENTERS.values():
        for scale in c.scales:
            seeds.add(hash((c.name, scale)) % (2**31))
            for wf in WORKFLOWS:
                seeds.add(hash((c.name, scale, wf)) % (2**31))
    return sorted(seeds)


def test_prng_key_equals_reference_at_table_seeds():
    seeds = _table_seeds()
    assert len(seeds) == 3 + 6 + 18
    for seed in seeds:
        want = np.asarray(jax.random.PRNGKey(seed)).astype(np.int64)
        np.testing.assert_array_equal(prng.PRNGKey(seed).numpy(), want)
        # and the first draw of an estimator of that seed
        _, a_j = jasa.sample_action(jasa.init(53, jax.random.PRNGKey(seed)))
        _, a_t = asa.sample_action(asa.init(53, prng.PRNGKey(seed)))
        assert int(a_t) == int(a_j)


# ---------------------------------------------------------------- device
def test_tables_and_estimator_need_cuda_unless_cpu():
    if torch.cuda.is_available():
        assert strategies.ASAEstimator().bins.is_cuda
        return
    for call in (lambda: strategies.ASAEstimator(),
                 lambda: runner.run_table1(workflows=("blast",), n_warmup=1),
                 lambda: runner.run_table2(n_submissions=1, n_warmup=1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    est = strategies.ASAEstimator(device="cpu")
    assert est.state.log_p.device.type == "cpu"
    assert isinstance(est.predict(), float)

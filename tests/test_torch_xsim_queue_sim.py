"""The QueueSim differentials on the port's own engines (CPU).

Every case of the reference's cross-validation tests
(``tests/test_xsim.py``: 6 BigJob, 9 Per-Stage, 12 ASA / ASA-Naive and 6
pilot, plus the cancel/resubmit check) is run as the reference runs it,
with the port on both sides: the port's ``QueueSim`` and ``run_*``
against the port's fleet simulator, started from the same snapshot
through the port's ``scenario_from_queue_sim``, ``add_workflow`` and
``freeze``. The reference's tolerances hold (``REL_TOL`` 0.02 with 5 s
absolute, misses exact, OH within 1e-3 h and exactly 0 with
dependencies, the sampled prediction sequence equal, ``est.t >= 2 ·
stages``).

The cases are frozen into two batches, one for the program without the
naive world (27 lanes) and one for ASA-Naive (9 lanes, ``naive=True``),
each swept once; each reference test's step budget (160, 220, 300) is
the state read after that many steps. Each case is one parametrised test
over its lane.

The reference's fleet simulator runs the same snapshots (its ``sweep``
over the stacked states): integer and event fields equal the port's,
float fields within ``TIME_RTOL``. The table helpers (``empty_table``,
``add_job``, ``add_workflow``, ``scenario_from_queue_sim``, ``freeze``)
equal the reference's array for array.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import asa as jasa
from repro.sched import centers as jcenters
from repro.sched import queue_sim as jqs
from repro.sched import workflows as jworkflows
from repro.sched.strategies import pilot_waste_cs as jpilot_waste_cs
from repro.xsim import compare as jcompare
from repro.xsim import events as jevents
from repro.xsim import policies as jpolicies
from repro.xsim import state as jstate
from repro_torch import convert
from repro_torch.core import asa, prng
from repro_torch.runtime.fault import (FAULT_FAIL, FAULT_GROW, CapacityEvent,
                                       FaultSchedule)
from repro_torch.sched.centers import CenterProfile
from repro_torch.sched.queue_sim import QueueSim
from repro_torch.sched.strategies import (ASAEstimator, pilot_waste_cs,
                                          run_asa, run_bigjob, run_per_stage,
                                          run_pilot)
from repro_torch.sched.workflows import BLAST, MONTAGE, STATISTICS
from repro_torch.xsim import compare, events, policies
from repro_torch.xsim import state as X

jax.config.update("jax_threefry_partitionable", True)
torch.set_num_threads(1)   # small tensors: threads only contend

_TINY_KW = dict(
    name="tiny", nodes=8, cores_per_node=4,
    bg_arrival_rate=1 / 200.0, bg_cores_mean=1.5, bg_cores_sigma=0.8,
    bg_duration_mean_s=7.0, bg_duration_sigma=0.8, bg_initial_backlog=12,
    bg_burst_mean=1.0, scales=(8,))
TINY = CenterProfile(**_TINY_KW)
JTINY = jcenters.CenterProfile(**_TINY_KW)

REL_TOL = 0.02   # the reference's bounded-backfill divergence allowance
TIME_RTOL = 1e-5   # tests/test_torch_xsim.py's float tolerance
MAX_JOBS = 64
T0 = 600.0

POLICY = {"bigjob": X.BIGJOB, "per_stage": X.PER_STAGE, "asa": X.ASA,
          "asa_naive": X.ASA_NAIVE, "pilot": X.PILOT}
# each reference test's step budget (tests/test_xsim.py)
N_STEPS = {"bigjob": 160, "pilot": 160, "per_stage": 220, "asa": 300,
           "asa_naive": 300, "cancel": 300}

# (kind, workflow, seed), in the reference's parametrisations
DEPS_CASES = (
    [("bigjob", wf, s) for wf in (BLAST, STATISTICS) for s in (0, 1, 2)]
    + [("per_stage", wf, s) for wf in (BLAST, STATISTICS, MONTAGE)
       for s in (0, 1, 2)]
    + [("asa", wf, s) for wf in (STATISTICS, MONTAGE) for s in (0, 2, 3)]
    + [("pilot", wf, s) for wf in (BLAST, STATISTICS) for s in (0, 1, 2)])
NAIVE_CASES = (
    [("asa_naive", wf, s) for wf in (STATISTICS, MONTAGE) for s in (0, 2, 3)]
    + [("cancel", MONTAGE, s) for s in (0, 2, 3)])


def _case_id(case) -> str:
    kind, wf, seed = case
    return f"{kind}-{wf.name}-{seed}"


def _mirrored(seed: int):
    """A warmed port QueueSim (no further arrivals) + its snapshot."""
    sim = QueueSim(TINY, seed=seed, bg_horizon=0.0)
    sim.run_until(T0)
    table, row = compare.scenario_from_queue_sim(sim, max_jobs=MAX_JOBS)
    return sim, table, row


def _case(kind: str, wf, seed: int):
    """(frozen lane, the port's QueueSim run or None) of one case: the
    snapshot is taken before the QueueSim run, as the reference does."""
    sim, table, row = _mirrored(seed)
    free = compare.queue_sim_free_cores(sim)
    pol = POLICY["asa_naive" if kind == "cancel" else kind]
    kw, ref = {}, None
    if kind == "bigjob":
        ref = run_bigjob(sim, wf, 8, "tiny")
    elif kind == "per_stage":
        ref = run_per_stage(sim, wf, 8, "tiny")
    elif kind == "pilot":
        ref = run_pilot(sim, wf, 8, "tiny")
        kw["pilot_waste_cs"] = pilot_waste_cs(wf, 8)
    else:
        if kind != "cancel":
            ref = run_asa(sim, wf, 8, "tiny",
                          ASAEstimator(seed=seed + 17, device="cpu"),
                          use_dependencies=kind == "asa")
        kw["est"] = asa.init(53, prng.PRNGKey(seed + 17))
    policies.add_workflow(table, row, wf, 8, pol, t0=T0)
    st = X.freeze(table, total_cores=TINY.total_cores, free_cores=free,
                  now=T0, policy=pol, t0=T0, device="cpu", **kw)
    return st, ref


def _sweep_staged(batch, naive: bool) -> dict:
    """The batch after each step budget of its cases (a run of 160 steps
    continued to 220 and 300 equals runs of 220 and 300 from the start:
    a step is a function of the state alone)."""
    out, done = {}, 0
    for n in sorted(set(N_STEPS.values())):
        batch = events.simulate(batch, n_steps=n - done, naive=naive)
        out[n], done = batch, n
    return out


@pytest.fixture(scope="module")
def port_runs():
    runs = {}
    for name, cases, naive in (("deps", DEPS_CASES, False),
                               ("naive", NAIVE_CASES, True)):
        built = [_case(*c) for c in cases]
        batch = X.concat([b for b, _ in built])
        staged = _sweep_staged(batch, naive)
        runs[name] = dict(
            cases=cases, refs=[r for _, r in built], initial=batch,
            staged=staged,
            metrics={n: {k: v.numpy() for k, v in compare.metrics(s).items()}
                     for n, s in staged.items()})
    return runs


def _lane(port_runs, case):
    name = "naive" if case[0] in ("asa_naive", "cancel") else "deps"
    run = port_runs[name]
    i = run["cases"].index(case)
    n = N_STEPS[case[0]]
    m = {k: v[i] for k, v in run["metrics"][n].items()}
    return i, run["staged"][n], m, run["refs"][i]


def _close(a, b):
    assert a == pytest.approx(b, rel=REL_TOL, abs=5.0), (a, b)


# ------------------------------------------------------- cross-validation
BIGJOB = [c for c in DEPS_CASES if c[0] == "bigjob"]
PER_STAGE = [c for c in DEPS_CASES if c[0] == "per_stage"]
ASA_CASES = ([c for c in DEPS_CASES if c[0] == "asa"]
             + [c for c in NAIVE_CASES if c[0] == "asa_naive"])
PILOT = [c for c in DEPS_CASES if c[0] == "pilot"]


@pytest.mark.parametrize("case", BIGJOB, ids=_case_id)
def test_bigjob_matches_queue_sim(port_runs, case):
    _, _, m, ref = _lane(port_runs, case)
    _close(float(m["twt_s"]), ref.twt_s)
    _close(float(m["makespan_s"]), ref.makespan_s)
    _close(float(m["core_hours"]), ref.core_hours)


@pytest.mark.parametrize("case", PER_STAGE, ids=_case_id)
def test_per_stage_matches_queue_sim(port_runs, case):
    _, _, m, ref = _lane(port_runs, case)
    _close(float(m["twt_s"]), ref.twt_s)
    _close(float(m["makespan_s"]), ref.makespan_s)
    assert 0.0 < float(m["utilization"]) <= 1.0


@pytest.mark.parametrize("case", ASA_CASES, ids=_case_id)
def test_asa_matches_queue_sim(port_runs, case):
    """ASA and ASA-Naive: the same snapshot and the same Algorithm-1
    state on both engines; perceived waits, makespans, OH, misses and the
    whole sampled prediction sequence agree."""
    kind, wf, _ = case
    i, fin, m, ref = _lane(port_runs, case)
    _close(float(m["twt_s"]), ref.twt_s)
    _close(float(m["makespan_s"]), ref.makespan_s)
    assert float(m["oh_hours"]) == pytest.approx(ref.oh_hours, abs=1e-3)
    assert int(m["misses"]) == ref.misses
    if kind == "asa":
        assert float(m["oh_hours"]) == 0.0
    preds = fin.pred_wait[i][fin.is_wf[i]].numpy()
    np.testing.assert_allclose(preds[1:len(ref.pred_waits) + 1],
                               ref.pred_waits)
    assert int(fin.est.t[i]) >= 2 * len(wf.stages)


@pytest.mark.parametrize("case", PILOT, ids=_case_id)
def test_pilot_matches_queue_sim(port_runs, case):
    _, _, m, ref = _lane(port_runs, case)
    _close(float(m["twt_s"]), ref.twt_s)
    _close(float(m["makespan_s"]), ref.makespan_s)
    _close(float(m["core_hours"]), ref.core_hours)
    assert float(m["oh_hours"]) == pytest.approx(ref.oh_hours, rel=1e-5)
    assert float(m["oh_hours"]) > 0.0
    assert int(m["wf_done"]) == int(m["wf_total"]) == 1


def test_naive_cancel_resubmit_exercised(port_runs):
    """The naive path really cancels: across the three MONTAGE seeds the
    lanes take the CANCELLED → resubmit edge and charge OH, and every
    resubmission finishes."""
    total_miss, total_oh, cancelled = 0, 0.0, 0
    for case in (c for c in NAIVE_CASES if c[0] == "cancel"):
        i, fin, m, _ = _lane(port_runs, case)
        total_miss += int(m["misses"])
        total_oh += float(m["oh_hours"])
        cancelled += int(torch.isfinite(fin.canc_start[i]).sum())
        assert int(m["wf_done"]) == int(m["wf_total"])
    assert total_miss >= 3
    assert total_oh > 0.0
    assert cancelled > 0


# ------------------------------- the reference's engine, same snapshots
def _reference_batch(cases):
    """The reference's snapshots of the same cases, through the
    reference's QueueSim and table helpers, stacked for its ``sweep``."""
    states = []
    for kind, wf, seed in cases:
        sim = jqs.QueueSim(JTINY, seed=seed, bg_horizon=0.0)
        sim.run_until(T0)
        table, row = jcompare.scenario_from_queue_sim(sim, max_jobs=MAX_JOBS)
        pol = POLICY["asa_naive" if kind == "cancel" else kind]
        jwf = jworkflows.WORKFLOWS[wf.name]
        jpolicies.add_workflow(table, row, jwf, 8, pol, t0=T0)
        kw = {}
        if kind == "pilot":
            kw["pilot_waste_cs"] = jpilot_waste_cs(jwf, 8)
        if kind in ("asa", "asa_naive", "cancel"):
            kw["est"] = jasa.init(53, jax.random.PRNGKey(seed + 17))
        states.append(jstate.freeze(
            table, total_cores=JTINY.total_cores,
            free_cores=jcompare.queue_sim_free_cores(sim), now=T0,
            policy=pol, t0=T0, **kw))
    return jax.tree.map(lambda *x: jnp.stack(x), *states)


@pytest.fixture(scope="module")
def reference_runs():
    out = {}
    for name, cases in (("deps", DEPS_CASES), ("naive", NAIVE_CASES)):
        batch = _reference_batch(cases)
        fin = jevents.sweep(batch, n_steps=300)
        out[name] = dict(initial=convert.scenario_state(batch),
                         final=convert.scenario_state(fin))
    return out


EXACT = ("status", "steps", "misses", "start_pending", "chain_pending",
         "est.key", "est.t", "est.rounds", "policy", "rl_act", "start_dep",
         "wf_next", "wf_rows", "is_wf", "repass", "fault_next", "restarts")


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    fin = np.isfinite(b)
    np.testing.assert_array_equal(np.isfinite(a), fin)
    np.testing.assert_array_equal(a[~fin], b[~fin])
    if not fin.any():
        return 0.0
    return float(np.max(np.abs(a[fin] - b[fin])
                        / np.maximum(np.abs(b[fin]), 1.0)))


@pytest.mark.parametrize("name", ["deps", "naive"])
def test_snapshot_batches_equal_reference(port_runs, reference_runs, name):
    """The port's frozen batch of every case equals the reference's,
    carried across field by field: the table helpers agree bit for bit."""
    got = convert.to_numpy(port_runs[name]["initial"])
    want = convert.to_numpy(reference_runs[name]["initial"])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("case", DEPS_CASES + NAIVE_CASES, ids=_case_id)
def test_port_xsim_equals_reference_xsim_on_snapshot(port_runs,
                                                     reference_runs, case):
    """The two fleet simulators, 300 steps from the same snapshot: integer
    and event fields exact, float fields within ``TIME_RTOL``, the same
    start order."""
    name = "naive" if case[0] in ("asa_naive", "cancel") else "deps"
    i = port_runs[name]["cases"].index(case)
    got = convert.to_numpy(port_runs[name]["staged"][300])
    want = convert.to_numpy(reference_runs[name]["final"])
    for k in want:
        g, w = got[k][i], want[k][i]
        if k in EXACT or w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert _rel(g, w) <= TIME_RTOL, (k, _rel(g, w))
    np.testing.assert_array_equal(np.argsort(got["start"][i], kind="stable"),
                                  np.argsort(want["start"][i], kind="stable"))


# --------------------------------------------------------- table helpers
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_snapshot_table_equals_reference(seed):
    sim = QueueSim(TINY, seed=seed, bg_horizon=0.0)
    jsim = jqs.QueueSim(JTINY, seed=seed, bg_horizon=0.0)
    for t in (T0, 1800.0):
        sim.run_until(t)
        jsim.run_until(t)
        got, row = compare.scenario_from_queue_sim(sim, max_jobs=MAX_JOBS)
        want, jrow = jcompare.scenario_from_queue_sim(jsim,
                                                      max_jobs=MAX_JOBS)
        assert row == jrow > 0
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert compare.queue_sim_free_cores(sim) == \
            jcompare.queue_sim_free_cores(jsim)
        # FCFS: the running rows by (end, id), then the queue in order
        status = got["status"][:row]
        n_run = int((status == X.RUNNING).sum())
        assert np.all(status[:n_run] == X.RUNNING)
        assert np.all(status[n_run:] == X.QUEUED)
        assert np.all(np.diff(got["end"][:n_run]) >= 0)


@pytest.mark.parametrize("policy", [0, 1, 2, 3, 4, 5])
def test_add_workflow_equals_reference(policy):
    for wf in (BLAST, STATISTICS, MONTAGE):
        for scale in (8, 160):
            got, want = X.empty_table(32), jstate.empty_table(32)
            X.add_job(got, 0, cores=3, duration=10.0, submit=0.0,
                      status=X.QUEUED)
            jstate.add_job(want, 0, cores=3, duration=10.0, submit=0.0,
                           status=jstate.QUEUED)
            n = policies.add_workflow(got, 1, wf, scale, policy, t0=T0)
            assert n == jpolicies.add_workflow(
                want, 1, jworkflows.WORKFLOWS[wf.name], scale, policy, t0=T0)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _freeze_both(**kw):
    """The same scenario frozen by each package (``est_state`` a pair of
    the two packages' estimator states, or None)."""
    sim = jqs.QueueSim(JTINY, seed=1, bg_horizon=0.0)
    sim.run_until(T0)
    table, row = jcompare.scenario_from_queue_sim(sim, max_jobs=MAX_JOBS)
    pol = kw.pop("policy")
    jpolicies.add_workflow(table, row, jworkflows.MONTAGE, 8, pol, t0=T0)
    base = dict(total_cores=JTINY.total_cores, free_cores=sim.free_cores,
                now=T0, policy=pol, t0=T0)
    jkw, tkw = dict(kw), dict(kw)
    if "est" in kw:
        jkw["est"], tkw["est"] = kw["est"]
    if "fault_sched" in kw:
        jkw["fault_sched"], tkw["fault_sched"] = kw["fault_sched"]
    want = jstate.freeze({k: v.copy() for k, v in table.items()},
                         **base, **jkw)
    got = X.freeze({k: v.copy() for k, v in table.items()}, **base, **tkw,
                   device="cpu")
    return got, jax.tree.map(lambda x: x[None], want)


@pytest.mark.parametrize("variant", ["default", "est", "greedy", "pilot",
                                     "faults"])
def test_freeze_equals_reference(variant):
    from repro.runtime import fault as jfault

    kw = {"default": dict(policy=X.ASA, est_seed=5),
          "est": dict(policy=X.ASA_NAIVE, est=(
              jasa.init(53, jax.random.PRNGKey(19)),
              asa.init(53, prng.PRNGKey(19)))),
          "greedy": dict(policy=X.ASA, pred_mode="greedy", max_stages=12),
          "pilot": dict(policy=X.PILOT, pilot_waste_cs=1234.5),
          "faults": dict(policy=X.PER_STAGE, n_faults=4, fault_sched=(
              jfault.FaultSchedule([
                  jfault.CapacityEvent(900.0, 0.25, jfault.FAULT_FAIL),
                  jfault.CapacityEvent(4000.0, 0.25, jfault.FAULT_GROW)]),
              FaultSchedule([CapacityEvent(900.0, 0.25, FAULT_FAIL),
                             CapacityEvent(4000.0, 0.25, FAULT_GROW)])))
          }[variant]
    got, want = _freeze_both(**kw)
    got, want = convert.to_numpy(got), convert.to_numpy(
        convert.scenario_state(want))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_freeze_refuses_what_is_not_ported():
    t = X.empty_table(8)
    # event tracing is ported: a capacity attaches a ring, a negative one
    # is refused
    traced = X.freeze(t, total_cores=8, free_cores=8, trace_capacity=16,
                      device="cpu")
    assert traced.trace.data.shape == (1, 16, 7)
    assert traced.trace.head.tolist() == [0]
    with pytest.raises(ValueError, match="trace_capacity"):
        X.freeze(t, total_cores=8, free_cores=8, trace_capacity=-1,
                 device="cpu")
    with pytest.raises(ValueError, match="pred_mode"):
        X.freeze(t, total_cores=8, free_cores=8, pred_mode="map",
                 device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            X.freeze(t, total_cores=8, free_cores=8)


def test_concat_keeps_lanes():
    a = X.freeze(X.empty_table(8), total_cores=8, free_cores=4, now=1.0,
                 device="cpu")
    b = X.freeze(X.empty_table(8), total_cores=16, free_cores=2, now=2.0,
                 policy=X.ASA, device="cpu")
    c = X.concat([a, b, a])
    assert c.status.shape == (3, 8) and c.est.log_p.shape == (3, 53)
    assert c.total.tolist() == [8.0, 16.0, 8.0]
    assert c.policy.tolist() == [X.BIGJOB, X.ASA, X.BIGJOB]
    rows = compare.wf_rows(c, lane=1)
    assert all(v.shape == (0,) for v in rows.values())

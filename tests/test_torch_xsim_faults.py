"""Capacity faults and the robustness families in the port's fleet
simulator, against the reference (CPU).

The reference's fault contracts (``tests/test_xsim_faults.py``) rerun on
the port, on the same hand-built states (``repro.xsim.state.add_job``,
``empty_table``, ``freeze``, given a batch axis of one), each final state
also held against the reference's: integer and event fields exact, float
fields within ``TIME_RTOL`` of ``test_torch_xsim``.

* FAIL kills the most recently started running jobs (LIFO) to cover the
  deficit, requeues them with their submit time kept and charges the lost
  core-seconds; DRAIN removes free cores now and collects the rest from
  completions (``cap_debt``); a drain clamps to the machine present;
  GROW admits previously too-wide work; free cores absorb a failure
  before any kill.
* An all-``+inf`` schedule through the faults program is bitwise the
  fault-free program; ``faults=False`` ignores an attached schedule; the
  ``clean`` family grid is bitwise a plain grid.
* Family grids (the port's own ``family_grid``) carry the reference's
  schedules, complete and conserve cores; schedules vary by seed.
* Invariants under random schedules (hypothesis): conservation
  ``total − free == Σ running``, ``free ≥ 0``, causality, and every due
  event consumed.
* ``run_grid`` + ``warm_fleet`` on a naive ``faulty`` family grid against
  the reference.
"""

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core.bins import make_bins
from repro.runtime import fault as jfault
from repro.sched.workflows import MONTAGE
from repro.xsim import events as jevents
from repro.xsim import families as jfamilies
from repro.xsim import grid as jgrid
from repro.xsim import policies as jpolicies
from repro.xsim import state as X
from repro.xsim.state import add_job, empty_table, freeze
from repro_torch import convert
from repro_torch.runtime import elastic as telastic
from repro_torch.runtime import fault as tfault
from repro_torch.xsim import compare as tcompare
from repro_torch.xsim import events as tevents
from repro_torch.xsim import families as tfamilies
from repro_torch.xsim import grid as tgrid
from repro_torch.xsim import policies as tpolicies
from test_torch_xsim import CFG_KW, _compare_states

jax.config.update("jax_threefry_partitionable", True)
torch.set_num_threads(1)   # small tensors: threads only contend

BINS = torch.as_tensor(make_bins(53), dtype=torch.float32)


def _batched(ref_state):
    """A reference state of one scenario as the port's batch of one."""
    return convert.scenario_state(
        jax.tree.map(lambda x: np.asarray(x)[None], ref_state))


def _both(ref_state, n_steps: int, **kw) -> tuple[dict, object]:
    """Simulate on both packages; hold the port's final state against the
    reference's. Returns it as {field: numpy array of one scenario} and
    as the port's state."""
    ref = jevents.simulate(ref_state, n_steps=n_steps, **kw)
    got = tevents.simulate(_batched(ref_state), n_steps=n_steps, naive=True,
                           **kw)
    g = convert.to_numpy(got)
    _compare_states(g, convert.to_numpy(_batched(ref)))
    return {k: v[0] for k, v in g.items()}, got


def _sched(*events):
    return jfault.FaultSchedule(tuple(events))


# ------------------------------------------------- deterministic semantics


def _two_running(total=8.0):
    """Two 4-core jobs running since t=0 / t=50, nothing else."""
    t = empty_table(8)
    add_job(t, 0, cores=4, duration=1000.0, submit=0.0, status=X.RUNNING,
            start=0.0, end=1000.0)
    add_job(t, 1, cores=4, duration=1000.0, submit=0.0, status=X.RUNNING,
            start=50.0, end=1050.0)
    return t, dict(total_cores=total, free_cores=0.0)


def test_fail_kills_lifo_requeues_and_charges_restart():
    t, kw = _two_running()
    add_job(t, 2, cores=4, duration=1000.0, submit=60.0, status=X.PENDING)
    s = freeze(t, **kw, fault_sched=_sched(jfault.fail(100.0, 0.5)))
    fin, state = _both(s, 40, faults=True)

    assert int(fin["restarts"]) == 1
    assert float(fin["restart_cs"]) == 200.0           # 4 cores × 50 s
    assert float(fin["total"]) == 4.0                  # 8 − 4 dead
    assert list(fin["status"][:3]) == [X.DONE, X.DONE, X.DONE]
    start = fin["start"]
    assert float(start[0]) == 0.0                      # survivor undisturbed
    assert float(fin["end"][0]) == 1000.0
    # the killed job restarts after the fault; its kept submit time wins
    # FCFS over the t=60 arrival
    assert float(start[1]) == 1000.0
    assert float(start[2]) == 2000.0
    assert float(fin["free"]) == float(fin["total"]) == 4.0
    m = tcompare.metrics(state)
    assert int(m["restarts"][0]) == 1
    assert float(m["restart_hours"][0]) == pytest.approx(200.0 / 3600.0)
    assert float(m["oh_hours"][0]) == pytest.approx(200.0 / 3600.0)


def test_fail_ties_go_to_the_lower_row():
    """Equal start times: the stable LIFO order kills the lower row."""
    t = empty_table(4)
    for row in (0, 1):
        add_job(t, row, cores=4, duration=1000.0, submit=0.0,
                status=X.RUNNING, start=50.0, end=1050.0)
    s = freeze(t, total_cores=8.0, free_cores=0.0,
               fault_sched=_sched(jfault.fail(100.0, 0.5)))
    fin, _ = _both(s, 40, faults=True)
    assert int(fin["restarts"]) == 1
    assert float(fin["start"][0]) == 1050.0            # row 0 killed
    assert float(fin["start"][1]) == 50.0


def test_drain_is_graceful_and_collects_debt_from_completions():
    t = empty_table(4)
    add_job(t, 0, cores=4, duration=500.0, submit=0.0, status=X.RUNNING,
            start=0.0, end=500.0)
    s = freeze(t, total_cores=8.0, free_cores=4.0,
               fault_sched=_sched(jfault.drain(100.0, 0.75)))
    fin, _ = _both(s, 20, faults=True)
    assert int(fin["restarts"]) == 0
    assert float(fin["end"][0]) == 500.0               # undisturbed
    assert int(fin["status"][0]) == X.DONE
    assert float(fin["cap_debt"]) == 0.0               # debt collected
    assert float(fin["total"]) == 2.0                  # 8 − 6 drained
    assert float(fin["free"]) == 2.0


def test_drain_clamps_to_machine_present():
    t = empty_table(4)
    add_job(t, 0, cores=4, duration=500.0, submit=0.0, status=X.RUNNING,
            start=0.0, end=500.0)
    s = freeze(t, total_cores=8.0, free_cores=4.0,
               fault_sched=_sched(jfault.drain(100.0, 1.0)))
    fin, _ = _both(s, 20, faults=True)
    assert int(fin["status"][0]) == X.DONE
    assert float(fin["total"]) == 0.0
    assert float(fin["free"]) == 0.0
    assert float(fin["cap_debt"]) == 0.0


def test_grow_admits_previously_too_wide_job():
    t = empty_table(4)
    add_job(t, 0, cores=12, duration=200.0, submit=0.0, status=X.PENDING)
    s = freeze(t, total_cores=8.0, free_cores=8.0,
               fault_sched=_sched(jfault.grow(100.0, 0.5)))
    fin, _ = _both(s, 20, faults=True)
    assert float(fin["start"][0]) == 100.0
    assert int(fin["status"][0]) == X.DONE
    assert float(fin["total"]) == 12.0
    assert float(fin["free"]) == 12.0


def test_free_cores_absorb_failure_before_kills():
    t = empty_table(4)
    add_job(t, 0, cores=4, duration=1000.0, submit=0.0, status=X.RUNNING,
            start=0.0, end=1000.0)
    s = freeze(t, total_cores=16.0, free_cores=12.0,
               fault_sched=_sched(jfault.fail(100.0, 0.5)))
    fin, _ = _both(s, 20, faults=True)
    assert int(fin["restarts"]) == 0
    assert float(fin["restart_cs"]) == 0.0
    assert float(fin["total"]) == 8.0
    assert float(fin["end"][0]) == 1000.0


def test_same_instant_events_run_in_schedule_order():
    """A grow and a fail due at one instant: both consumed in one step,
    in schedule order, the fail seeing the grown machine."""
    t, kw = _two_running()
    s = freeze(t, **kw, fault_sched=_sched(jfault.grow(100.0, 0.5),
                                           jfault.fail(100.0, 0.5)))
    fin, _ = _both(s, 40, faults=True)
    assert int(fin["fault_next"]) == 2
    assert int(fin["restarts"]) == 0                   # the grow covered it
    assert float(fin["total"]) == 8.0


# ------------------------------------------------- bit-identity contracts


def _workflow_scenario():
    t = empty_table(16)
    jpolicies.add_workflow(t, 0, MONTAGE, 28, X.PER_STAGE, t0=0.0)
    return t


def _states_equal(a, b, skip=("fault_t", "fault_c", "fault_k")) -> None:
    x, y = convert.to_numpy(a), convert.to_numpy(b)
    assert x.keys() == y.keys()
    for k in x:
        if k not in skip:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def test_dynamically_empty_schedule_is_bitwise_identical():
    t = _workflow_scenario()
    kw = dict(policy=X.PER_STAGE, total_cores=100.0, free_cores=100.0)
    a = tevents.simulate(_batched(freeze(t, **kw)), n_steps=48)
    sb = _batched(freeze(t, **kw, fault_sched=jfault.FaultSchedule(),
                         n_faults=2))
    b = tevents.simulate(sb, n_steps=48, faults=True)
    assert b.fault_t.shape == (1, 2) and bool(torch.isinf(b.fault_t).all())
    _states_equal(a, b)
    ma, mb = tcompare.metrics(a), tcompare.metrics(b)
    for k in ma:
        np.testing.assert_array_equal(ma[k].numpy(), mb[k].numpy())


def test_faults_false_statically_ignores_attached_schedule():
    t = _workflow_scenario()
    kw = dict(policy=X.PER_STAGE, total_cores=100.0, free_cores=100.0)
    a = tevents.simulate(_batched(freeze(t, **kw)), n_steps=48)
    sched = _sched(jfault.fail(500.0, 0.5))
    b = tevents.simulate(_batched(freeze(t, **kw, fault_sched=sched)),
                         n_steps=48)                     # faults NOT enabled
    assert int(b.fault_next[0]) == 0                     # never consumed
    _states_equal(a, b)


_CFG_KW = dict(n_warm=8, n_backlog=6, n_arrivals=8, max_stages=9, t0=1800.0)
_GRID_KW = dict(n_seeds=1, shrink=1 / 64.0, workflows=("statistics",),
                policy_ids=(0, 1, 2, 3))


def test_clean_family_grid_is_bitwise_identical_to_plain_grid():
    cfg = tgrid.XSimConfig(**_CFG_KW)
    g0 = tgrid.make_grid(cfg, device="cpu", **_GRID_KW)
    g1 = tfamilies.family_grid(cfg, "clean", device="cpu", **_GRID_KW)
    assert not g1.has_faults
    f0, m0 = tgrid.run_grid(g0, device="cpu")
    f1, m1 = tgrid.run_grid(g1, device="cpu")
    _states_equal(f0, f1, skip=())
    for k in m0:
        np.testing.assert_array_equal(m0[k].numpy(), m1[k].numpy())


@pytest.mark.parametrize("family", ["faulty", "elastic", "preempt"])
def test_family_grids_complete_and_conserve(family):
    cfg = tgrid.XSimConfig(**_CFG_KW)
    grid = tfamilies.family_grid(cfg, family, device="cpu", **_GRID_KW)
    ref = jfamilies.family_grid(jgrid.XSimConfig(**_CFG_KW), family,
                                **_GRID_KW)
    assert grid.has_faults and grid.labels == ref.labels
    assert grid.fault_t.shape[1] == tfamilies.N_FAULT_SLOTS[family]
    for f in ("fault_t", "fault_c", "fault_k"):   # the same schedules
        np.testing.assert_array_equal(getattr(grid, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    final, m = tgrid.run_grid(grid, device="cpu")
    fin = convert.to_numpy(final)
    np.testing.assert_array_equal(m["wf_done"].numpy(),
                                  m["wf_total"].numpy())
    n_real = np.sum(np.isfinite(fin["fault_t"]), axis=1)
    np.testing.assert_array_equal(fin["fault_next"], n_real)
    nxt = tevents.next_event_time(final, naive=True, faults=True)
    assert bool(torch.isinf(nxt).all())
    running = fin["status"] == X.RUNNING
    used = np.sum(np.where(running, fin["cores"], 0.0), axis=1)
    np.testing.assert_array_equal(used + fin["free"], fin["total"])
    assert float(fin["min_free"].min()) >= 0.0
    assert np.all(m["restart_hours"].numpy() >= 0.0)
    if family == "faulty":
        # fail then same-sized recovery: capacity returns to the original
        np.testing.assert_array_equal(fin["total"],
                                      grid.centers.total_cores.numpy())


_EMPTY = jfault.FaultSchedule()


def test_family_schedules_vary_by_seed():
    a = tfamilies.family_schedule("faulty", {"seed": 0}, t0=0.0)
    b = tfamilies.family_schedule("faulty", {"seed": 1}, t0=0.0)
    assert a.events[0].t != b.events[0].t
    assert tfamilies.family_schedule("clean", {"seed": 0}, t0=0.0) is None
    for fam in tfamilies.FAMILIES:
        sched = tfamilies.family_schedule(fam, {"seed": 2}, t0=0.0)
        want = jfamilies.family_schedule(fam, {"seed": 2}, t0=0.0)
        assert len(sched or ()) <= tfamilies.N_FAULT_SLOTS[fam]
        assert ([(e.t, e.frac, e.kind) for e in (sched or _EMPTY).events]
                == [(e.t, e.frac, e.kind) for e in (want or _EMPTY).events])
    with pytest.raises(ValueError, match="unknown family"):
        tfamilies.family_schedule("bogus", {}, t0=0.0)
    with pytest.raises(ValueError, match="unknown family"):
        tfamilies.family_grid(tgrid.XSimConfig(**_CFG_KW), "bogus",
                              device="cpu")
    with pytest.raises(ValueError, match="n_faults == 0"):
        tgrid.make_grid(tgrid.XSimConfig(**_CFG_KW), device="cpu",
                        fault_sched=tfault.FaultSchedule(), **_GRID_KW)


def test_resize_schedule_matches_reference():
    from repro.runtime.elastic import resize_schedule

    plan = [(10.0, -0.3), (20.0, 0.3), (30.0, -0.15)]
    for preempt in (False, True):
        got = telastic.resize_schedule(plan, preempt=preempt)
        want = resize_schedule(plan, preempt=preempt)
        assert ([(e.t, e.frac, e.kind) for e in got.events]
                == [(e.t, e.frac, e.kind) for e in want.events])
    with pytest.raises(ValueError, match="zero-delta"):
        telastic.resize_schedule([(5.0, 0.0)])


# --------------------------------------------------- property invariants

_MAX_JOBS = 16
_TOTAL = 64.0
_KINDS = (jfault.fail, jfault.drain, jfault.grow)


def _faulted_scenario(seed: int, fill: float, n_events: int):
    rng = np.random.default_rng(seed)
    t = empty_table(_MAX_JOBS)
    row, used = 0, 0.0
    for _ in range(int(rng.integers(0, 6))):
        c = float(rng.integers(1, 24))
        if used + c > fill * _TOTAL:
            break
        d = float(rng.uniform(50.0, 5000.0))
        add_job(t, row, cores=c, duration=d, submit=0.0, status=X.RUNNING,
                start=0.0, end=float(rng.uniform(1.0, d)))
        used += c
        row += 1
    for _ in range(int(rng.integers(1, 6))):
        add_job(t, row, cores=float(rng.integers(1, 32)),
                duration=float(rng.uniform(50.0, 4000.0)),
                submit=float(rng.uniform(0.0, 3000.0)), status=X.PENDING)
        row += 1
    events_ = tuple(
        _KINDS[int(rng.integers(0, 3))](float(rng.uniform(1.0, 6000.0)),
                                        float(rng.uniform(0.1, 0.6)))
        for _ in range(n_events))
    return freeze(t, total_cores=_TOTAL, free_cores=_TOTAL - used,
                  fault_sched=_sched(*events_))


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2**31 - 1), st.floats(0.1, 0.9), st.integers(1, 4))
def test_invariants_hold_under_random_fault_schedules(seed, fill, n_events):
    ref = _faulted_scenario(seed, fill, n_events)
    s = _batched(ref)
    for _ in range(80):
        # background jobs only: the program without the naive world
        s, _ = tevents.sim_step(s, BINS, faults=True)
        f = convert.to_numpy(s)
        running = f["status"][0] == X.RUNNING
        used = float(np.sum(np.where(running, f["cores"][0], 0.0)))
        # conservation (exact: whole cores) + never oversubscribed
        assert used + float(f["free"][0]) == float(f["total"][0])
        assert float(f["free"][0]) >= 0.0
        assert float(f["total"][0]) >= 0.0
        assert float(f["cap_debt"][0]) >= 0.0
        started = np.isfinite(f["start"][0])
        assert np.all(f["start"][0][started] >= f["submit"][0][started])
    ref = jevents.simulate(ref, n_steps=80, chunk_steps=0, faults=True)
    _compare_states(convert.to_numpy(s), convert.to_numpy(_batched(ref)))
    assert float(tevents.next_event_time(s, faults=True)[0]) == np.inf
    assert int(s.fault_next[0]) == n_events
    assert int(s.restarts[0]) >= 0 and float(s.restart_cs[0]) >= 0.0
    if int(s.restarts[0]) == 0:
        assert float(s.restart_cs[0]) == 0.0


# ----------------------------------------------- the user-facing path


def test_run_grid_with_warm_fleet_on_a_naive_faulty_grid():
    """family_grid (each package's own sampler), init_fleet, warm_fleet (3
    rounds), run_grid, on the ``faulty`` family with ASA-Naive beside ASA:
    identical per-geometry fleet keys, the Table-1 numbers within
    tolerance, and the integer counts (misses, restarts, wf_done) exact."""
    small = dict(n_seeds=2, shrink=1 / 64.0, policy_ids=(2, 3),
                 center_names=("hpc2n",), scales=(28, 112),
                 workflows=("montage",))
    grid = jfamilies.family_grid(jgrid.XSimConfig(**CFG_KW), "faulty",
                                 **small)
    fleet = jpolicies.init_fleet(int(grid.geo_idx.max()) + 1)
    fleet = jgrid.warm_fleet(fleet, grid, rounds=3)
    _, jm = jgrid.run_grid(grid, fleet, pred_seed=7)

    tg = tfamilies.family_grid(tgrid.XSimConfig(**CFG_KW), "faulty",
                               device="cpu", **small)
    tf = tpolicies.init_fleet(int(tg.geo_idx.max()) + 1, device="cpu")
    tf = tgrid.warm_fleet(tf, tg, rounds=3, device="cpu")
    _, tm = tgrid.run_grid(tg, tf, pred_seed=7, device="cpu")

    np.testing.assert_array_equal(tf.key.numpy(),
                                  np.asarray(fleet.key, np.int64))
    np.testing.assert_array_equal(tf.t.numpy(), np.asarray(fleet.t))
    for k in ("wf_done", "misses", "restarts"):
        np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(tm["wf_done"].numpy(),
                                  tm["wf_total"].numpy())
    assert int(tm["misses"].sum()) > 0 and int(tm["restarts"].sum()) > 0
    for k in ("twt_s", "makespan_s", "core_hours", "oh_hours",
              "utilization"):
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   rtol=1e-4, err_msg=k)

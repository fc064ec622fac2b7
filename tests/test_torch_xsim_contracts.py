"""The reference's scheduling contracts of the fleet simulator, rerun on
the port's own runs (CPU, the eager route).

Every table here is built with the port's ``xsim.state`` (``add_job``,
``empty_table``, ``freeze``: a batch of one scenario) and the port's
``sched`` copies, and every grid with the port's ``make_grid``; no state
is converted from the reference. The seeds, sizes, step budgets,
thresholds and hypothesis ``max_examples`` are the reference's. The
reference is imported nowhere: each contract is asserted on the port's
run alone.

* ``tests/test_xsim.py``: no over-allocation (and core conservation at
  the end of a busy sweep), FCFS order, EASY backfill that never delays
  the head (and backfill in the reservation's spare cores), a dependency
  that blocks a start, the step budget of chunked ``simulate`` (the
  truncated and the drained regime, chunks of 1, 8 and 64), the plain
  sorted scan and the O(n²) reference driving bitwise equal runs (and a
  bogus mode raising), the same for the reference's Pallas mode (here
  ``"ref"`` against ``"ref_n2"``; the ``freed_scan`` kernel against the
  plain scan is ``tests/test_torch_cuda.py``'s
  ``test_freed_kernel_mode_end_to_end_bitwise_plain``, on the card), the
  Theorem-1 regret bound of in-scan learning and no worse than the
  frozen MAP, and the §4.3 warm loop moving every estimator.
  ``test_vmapped_sweep_and_table1_ordering`` is not rerun: it fails on
  the reference itself (ROADMAP Queue 3).
* ``tests/test_xsim_grid_edges.py``: the five edge cases (empty
  products raise, a single-stage workflow, a BigJob-only warm loop is the
  identity, identical scenarios stay identical, bitwise determinism).
* ``tests/test_xsim_properties.py``: the invariants at every step of
  random small scenarios (hypothesis, 12 examples), on random full grids
  (5 examples), and a full default grid drained inside its budget.

The learning contracts can meet MAP near-ties where the port's last-bit
rounding differs from the reference's (ROADMAP Queue 3); they hold the
reference's inequalities on the port's own run, never equality with the
reference.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.core import asa, prng
from repro_torch.core.bins import make_bins
from repro_torch.core.losses import zero_one
from repro_torch.core.regret import empirical_regret, theorem1_bound
from repro_torch.sched.workflows import (BLAST, MONTAGE, STATISTICS, Stage,
                                         Workflow)
from repro_torch.xsim import events, policies
from repro_torch.xsim import state as X
from repro_torch.xsim.grid import (XSimConfig, make_grid, run_grid,
                                   stage_waits, warm_fleet)
from repro_torch.xsim.state import add_job, empty_table, freeze

torch.set_num_threads(1)   # small tensors: threads only contend

CPU = "cpu"
BINS = torch.as_tensor(make_bins(53), dtype=torch.float32)


def _np(x) -> np.ndarray:
    return x.cpu().numpy()


def _assert_states_equal(a, b) -> None:
    """Two final states (or metric dicts) bit for bit, field by field."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        pairs = [(a[k], b[k], k) for k in a]
    else:
        pairs = [(x, y, name) for x, y, name in zip(a, b, a._fields)]
    for x, y, name in pairs:
        if x is None:
            assert y is None, name
        elif isinstance(x, torch.Tensor):
            assert torch.equal(x, y), name
        else:
            _assert_states_equal(x, y)


# ------------------------------------------------------------ invariants
# (tests/test_xsim.py:185-329)


def _bare(total=100.0, free=100.0, max_jobs=16, policy=X.BIGJOB):
    return empty_table(max_jobs), dict(total_cores=total, free_cores=free,
                                       policy=policy, device=CPU)


def test_never_over_allocates():
    """min_free stays ≥ 0 across a busy random scenario sweep."""
    cfg = XSimConfig(n_warm=16, n_backlog=12, n_arrivals=16, max_stages=9,
                     t0=1800.0)
    grid = make_grid(cfg, n_seeds=2, shrink=1 / 128.0,
                     workflows=("montage",), device=CPU)
    final, m = run_grid(grid, device=CPU)
    assert float(final.min_free.min()) >= 0.0
    # conservation at the end of the sweep
    running = _np(final.status) == X.RUNNING
    used = np.sum(np.where(running, _np(final.cores), 0.0), axis=1)
    np.testing.assert_allclose(used + _np(final.free), _np(final.total),
                               rtol=1e-5)


def test_fcfs_order_respected():
    """Equal-width jobs start in submission order."""
    t, kw = _bare()
    for i, sub in enumerate((0.0, 10.0, 20.0, 30.0)):
        add_job(t, i, cores=60, duration=100.0, submit=sub, status=X.PENDING)
    fin = events.simulate(freeze(t, **kw), n_steps=30)
    starts = _np(fin.start[0, :4])
    assert np.all(np.diff(starts) > 0)  # 60-core jobs serialize, in order


def test_backfill_fills_without_delaying_head():
    """A short narrow job backfills ahead of a blocked wide head job,
    and the head still starts exactly at its reservation (shadow) time."""
    t, kw = _bare(free=40.0)
    # 60 cores busy until t=1000
    add_job(t, 0, cores=60, duration=1000.0, submit=0.0, status=X.RUNNING,
            start=0.0, end=1000.0)
    # head: wants 80 cores -> must wait for t=1000 (shadow)
    add_job(t, 1, cores=80, duration=500.0, submit=10.0, status=X.PENDING)
    # backfill candidate: 20 cores, drains before the shadow
    add_job(t, 2, cores=20, duration=400.0, submit=20.0, status=X.PENDING)
    # not backfillable: 30 cores > the spare 20 at the shadow, and it
    # runs past the shadow
    add_job(t, 3, cores=30, duration=5000.0, submit=30.0, status=X.PENDING)
    fin = events.simulate(freeze(t, **kw), n_steps=30)
    start = _np(fin.start[0])
    assert start[2] == 20.0          # backfilled immediately at submit
    assert start[1] == 1000.0        # head starts exactly at shadow time
    assert start[3] >= 1000.0        # long job could not jump the head


def test_backfill_in_spare_cores_of_reservation():
    """A long narrow job may still backfill if it fits the reservation's
    spare cores (EASY 'extra' rule)."""
    t, kw = _bare(free=40.0)
    add_job(t, 0, cores=60, duration=1000.0, submit=0.0, status=X.RUNNING,
            start=0.0, end=1000.0)
    add_job(t, 1, cores=80, duration=500.0, submit=10.0, status=X.PENDING)
    # 15 cores <= extra (100-80=20): backfills despite 5000s duration
    add_job(t, 2, cores=15, duration=5000.0, submit=20.0, status=X.PENDING)
    fin = events.simulate(freeze(t, **kw), n_steps=30)
    assert float(fin.start[0, 2]) == 20.0
    assert float(fin.start[0, 1]) == 1000.0


def test_dependency_blocks_start():
    t, kw = _bare()
    add_job(t, 0, cores=10, duration=500.0, submit=0.0, status=X.PENDING)
    add_job(t, 1, cores=10, duration=100.0, submit=0.0, status=X.PENDING,
            start_dep=0)
    fin = events.simulate(freeze(t, **kw), n_steps=30)
    assert float(fin.start[0, 1]) >= float(fin.end[0, 0]) == 500.0


def test_chunked_simulate_respects_step_budget():
    """Chunked and unchunked simulate are bitwise identical in both
    regimes: truncated (3 steps of budget with events left: never more
    than exactly ``n_steps`` steps, a budget that is not a chunk multiple
    not rounded up) and drained (extra chunk steps are no-ops)."""
    t, kw = _bare()
    for i, sub in enumerate((0.0, 500.0, 1000.0, 1500.0, 2000.0)):
        add_job(t, i, cores=60, duration=100.0, submit=sub,
                status=X.PENDING)
    st_ = freeze(t, **kw)
    a = events.simulate(st_, n_steps=3, chunk_steps=0)
    b = events.simulate(st_, n_steps=3)
    _assert_states_equal(a, b)
    assert int(b.steps[0]) == 3
    assert bool(torch.isfinite(events.next_event_time(b)).all())
    c = events.simulate(st_, n_steps=40, chunk_steps=0)
    for k in (1, 8, 64):
        _assert_states_equal(c, events.simulate(st_, n_steps=40,
                                                chunk_steps=k))


def test_freed_mode_ref_n2_end_to_end():
    """The sorted default and the retained O(n²) reference drive bitwise
    identical simulations; a bogus mode raises."""
    t, _ = _bare()
    policies.add_workflow(t, 0, MONTAGE, 28, X.PER_STAGE, t0=0.0)
    st_ = freeze(t, policy=X.PER_STAGE, total_cores=100.0, free_cores=100.0,
                 device=CPU)
    a = events.simulate(st_, n_steps=48)
    b = events.simulate(st_, n_steps=48, freed_mode="ref_n2")
    _assert_states_equal(a, b)
    with pytest.raises(ValueError, match="freed mode"):
        events.simulate(st_, n_steps=8, freed_mode="bogus")


def test_pallas_freed_mode_end_to_end():
    """The reference's Pallas-mode case on the CPU: statistics under
    per-stage, the plain sorted scan (``"ref"``, the CPU's default)
    against the O(n²) reference, bitwise."""
    t, _ = _bare()
    policies.add_workflow(t, 0, STATISTICS, 28, X.PER_STAGE, t0=0.0)
    st_ = freeze(t, policy=X.PER_STAGE, total_cores=100.0, free_cores=100.0,
                 device=CPU)
    a = events.simulate(st_, n_steps=40)
    b = events.simulate(st_, n_steps=40, freed_mode="ref")
    c = events.simulate(st_, n_steps=40, freed_mode="ref_n2")
    _assert_states_equal(a, b)
    _assert_states_equal(a, c)


# ------------------------------------------------- in-scan learning
# (tests/test_xsim.py:395-520)


def test_within_run_learning_regret_convergence():
    """Theorem-1 regression for in-scan learning (paper Appendix A): a
    3-round warm-started sweep learns inside the scan (ASA scenarios
    only), its per-geometry wait sequence keeps the tuned estimator's
    empirical regret under the Theorem-1 bound, and learning beats the
    frozen cold-MAP predictor."""
    cfg = XSimConfig(n_warm=16, n_backlog=12, n_arrivals=16, max_stages=9,
                     t0=1800.0)
    grid = make_grid(cfg, n_seeds=4, shrink=1 / 64.0,
                     workflows=("statistics",), policy_ids=(1, 2),
                     device=CPU)
    n_geo = int(grid.geo_idx.max()) + 1
    fleet = policies.init_fleet(n_geo, device=CPU)
    fleet = warm_fleet(fleet, grid, rounds=3, device=CPU)
    final, _ = run_grid(grid, fleet, device=CPU)

    # (a) the scan carried the estimator: only ASA scenarios learned
    init_t = _np(fleet.t)[grid.geo_idx]
    est_t = _np(final.est.t)
    strat = np.array([lab["strategy"] for lab in grid.labels])
    is_asa = strat == "asa"
    assert np.all(est_t[is_asa] > init_t[is_asa])
    assert np.all(est_t[~is_asa] == init_t[~is_asa])

    # (b) + (c): replay the 3-round observation sequence per geometry
    seqs: list[list[float]] = [[] for _ in range(n_geo)]
    replay_fleet = policies.init_fleet(n_geo, device=CPU)
    for r in range(3):
        rf, _ = run_grid(grid, replay_fleet, pred_seed=100 + r, device=CPU)
        w_r, v_r = stage_waits(rf, cfg)
        for g in range(n_geo):
            sel = (grid.geo_idx == g) & is_asa
            seqs[g].extend(w_r[sel][v_r[sel]].tolist())
        W = np.zeros((n_geo, 8), np.float32)
        V = np.zeros((n_geo, 8), bool)
        for g in range(n_geo):
            w = w_r[(grid.geo_idx == g) & is_asa, 0]
            w = w[v_r[(grid.geo_idx == g) & is_asa, 0]][:8]
            W[g, :len(w)] = w
            V[g, :len(w)] = True
        replay_fleet = policies.update_fleet(
            replay_fleet, torch.as_tensor(W), torch.as_tensor(V))
    cold = asa.init(53, prng.PRNGKey(0))
    a_frozen = int(torch.argmax(cold.log_p))   # cold MAP, fixed
    g_one = torch.tensor(1.0, dtype=torch.float32)
    total_adaptive = total_frozen = 0.0
    for g in range(n_geo):
        ws = seqs[g]
        if not ws:
            continue
        L = np.stack([zero_one(BINS, torch.tensor(max(w, 1.0),
                                                  dtype=torch.float32))
                      .numpy() for w in ws])
        state = cold
        eta0 = int(state.rounds)
        chosen = []
        for lv in L:
            # live-MAP decision, tuned §4.5 learning from the observed wait
            chosen.append(lv[int(torch.argmax(state.log_p))])
            state, _ = asa.step(state, torch.from_numpy(lv), g_one,
                                policy="tuned")
        r_adaptive = empirical_regret(np.asarray(chosen), L)
        assert r_adaptive <= theorem1_bound(
            len(chosen), 53, int(state.rounds) - eta0)
        total_adaptive += r_adaptive
        total_frozen += empirical_regret(L[:, a_frozen], L)
    # learning while running beats the frozen cold-MAP predictor
    assert total_adaptive <= total_frozen


def test_stage_waits_and_fleet_learning():
    """warm_fleet moves each geometry's MAP estimate toward its observed
    first-stage wait decade (the §4.3 cross-run persistence loop)."""
    cfg = XSimConfig(n_warm=16, n_backlog=12, n_arrivals=16, max_stages=9,
                     t0=1800.0)
    grid = make_grid(cfg, n_seeds=2, shrink=1 / 64.0,
                     workflows=("statistics",), device=CPU)
    fleet0 = policies.init_fleet(int(grid.geo_idx.max()) + 1, device=CPU)
    fleet = warm_fleet(fleet0, grid, rounds=2, device=CPU)
    # distributions moved away from uniform
    assert not np.allclose(_np(fleet.log_p), _np(fleet0.log_p))
    final, _ = run_grid(grid, fleet, device=CPU)
    waits, valid = stage_waits(final, cfg)
    assert waits.shape == (grid.n, cfg.max_stages)
    assert valid.any()


# ------------------------------------------------------------ grid edges
# (tests/test_xsim_grid_edges.py)

EDGE_CFG = XSimConfig(n_warm=12, n_backlog=8, n_arrivals=12, max_stages=9,
                      t0=1800.0)
SOLO = Workflow("solo", (Stage("only", True, 600.0, 0.5),))


def test_make_grid_empty_product_raises():
    with pytest.raises(ValueError, match="empty scenario grid"):
        make_grid(EDGE_CFG, workflows=(), device=CPU)
    with pytest.raises(ValueError, match="empty scenario grid"):
        make_grid(EDGE_CFG, policy_ids=(), workflows=("statistics",),
                  device=CPU)
    with pytest.raises(ValueError, match="empty scenario grid"):
        make_grid(EDGE_CFG, n_seeds=0, workflows=("statistics",),
                  device=CPU)


def test_single_stage_workflow_runs_and_reports():
    """A 1-stage workflow exercises the no-successor chain-hook path:
    stage_waits marks exactly one valid column and warm_fleet still
    learns from it."""
    grid = make_grid(EDGE_CFG, center_names=("hpc2n",), workflows=(SOLO,),
                     policy_ids=(1, 2), n_seeds=2, scales=(28,), device=CPU)
    assert all(lab["workflow"] == "solo" for lab in grid.labels)
    final, m = run_grid(grid, device=CPU)
    assert np.all(_np(m["wf_done"]) == 1)
    assert np.all(_np(m["wf_total"]) == 1)
    waits, valid = stage_waits(final, EDGE_CFG)
    assert waits.shape == (grid.n, EDGE_CFG.max_stages)
    assert valid[:, 0].all() and not valid[:, 1:].any()
    # with one stage, perceived wait == the single stage's queue wait
    np.testing.assert_allclose(_np(m["twt_s"]), waits[:, 0], rtol=1e-5,
                               atol=1e-3)
    fleet0 = policies.init_fleet(int(grid.geo_idx.max()) + 1, device=CPU)
    fleet = warm_fleet(fleet0, grid, rounds=1, device=CPU)
    assert not np.allclose(_np(fleet.log_p), _np(fleet0.log_p))


def test_warm_fleet_no_stagelike_scenarios_is_identity():
    """A BigJob-only grid offers no clean stage-0 samples: the §4.3 loop
    leaves every geometry's estimator untouched (masked update)."""
    grid = make_grid(EDGE_CFG, center_names=("hpc2n",),
                     workflows=("statistics",), policy_ids=(0,),
                     n_seeds=2, scales=(28,), device=CPU)
    fleet0 = policies.init_fleet(int(grid.geo_idx.max()) + 1, device=CPU)
    fleet = warm_fleet(fleet0, grid, rounds=2, device=CPU)
    assert torch.equal(fleet.log_p, fleet0.log_p)
    assert torch.equal(fleet.t, fleet0.t)


def test_all_scenarios_identical_stay_identical():
    """Batch purity: clones of one scenario (same background key, same
    cell) produce identical rows through the whole batched sweep."""
    grid = make_grid(EDGE_CFG, center_names=("hpc2n",),
                     workflows=("statistics",), policy_ids=(X.PER_STAGE,),
                     n_seeds=4, scales=(28,), device=CPU)
    grid.keys = grid.keys[:1].repeat(grid.n, 1)
    final, m = run_grid(grid, pred_seed=3, device=CPU)
    for name, arr in m.items():
        a = _np(arr)
        np.testing.assert_array_equal(
            a, np.broadcast_to(a[:1], a.shape),
            err_msg=f"metric {name} diverged across identical scenarios")
    waits, valid = stage_waits(final, EDGE_CFG)
    np.testing.assert_array_equal(waits, np.broadcast_to(waits[:1],
                                                         waits.shape))
    np.testing.assert_array_equal(valid, np.broadcast_to(valid[:1],
                                                         valid.shape))


def test_run_grid_bitwise_deterministic():
    """Fixed seeds: the whole sweep is bitwise reproducible: final states,
    metrics and the §4.3 warm loop all replay exactly."""
    grid = make_grid(EDGE_CFG, workflows=("statistics", "montage"),
                     policy_ids=(0, 1, 2), n_seeds=2, device=CPU)
    fleet = policies.init_fleet(int(grid.geo_idx.max()) + 1, device=CPU)
    fa, ma = run_grid(grid, fleet, pred_seed=11, device=CPU)
    fb, mb = run_grid(grid, fleet, pred_seed=11, device=CPU)
    _assert_states_equal(ma, mb)
    _assert_states_equal(fa, fb)
    wa = warm_fleet(fleet, grid, rounds=2, device=CPU)
    wb = warm_fleet(fleet, grid, rounds=2, device=CPU)
    _assert_states_equal(wa, wb)


# ------------------------------------------------------------ properties
# (tests/test_xsim_properties.py)

MAX_JOBS = 24
TOTAL = 64.0
N_STEPS = 70
PROP_POLICIES = (X.BIGJOB, X.PER_STAGE, X.ASA, X.ASA_NAIVE)
PROP_WORKFLOWS = (STATISTICS, BLAST, MONTAGE)

# forward edges of the ladder + the two explicit naive cancel edges
_EDGES = {
    (X.PENDING, X.QUEUED), (X.QUEUED, X.RUNNING), (X.RUNNING, X.DONE),
    (X.RUNNING, X.CANCELLED),   # naive miss: cancel at start instant
    (X.CANCELLED, X.QUEUED),    # naive resubmission re-enters the queue
}
# one step composes several edges at the same instant, in the step's
# fixed order (releases, admissions, the scheduling pass, the cancel
# hook): admit+start, admit+start+cancel, resubmit+start
_ALLOWED = _EDGES | {
    (X.PENDING, X.RUNNING), (X.PENDING, X.CANCELLED),
    (X.QUEUED, X.CANCELLED), (X.CANCELLED, X.RUNNING),
}


def _random_scenario(seed: int, policy_i: int, fill: float):
    """A small random machine + backlog + one workflow, host-built."""
    rng = np.random.default_rng(seed)
    policy = PROP_POLICIES[policy_i % len(PROP_POLICIES)]
    wf = PROP_WORKFLOWS[seed % len(PROP_WORKFLOWS)]
    t = empty_table(MAX_JOBS)
    row = 0
    used = 0.0
    for _ in range(int(rng.integers(0, 7))):          # warm-start running
        c = float(rng.integers(1, 24))
        if used + c > fill * TOTAL:
            break
        d = float(rng.uniform(50.0, 5000.0))
        add_job(t, row, cores=c, duration=d, submit=0.0, status=X.RUNNING,
                start=0.0, end=float(rng.uniform(1.0, d)))
        used += c
        row += 1
    for _ in range(int(rng.integers(0, 6))):          # queued backlog
        add_job(t, row, cores=float(rng.integers(1, 32)),
                duration=float(rng.uniform(50.0, 5000.0)), submit=0.0,
                status=X.QUEUED)
        row += 1
    for _ in range(int(rng.integers(0, 5))):          # future arrivals
        add_job(t, row, cores=float(rng.integers(1, 32)),
                duration=float(rng.uniform(50.0, 5000.0)),
                submit=float(rng.uniform(1.0, 4000.0)), status=X.PENDING)
        row += 1
    t0 = float(rng.uniform(0.0, 2000.0))
    policies.add_workflow(t, row, wf, 8, policy, t0=t0)
    mode = "sample" if seed % 2 else "greedy"
    return freeze(t, total_cores=TOTAL, free_cores=TOTAL - used,
                  policy=policy, t0=t0, est_seed=seed, pred_mode=mode,
                  device=CPU), policy


@settings(max_examples=12, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(0, 3), st.floats(0.1, 0.95))
def test_invariants_hold_at_every_step(seed, policy_i, fill):
    s, policy = _random_scenario(seed, policy_i, fill)
    naive = policy == X.ASA_NAIVE
    prev_status = _np(s.status[0])
    for _ in range(N_STEPS):
        s, left = events.sim_step(s, BINS, naive=naive)
        assert left is None or not bool(left)
        status = _np(s.status[0])
        cores = _np(s.cores[0])
        free = float(s.free[0])
        # --- core conservation, never over capacity -------------------
        used = float(np.sum(np.where(status == X.RUNNING, cores, 0.0)))
        assert used + free == pytest.approx(float(s.total[0]), abs=1e-3)
        assert free >= -1e-3
        assert float(s.min_free[0]) >= -1e-3
        # --- status ladder only moves along allowed edges -------------
        for a, b in zip(prev_status, status):
            if a != b:
                assert (int(a), int(b)) in _ALLOWED, (int(a), int(b))
        prev_status = status
        # --- causality ------------------------------------------------
        start = _np(s.start[0])
        submit = _np(s.submit[0])
        started = np.isfinite(start)
        assert np.all(start[started] >= submit[started] - 1e-3)
    # --- the in-scan estimator is still a normalized distribution -----
    assert bool(torch.isfinite(s.est.log_p).all())
    assert abs(float(torch.logsumexp(s.est.log_p[0], dim=-1))) < 1e-3


_GRID_CFG = XSimConfig(n_warm=8, n_backlog=6, n_arrivals=8, max_stages=9,
                       t0=1800.0)


@settings(max_examples=5, deadline=None)
@given(st.integers(0, 2**31 - 1))
def test_grid_sweep_invariants(seed):
    """Random full grids (all four policies) keep capacity and completion
    invariants through the batched sweep."""
    grid = make_grid(_GRID_CFG, n_seeds=1, shrink=1 / 128.0,
                     workflows=("statistics",), policy_ids=(0, 1, 2, 3),
                     seed=seed, device=CPU)
    final, m = run_grid(grid, device=CPU)
    assert float(final.min_free.min()) >= 0.0
    running = _np(final.status) == X.RUNNING
    used = np.sum(np.where(running, _np(final.cores), 0.0), axis=1)
    np.testing.assert_allclose(used + _np(final.free), _np(final.total),
                               rtol=1e-5)
    # every scenario's workflow finished inside the static step budget
    assert np.all(_np(m["wf_done"]) == _np(m["wf_total"]))
    # OH only ever accrues on the naive policy
    oh = _np(m["oh_hours"])
    pol = _np(m["policy"])
    assert np.all(oh[pol != X.ASA_NAIVE] == 0.0)
    assert np.all(oh >= 0.0)


def test_full_grid_drains_within_budget():
    """Every scenario of a full default ``make_grid`` sweep (all centers,
    scales, workflows and the naive cancel/resubmit policy) has no event
    left at budget end: the ``n_steps`` formula truncates nothing. The
    per-scenario ``steps`` counter sits below the budget on average and
    never above it."""
    cfg = XSimConfig(n_warm=16, n_backlog=12, n_arrivals=16, max_stages=9,
                     t0=3600.0)
    grid = make_grid(cfg, n_seeds=2, shrink=1 / 64.0,
                     policy_ids=(0, 1, 2, 3), device=CPU)
    final, m = run_grid(grid, device=CPU)
    nxt = _np(events.next_event_time(final, naive=True))
    assert np.all(np.isinf(nxt)), (
        f"{int(np.sum(np.isfinite(nxt)))} scenarios still had events at "
        f"budget end (n_steps={cfg.n_steps})")
    assert np.all(_np(m["wf_done"]) == _np(m["wf_total"]))
    steps = _np(final.steps)
    assert int(steps.max()) <= cfg.n_steps
    assert float(steps.mean()) < cfg.n_steps  # budget-bound no more

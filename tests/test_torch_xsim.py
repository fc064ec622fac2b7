"""The port's fleet simulator against the reference, as a whole (CPU).

A reference-built grid (both centers, their three scales, the three
workflows, policies 0, 1, 2 and 5, one seed) is carried across with
``repro_torch.convert`` and swept by both packages, greedy and sampled.

* Integer and event fields are exact: status, steps, wf_done, misses,
  the estimator's key and counters, and each scenario's start order.
* Float fields agree within ``TIME_RTOL`` (relative to max(|x|, 1)):
  measured worst case 0.0 for times and tables, 1.6e-7 for busy_cs and
  1.3e-6 for log_p; metrics within ``METRIC_RTOL``, measured worst case
  1.4e-7 (summation order of the core-second and utilization sums).

The port's own grid sampler (``make_grid``) is compared with the
reference's: bitwise, every field (its draws go through XLA's float32
exp, erfinv, log, log1p and cumsum, ``core.xla_f32``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.xsim import compare as jcompare
from repro.xsim import events as jevents
from repro.xsim import grid as jgrid
from repro.xsim import policies as jpolicies
from repro_torch import convert
from repro_torch.xsim import compare as tcompare
from repro_torch.xsim import events as tevents
from repro_torch.xsim import grid as tgrid
from repro_torch.xsim import policies as tpolicies

jax.config.update("jax_threefry_partitionable", True)
torch.set_num_threads(1)   # small tensors: threads only contend

TIME_RTOL = 1e-5
METRIC_RTOL = 1e-5
EXACT = ("status", "steps", "misses", "start_pending", "chain_pending",
         "est.key", "est.t", "est.rounds", "policy", "rl_act",
         "start_dep", "wf_next", "wf_rows", "is_wf", "repass")

CFG_KW = dict(n_warm=16, n_backlog=12, n_arrivals=16, max_stages=9,
              t0=1800.0)
POLICIES = (0, 1, 2, 5)


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    fin = np.isfinite(b)
    np.testing.assert_array_equal(np.isfinite(a), fin)
    np.testing.assert_array_equal(a[~fin], b[~fin])
    if not fin.any():
        return 0.0
    return float(np.max(np.abs(a[fin] - b[fin])
                        / np.maximum(np.abs(b[fin]), 1.0)))


def _compare_states(got: dict, want: dict) -> dict:
    assert got.keys() == want.keys()
    errs = {}
    for k in want:
        if k in EXACT or want[k].dtype.kind in "biu":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            errs[k] = _rel(got[k], want[k])
            assert errs[k] <= TIME_RTOL, (k, errs[k])
    # start order: which jobs started, in which order, per scenario
    order_got = np.argsort(got["start"], axis=1, kind="stable")
    order_want = np.argsort(want["start"], axis=1, kind="stable")
    np.testing.assert_array_equal(order_got, order_want)
    return errs


@pytest.fixture(scope="module")
def reference_grid():
    cfg = jgrid.XSimConfig(**CFG_KW)
    grid = jgrid.make_grid(cfg, n_seeds=1, shrink=1 / 64.0,
                           policy_ids=POLICIES)
    fleet = jpolicies.init_fleet(int(grid.geo_idx.max()) + 1)
    ests = jpolicies.scenario_estimators(fleet, jnp.asarray(grid.geo_idx), 1)
    return cfg, grid, grid.build(ests)


@pytest.mark.parametrize("pred_mode", ["greedy", "sample"])
def test_sweep_matches_reference(reference_grid, pred_mode):
    cfg, _, st = reference_grid
    ref = jevents.sweep(st, n_steps=cfg.n_steps, chunk_steps=cfg.chunk_steps,
                        pred_mode=pred_mode, naive=False, faults=False)
    ref_m = jcompare.batched_metrics(ref)
    got = tevents.sweep(convert.scenario_state(jax.tree.map(np.asarray, st)),
                        n_steps=cfg.n_steps, chunk_steps=cfg.chunk_steps,
                        pred_mode=pred_mode, device="cpu")
    want = convert.to_numpy(convert.scenario_state(
        jax.tree.map(np.asarray, ref)))
    _compare_states(convert.to_numpy(got), want)
    # every workflow finished inside the budget, in both packages
    got_m = tcompare.batched_metrics(got)
    for k, v in ref_m.items():
        a, b = got_m[k].numpy(), np.asarray(v)
        if b.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            assert _rel(a, b) <= METRIC_RTOL, k
    np.testing.assert_array_equal(got_m["wf_done"].numpy(),
                                  got_m["wf_total"].numpy())


def test_chunking_is_invisible(reference_grid):
    """Every chunk size gives the unchunked result bit for bit, in the
    truncated regime too (a budget that is not a chunk multiple)."""
    cfg, _, st = reference_grid
    base = convert.scenario_state(jax.tree.map(np.asarray, st))
    for n_steps in (13, 60):
        runs = [convert.to_numpy(tevents.sweep(
            base, n_steps=n_steps, chunk_steps=k, pred_mode="greedy",
            device="cpu")) for k in (0, 1, 8)]
        for other in runs[1:]:
            for k in runs[0]:
                np.testing.assert_array_equal(other[k], runs[0][k],
                                              err_msg=k)
    assert int(runs[0]["steps"].max()) <= 60


def test_drained_lanes_are_no_ops(reference_grid):
    """A drained batch steps as an exact no-op: time, keys, tables."""
    cfg, _, st = reference_grid
    base = convert.scenario_state(jax.tree.map(np.asarray, st))
    fin = tevents.sweep(base, n_steps=cfg.n_steps, pred_mode="sample",
                        device="cpu")
    assert not torch.isfinite(tevents.next_event_time(fin)).any()
    more = tevents.sweep(fin, n_steps=8, chunk_steps=0, pred_mode="sample",
                         device="cpu")
    a, b = convert.to_numpy(fin), convert.to_numpy(more)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_hook_drain_bound_is_guarded(reference_grid):
    """The one-pair hook drain raises (at the chunk's host sync) instead
    of running on if a lane ever has two hooks pending in one step."""
    cfg, _, st = reference_grid
    base = convert.scenario_state(jax.tree.map(np.asarray, st))
    pending = base.start_pending.clone()
    pending[0, :2] = True
    with pytest.raises(RuntimeError, match="hook pending"):
        tevents.sweep(base._replace(start_pending=pending), n_steps=8,
                      pred_mode="greedy", device="cpu")


def test_run_grid_with_warm_fleet_matches_reference():
    """The whole user-facing path: make_grid (port's own sampler),
    init_fleet, warm_fleet (3 rounds), run_grid. Both packages build
    from their own samplers here, so the comparison is of the Table-1
    numbers within tolerance, plus identical per-geometry fleet keys."""
    cfg = jgrid.XSimConfig(**CFG_KW)
    small = dict(n_seeds=2, shrink=1 / 64.0, policy_ids=(0, 1, 2),
                 center_names=("hpc2n",), scales=(28, 112),
                 workflows=("blast",))
    grid = jgrid.make_grid(cfg, **small)
    fleet = jpolicies.init_fleet(int(grid.geo_idx.max()) + 1)
    fleet = jgrid.warm_fleet(fleet, grid, rounds=3)
    _, jm = jgrid.run_grid(grid, fleet, pred_seed=7)

    tcfg = tgrid.XSimConfig(**CFG_KW)
    tg = tgrid.make_grid(tcfg, device="cpu", **small)
    tf = tpolicies.init_fleet(int(tg.geo_idx.max()) + 1, device="cpu")
    tf = tgrid.warm_fleet(tf, tg, rounds=3, device="cpu")
    _, tm = tgrid.run_grid(tg, tf, pred_seed=7, device="cpu")

    np.testing.assert_array_equal(tf.key.numpy(),
                                  np.asarray(fleet.key, np.int64))
    np.testing.assert_array_equal(tf.t.numpy(), np.asarray(fleet.t))
    np.testing.assert_array_equal(tm["wf_done"].numpy(),
                                  np.asarray(jm["wf_done"]))
    for k in ("twt_s", "makespan_s", "core_hours", "utilization"):
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   rtol=1e-4, err_msg=k)


def test_own_grid_sampler_matches_reference(reference_grid):
    """The port's make_grid + build_batch against the reference's: keys,
    integer fields, cores, times and durations bit for bit."""
    cfg, grid, st = reference_grid
    tg = tgrid.make_grid(tgrid.XSimConfig(**CFG_KW), n_seeds=1,
                         shrink=1 / 64.0, policy_ids=POLICIES, device="cpu")
    np.testing.assert_array_equal(tg.keys.numpy(),
                                  np.asarray(grid.keys, np.int64))
    np.testing.assert_array_equal(tg.geo_idx, grid.geo_idx)
    assert tg.labels == grid.labels
    tf = tpolicies.init_fleet(int(tg.geo_idx.max()) + 1, device="cpu")
    ests = tpolicies.scenario_estimators(tf, torch.as_tensor(tg.geo_idx), 1)
    got = convert.to_numpy(tg.build(ests))
    # build_scenario is build_batch on a batch of one
    i = 5
    one = convert.to_numpy(tgrid.build_scenario(
        tg.keys[i], tgrid.XCenter(*(c[i] for c in tg.centers)),
        tg.wf_cores[i], tg.wf_durs[i], tg.wf_valid[i],
        type(ests)(*(f[i] for f in ests)), tg.policies[i], tg.fault_t[i],
        tg.fault_c[i], tg.fault_k[i], tg.cfg))
    for k in one:
        np.testing.assert_array_equal(one[k][0], got[k][i], err_msg=k)
    want = convert.to_numpy(convert.scenario_state(
        jax.tree.map(np.asarray, st)))
    assert got.keys() == want.keys()
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if a.dtype.kind == "f":
            a, b = a.view(np.uint32), b.view(np.uint32)
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_unported_programs_raise(reference_grid):
    """The learned policy's programs refuse what the reference refuses: a
    grid with policy id 4 and no ``params``, and an unknown ``rl_mode``
    (at ``run_grid`` and at ``sweep``)."""
    from repro_torch.core import prng
    from repro_torch.rl import policy as rl_policy

    cfg, _, st = reference_grid
    base = convert.scenario_state(jax.tree.map(np.asarray, st))
    params = rl_policy.init_params(prng.PRNGKey(0), device="cpu")
    with pytest.raises(ValueError, match="rl_mode"):
        tevents.sweep(base, n_steps=4, device="cpu", params=params,
                      rl_mode="bogus")
    rl = tgrid.make_grid(tgrid.XSimConfig(**CFG_KW), policy_ids=(4,),
                         n_seeds=1, device="cpu")
    with pytest.raises(ValueError, match="params"):
        tgrid.run_grid(rl, device="cpu")
    with pytest.raises(ValueError, match="rl_mode"):
        tgrid.run_grid(rl, params=params, rl_mode="bogus", device="cpu")


def _replayed_waits(G, P, to, **dev) -> np.ndarray:
    """The regret contract's replay (``tests/test_xsim.py``'s in-scan
    learning test): three sweeps of the ASA scenarios of a 4-seed grid,
    each from a fleet updated on the last one's first-stage waits; every
    observed stage wait, geometry by geometry."""
    cfg = G.XSimConfig(**CFG_KW)
    grid = G.make_grid(cfg, n_seeds=4, shrink=1 / 64.0,
                       workflows=("statistics",), policy_ids=(1, 2), **dev)
    is_asa = np.array([lab["strategy"] == "asa" for lab in grid.labels])
    n_geo = int(grid.geo_idx.max()) + 1
    seqs = [[] for _ in range(n_geo)]
    fleet = P.init_fleet(n_geo, **dev)
    for r in range(3):
        final, _ = G.run_grid(grid, fleet, pred_seed=100 + r, **dev)
        w, v = G.stage_waits(final, cfg)
        W = np.zeros((n_geo, 8), np.float32)
        V = np.zeros((n_geo, 8), bool)
        for g in range(n_geo):
            sel = (grid.geo_idx == g) & is_asa
            seqs[g].extend(w[sel][v[sel]].tolist())
            first = w[sel, 0][v[sel, 0]][:8]
            W[g, :len(first)] = first
            V[g, :len(first)] = True
        fleet = P.update_fleet(fleet, to(W), to(V))
    return np.array([x for s in seqs for x in s], np.float32)


def test_replayed_waits_bitwise_the_reference():
    """The port's own grids and sweeps (no state carried across) observe
    the reference's stage waits bit for bit: all 288 of the replay (279
    while the grid's draws took torch's log1p and exp)."""
    want = _replayed_waits(jgrid, jpolicies, jnp.asarray)
    got = _replayed_waits(tgrid, tpolicies, torch.as_tensor, device="cpu")
    assert len(want) == 288
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))

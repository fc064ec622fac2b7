"""ASA-Naive's cancel/resubmit world and the multi-iteration hook drain of
the port's fleet simulator, against the reference (CPU).

* Reference-built grids of every robustness family (both centers, three
  scales, three workflows, policies 0, 1, 2, 3 and 5, two seeds) are
  carried across with ``repro_torch.convert`` and swept by both packages
  in the naive program (``naive=True``, ``faults`` as the grid has
  them), greedy and sampled. Integer and event fields are exact (status,
  steps, misses, restarts, ``fault_next``, ``repass``, the estimator's
  key, the start order); float fields (``hold``, ``canc_start``,
  ``oh_cs``, ``cap_debt``, ``restart_cs`` among them) within
  ``TIME_RTOL`` and the metrics within ``METRIC_RTOL`` of
  ``test_torch_xsim``.
* A hand-built batch in which every stage of a naive workflow starts at
  one instant: the drain takes them all in one step, in the reference's
  order, and a cancel stops its lane only from the next iteration.
* Chunking is invisible in the naive-and-faults program.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import asa as jasa
from repro.core.bins import make_bins
from repro.xsim import compare as jcompare
from repro.xsim import events as jevents
from repro.xsim import families as jfamilies
from repro.xsim import grid as jgrid
from repro.xsim import policies as jpolicies
from repro.xsim import state as X
from repro.xsim.state import add_job, empty_table, freeze
from repro_torch import convert
from repro_torch.xsim import compare as tcompare
from repro_torch.xsim import events as tevents
from test_torch_xsim import (CFG_KW, METRIC_RTOL, _compare_states, _rel)

jax.config.update("jax_threefry_partitionable", True)
torch.set_num_threads(1)   # small tensors: threads only contend

POLICIES = (0, 1, 2, 3, 5)
BINS = np.asarray(make_bins(53), np.float32)


def _port(ref_state):
    """A reference state (batched) as the port's."""
    return convert.scenario_state(jax.tree.map(np.asarray, ref_state))


def _numpy(ref_state) -> dict:
    return convert.to_numpy(_port(ref_state))


@functools.cache
def _reference_grid(family: str):
    cfg = jgrid.XSimConfig(**CFG_KW)
    grid = jfamilies.family_grid(cfg, family, n_seeds=2, shrink=1 / 64.0,
                                 policy_ids=POLICIES)
    fleet = jpolicies.init_fleet(int(grid.geo_idx.max()) + 1)
    ests = jpolicies.scenario_estimators(fleet, jnp.asarray(grid.geo_idx), 1)
    return grid, grid.build(ests)


@pytest.mark.parametrize("pred_mode", ["greedy", "sample"])
@pytest.mark.parametrize("family", jfamilies.FAMILIES)
def test_naive_sweep_matches_reference(family, pred_mode):
    grid, st = _reference_grid(family)
    kw = dict(n_steps=grid.cfg.n_steps, chunk_steps=grid.cfg.chunk_steps,
              pred_mode=pred_mode, naive=True, faults=grid.has_faults)
    ref = jevents.sweep(st, **kw)
    got = tevents.sweep(_port(st), device="cpu", **kw)
    want = _numpy(ref)
    g = convert.to_numpy(got)
    _compare_states(g, want)
    ref_m = jcompare.batched_metrics(ref)
    got_m = tcompare.batched_metrics(got)
    for k, v in ref_m.items():
        a, b = got_m[k].numpy(), np.asarray(v)
        if b.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            assert _rel(a, b) <= METRIC_RTOL, k

    # every workflow finished inside the budget
    np.testing.assert_array_equal(got_m["wf_done"].numpy(),
                                  got_m["wf_total"].numpy())
    assert int(g["steps"].max()) < grid.cfg.n_steps
    # the branches this slice ports all ran: holds, cancels, kills
    naive = g["policy"] == X.ASA_NAIVE
    assert g["misses"][naive].sum() > 0
    assert np.any(g["oh_cs"][naive] > 0.0)
    assert np.isfinite(g["canc_start"][naive]).sum() > 0     # cancels
    assert np.any(g["hold"][naive] > 0.0)                    # idle holds
    assert np.all(g["misses"][~naive] == 0)
    if family in ("faulty", "preempt"):
        assert g["restarts"].sum() > 0
    # at the end every lane holds its whole machine and owes nothing
    np.testing.assert_array_equal(g["free"], g["total"])
    assert np.all(g["cap_debt"] >= 0.0)
    np.testing.assert_array_equal(g["fault_next"], g["fault_t"].shape[1])


# --------------------------------------------------- the drain, by hand

# stage durations of a workflow whose stages are all submitted at t = 0,
# one core each on an idle 16-core machine, so all start in the first
# step. Stage y's gap to its predecessor's logical end: "hold" 100, 200,
# 300 (three idle holds, the last at the threshold); "cancel" 100 (hold),
# then 500 (cancel at stage 2), and stage 3 waits for the next step.
DRAIN_DURS = {"hold": (100.0, 100.0, 100.0, 50.0),
              "cancel": (100.0, 400.0, 100.0, 100.0)}


def _same_instant(durs, key: int):
    t = empty_table(8)
    for y, d in enumerate(durs):
        add_job(t, y, cores=1.0, duration=d, submit=0.0, status=X.PENDING,
                wf_next=y + 1 if y + 1 < len(durs) else -1, is_wf=True)
    return freeze(t, total_cores=16.0, free_cores=16.0, policy=X.ASA_NAIVE,
                  pred_mode="sample",
                  est=jasa.init(53, jax.random.PRNGKey(key)))


def _stack(*states):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *states)


_ref_step = jax.jit(jax.vmap(
    lambda s: jevents.sim_step(s, jnp.asarray(BINS), naive=True)))


def test_naive_drain_takes_same_instant_stages_in_one_step():
    ref = _stack(_same_instant(DRAIN_DURS["hold"], 3),
                 _same_instant(DRAIN_DURS["cancel"], 4))
    got = _port(ref)
    bins = torch.as_tensor(BINS)
    for step in range(3):
        ref = _ref_step(ref)
        got, left = tevents.sim_step(got, bins, naive=True)
        assert left is None
        g = convert.to_numpy(got)
        _compare_states(g, _numpy(ref))
        if step == 0:
            # every stage started at t = 0, in one step
            np.testing.assert_array_equal(g["status"][0, :4], X.RUNNING)
            np.testing.assert_array_equal(g["status"][1, [0, 1, 3]],
                                          X.RUNNING)
            # "hold": four iterations drained everything, three holds
            assert not g["start_pending"][0].any()
            assert not g["chain_pending"][0].any()
            np.testing.assert_array_equal(g["hold"][0, :4],
                                          [0.0, 100.0, 200.0, 300.0])
            assert g["misses"][0] == 3 and not g["repass"][0]
            # "cancel": stage 2 cancelled in iteration 3, whose chain hook
            # still ran (stage 2's expected end is set); stage 3's hooks
            # wait for the repass step
            assert g["repass"][1] and g["misses"][1] == 2
            assert g["status"][1, 2] == X.CANCELLED
            assert g["canc_start"][1, 2] == 0.0
            np.testing.assert_array_equal(g["start_pending"][1, :4],
                                          [False, False, False, True])
            np.testing.assert_array_equal(g["chain_pending"][1, :4],
                                          [False, False, False, True])
            assert np.all(np.isfinite(g["expected_end"][1, :3]))
            assert np.isneginf(g["expected_end"][1, 3])
            np.testing.assert_array_equal(g["t"], [0.0, 0.0])
        if step == 1:
            # the repass step, at the same instant: stage 3 projects from
            # its predecessor's cancelled attempt (0 + 100) and holds
            assert g["t"][1] == 0.0 and not g["repass"][1]
            assert not g["start_pending"][1].any()
            assert g["hold"][1, 3] == 100.0 and g["misses"][1] == 3
    fin_ref = jevents.sweep(ref, n_steps=40, naive=True)
    fin = tevents.sweep(got, n_steps=40, naive=True, device="cpu")
    g = convert.to_numpy(fin)
    _compare_states(g, _numpy(fin_ref))
    assert np.all(g["status"][:, :4] == X.DONE)


def test_cut_drain_is_run_again_whole():
    """``simulate``'s chunks first run the naive drain cut at
    ``SPEC_HOOK_PAIRS`` iterations; the "hold" lane's first step needs
    four, so its chunk runs again with the whole drain. Every chunk size
    (0: no cut at all) gives the reference's final state, and the cut
    drain's flag is raised exactly when a lane has an iteration left."""
    assert tevents.SPEC_HOOK_PAIRS < 4
    ref = _stack(_same_instant(DRAIN_DURS["hold"], 3),
                 _same_instant(DRAIN_DURS["cancel"], 4))
    want = _numpy(jevents.sweep(ref, n_steps=40, naive=True))
    for k in (0, 1, 8):
        got = tevents.sweep(_port(ref), n_steps=40, chunk_steps=k,
                            naive=True, device="cpu")
        _compare_states(convert.to_numpy(got), want)
    bins = torch.as_tensor(BINS)
    _, left = tevents.sim_step(_port(ref), bins, naive=True, hook_pairs=3)
    assert bool(left)
    _, left = tevents.sim_step(_port(ref), bins, naive=True, hook_pairs=4)
    assert not bool(left)


@functools.cache
def _faulty_naive_grid():
    cfg = jgrid.XSimConfig(**CFG_KW)
    grid = jfamilies.family_grid(cfg, "faulty", n_seeds=1, shrink=1 / 64.0,
                                 policy_ids=(2, 3))
    fleet = jpolicies.init_fleet(int(grid.geo_idx.max()) + 1)
    ests = jpolicies.scenario_estimators(fleet, jnp.asarray(grid.geo_idx), 1)
    return _port(grid.build(ests))


@pytest.mark.parametrize("n_steps", [13, 60])
def test_chunking_is_invisible_in_the_naive_faults_program(n_steps):
    """Every chunk size gives the unchunked result bit for bit, in the
    truncated regime too (a budget that is not a chunk multiple)."""
    base = _faulty_naive_grid()
    runs = [convert.to_numpy(tevents.sweep(
        base, n_steps=n_steps, chunk_steps=k, pred_mode="sample",
        naive=True, faults=True, device="cpu")) for k in (0, 1, 8)]
    for other in runs[1:]:
        for k in runs[0]:
            np.testing.assert_array_equal(other[k], runs[0][k], err_msg=k)
    assert int(runs[0]["steps"].max()) <= n_steps

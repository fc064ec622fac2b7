"""The port's sharded fleet sweeps (``run_grid(n_shards=/mesh=)``,
``events.sharded_sweep``) against its single-device sweep, bit for bit
(CPU).

The 13 contracts of ``tests/test_xsim_sharded.py``, rerun on the port:
final job tables, live estimator states (PRNG keys included), event
rings, RL replay buffers and metrics of a sweep split over a
``scenarios`` mesh of k blocks must equal the single-device sweep's,
including batches the blocks do not divide (the padding path): the
sweep, the warm fleet and the RL buffers at k = 1, 2, 4 and 8, the other
contracts at one block and at 8 (where the batch pads) and, for the
chunked exit and the padding mask, at 2. ``sharded_batched_metrics``
and ``sharded_sweep_summary`` hold their reference contracts (counters
exact, floats to reduction order). Where the reference fakes 8 CPU devices with
``XLA_FLAGS=--xla_force_host_platform_device_count=8``, the port's mesh
puts k blocks on the one CPU (``ScenariosMesh([cpu] * k)``): every block
runs the whole program with its own chunked drain exit, as on a card.

One parity case holds the port's ``run_grid(n_shards=1)`` against the
reference's ``run_grid(n_shards=1)`` from the same reference-built
states: every integer and event field exact, as the sweep parity tests
compare.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from repro.xsim import grid as jgrid
from repro.xsim import policies as jpolicies
from repro_torch import convert
from repro_torch.core import prng
from repro_torch.launch.mesh import ScenariosMesh, make_scenarios_mesh
from repro_torch.obs import metrics as obs_metrics
from repro_torch.parallel import fleet as pfleet
from repro_torch.rl import policy as rl_policy
from repro_torch.rl import rollout
from repro_torch.sched.workflows import Stage, Workflow
from repro_torch.xsim import compare, policies
from repro_torch.xsim.families import family_grid
from repro_torch.xsim.grid import XSimConfig, make_grid, run_grid, warm_fleet
from repro_torch.xsim.state import ASA, ASA_NAIVE, BIGJOB, PER_STAGE, RL
from test_torch_rl import _carried
from test_torch_xsim import METRIC_RTOL, _compare_states, _rel

jax.config.update("jax_threefry_partitionable", True)
torch.set_num_threads(1)   # small tensors: threads only contend

CPU = "cpu"
KS = (1, 2, 4, 8)


def mesh_of(k: int) -> ScenariosMesh:
    return ScenariosMesh([CPU] * k)


def tiny_cfg(pred_mode: str = "greedy") -> XSimConfig:
    return XSimConfig(n_warm=8, n_backlog=6, n_arrivals=8, max_stages=9,
                      t0=1800.0, pred_mode=pred_mode)


def tiny_grid(cfg, policy_ids=(BIGJOB, PER_STAGE, ASA, ASA_NAIVE),
              n_seeds=1):
    # hpc2n has 3 paper scales → B = 3 · |policies| · n_seeds
    return make_grid(cfg, center_names=("hpc2n",), workflows=("blast",),
                     policy_ids=policy_ids, n_seeds=n_seeds,
                     shrink=1 / 64.0, device=CPU)


def fleet_for(grid):
    return policies.init_fleet(int(grid.geo_idx.max()) + 1, device=CPU)


def assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
        return
    ga, gb = convert.to_numpy(a), convert.to_numpy(b)
    assert ga.keys() == gb.keys()
    for k in ga:
        np.testing.assert_array_equal(ga[k], gb[k], err_msg=k)


@functools.cache
def single(name: str):
    """The single-device run each case's sharded runs are held to."""
    return CASES[name]()


def _run(grid, pred_seed, **kw):
    return run_grid(grid, fleet_for(grid), pred_seed=pred_seed, device=CPU,
                    **kw)


def warm_grid():
    return tiny_grid(tiny_cfg(), policy_ids=(PER_STAGE, ASA), n_seeds=2)


def faulty_grid():
    return family_grid(tiny_cfg(pred_mode="sample"), "faulty",
                       center_names=("hpc2n",), workflows=("blast",),
                       n_seeds=1, shrink=1 / 64.0,
                       policy_ids=(BIGJOB, PER_STAGE, ASA, ASA_NAIVE),
                       device=CPU)


def traced_grid():
    return tiny_grid(tiny_cfg().with_trace(64))   # B = 12: pads on k = 8


def rl_grid():
    return tiny_grid(tiny_cfg(), policy_ids=(RL,), n_seeds=3)   # B = 9


def rl_params():
    return rl_policy.init_params(prng.PRNGKey(0), device=CPU)


def _collect(**kw):
    grid = rl_grid()
    return rollout.collect(grid, rl_params(), fleet_for(grid), pred_seed=7,
                           rl_mode="sample", device=CPU, **kw)


def _warm(**kw):
    grid = warm_grid()
    return warm_fleet(fleet_for(grid), grid, rounds=2, device=CPU, **kw)


CASES = {
    "sample": lambda: _run(tiny_grid(tiny_cfg("sample")), 3),
    "greedy": lambda: _run(tiny_grid(tiny_cfg()), 3),
    "nondivisible": lambda: _run(tiny_grid(tiny_cfg(), (ASA,), 3), 5),
    "warm": _warm,
    "faulty": lambda: _run(faulty_grid(), 3),
    "traced": lambda: _run(traced_grid(), 3),
    "rl": _collect,
}


# --------------------------------------------------------- mesh + padding


def test_scenarios_mesh_validates_device_count():
    with pytest.raises(ValueError, match="device"):
        make_scenarios_mesh(2, device=CPU)     # the CPU is one device
    with pytest.raises(ValueError, match="device"):
        make_scenarios_mesh(0, device=CPU)
    mesh = make_scenarios_mesh(1, device=CPU)
    assert mesh.shape["scenarios"] == 1 and mesh.axis_names == ("scenarios",)
    assert make_scenarios_mesh(device=CPU).devices == (torch.device(CPU),)
    if torch.cuda.device_count() == 0:
        with pytest.raises(ValueError, match="device"):
            make_scenarios_mesh(1)             # default: CUDA devices
    # several blocks on one device: built directly
    assert mesh_of(3).shape == {"scenarios": 3}
    with pytest.raises(ValueError, match="device"):
        ScenariosMesh([])


def test_pad_batch_pads_with_row_zero():
    tree = {"a": torch.arange(5.0), "b": torch.arange(10.0).reshape(5, 2)}
    padded, mask = pfleet.pad_batch(tree, 4)
    assert padded["a"].shape == (8,) and padded["b"].shape == (8, 2)
    np.testing.assert_array_equal(mask.numpy(), [True] * 5 + [False] * 3)
    # pad rows replicate row 0: a valid scenario
    np.testing.assert_array_equal(padded["a"][5:].numpy(), [0.0] * 3)
    np.testing.assert_array_equal(padded["b"][5:].numpy(),
                                  np.broadcast_to([0.0, 1.0], (3, 2)))
    np.testing.assert_array_equal(pfleet.unpad(padded, 5)["a"].numpy(),
                                  tree["a"].numpy())
    blocks = pfleet.split(padded, [CPU] * 4)
    assert [x["b"].shape for x in blocks] == [(2, 2)] * 4
    assert torch.equal(pfleet.gather(blocks, torch.device(CPU))["b"],
                       padded["b"])


def test_pad_batch_divisible_is_identity():
    tree = {"a": torch.arange(6.0)}
    padded, mask = pfleet.pad_batch(tree, 3)
    assert padded["a"] is tree["a"]
    assert bool(mask.all())
    with pytest.raises(ValueError, match="n_shards"):
        pfleet.pad_batch(tree, 0)
    with pytest.raises(ValueError, match="pad_batch"):
        pfleet.split(tree, [CPU] * 4)
    assert pfleet.shard_spec() == ("scenarios",)
    assert str(pfleet.replicated_spec()) == "PartitionSpec()"


# ------------------------------------------- sharded ≡ single device


def test_one_shard_matches_vmap_bitwise():
    f0, m0 = single("greedy")
    f1, m1 = _run(tiny_grid(tiny_cfg()), 3, n_shards=1)
    assert_trees_equal(f0, f1)
    assert_trees_equal(m0, m1)


@pytest.mark.parametrize("k", KS)
def test_sharded_run_grid_bit_identical(k):
    # pred_mode="sample" pins the sampled prediction sequences too
    f0, m0 = single("sample")
    fk, mk = _run(tiny_grid(tiny_cfg("sample")), 3,
                  mesh=mesh_of(k))               # B = 12: pads on k = 8
    assert_trees_equal(f0, fk)                    # incl. est PRNG keys
    assert_trees_equal(m0, mk)


@pytest.mark.parametrize("k", (1, 2, 8))
def test_chunked_early_exit_bit_identical_across_shards(k):
    """Each block exits its chunked sweep on its own, so blocks holding
    quick-draining scenarios run fewer chunks than busy ones, and the
    gathered result must still equal the single-device sweep bit for
    bit. The grid mixes a single-stage probe workflow with montage so
    per-scenario event counts (and so per-block chunk counts) differ."""
    probe = Workflow("probe1", (Stage("only", True, 600.0, 0.5),))
    cfg = tiny_cfg(pred_mode="sample")
    grid = make_grid(cfg, center_names=("hpc2n",),
                     workflows=(probe, "montage"),
                     policy_ids=(PER_STAGE, ASA, ASA_NAIVE), n_seeds=1,
                     shrink=1 / 64.0, device=CPU)  # B = 18: pads on 4, 8
    f0, m0 = _run(grid, 9)
    steps = f0.steps.numpy()
    assert int(steps.max()) > int(steps.min())
    fk, mk = _run(grid, 9, mesh=mesh_of(k))
    assert_trees_equal(f0, fk)                    # incl. the steps counters
    assert_trees_equal(m0, mk)


@pytest.mark.parametrize("k", (2, 8))
def test_sharded_nondivisible_batch_padding_mask(k):
    f0, m0 = single("nondivisible")
    grid = tiny_grid(tiny_cfg(), policy_ids=(ASA,), n_seeds=3)   # B = 9
    assert grid.n % 2 == 1
    fk, mk = _run(grid, 5, mesh=mesh_of(k))
    assert pfleet.batch_size(fk) == grid.n        # pad rows sliced off
    assert_trees_equal(f0, fk)
    assert_trees_equal(m0, mk)


@pytest.mark.parametrize("k", KS)
def test_sharded_warm_fleet_bit_identical(k):
    assert_trees_equal(single("warm"), _warm(mesh=mesh_of(k)))
    if k == 1:
        assert_trees_equal(single("warm"), _warm(n_shards=1))


@pytest.mark.parametrize("k", (2, 8))
def test_sharded_batched_metrics_matches_to_reduction_order(k):
    """compare.sharded_batched_metrics reduces on the blocks; equal to
    the gathered-path metrics up to reduction-order rounding."""
    final, m = single("nondivisible")             # B = 9, pads
    ms = compare.sharded_batched_metrics(final, mesh_of(k))
    assert sorted(ms) == sorted(m)
    for key in m:
        np.testing.assert_allclose(ms[key].numpy(), m[key].numpy(),
                                   rtol=1e-6, atol=0.0, err_msg=key)


@pytest.mark.parametrize("k", (1, 8))
def test_fault_family_sweep_bit_identical_across_shards(k):
    """A faulty-family sweep (fail + recovery) gathers bit-identically to
    the single-device sweep for every block count: the fault cursor,
    drain debt and restart accounting are per-scenario state."""
    grid = faulty_grid()
    assert grid.has_faults
    f0, m0 = single("faulty")
    fk, mk = _run(grid, 3, mesh=mesh_of(k))
    assert_trees_equal(f0, fk)                    # incl. fault cursors/debt
    assert_trees_equal(m0, mk)
    assert int(f0.restarts.sum()) > 0


@pytest.mark.parametrize("k", (1, 8))
def test_traced_sweep_bit_identical_across_shards(k):
    """A traced sharded sweep leaves every other field bit-identical to
    the untraced single-device run and records the very rings the traced
    single-device run records."""
    f0, m0 = single("greedy")
    ftv, _ = single("traced")
    ftk, mtk = _run(traced_grid(), 3, mesh=mesh_of(k))
    assert f0.trace is None and ftk.trace is not None
    assert_trees_equal(f0, ftk._replace(trace=None))
    assert_trees_equal(m0, mtk)
    for a, b in zip(ftv.trace, ftk.trace):        # rings block-count-free
        assert torch.equal(a, b)


@pytest.mark.parametrize("k", (2, 8))
def test_sharded_sweep_summary_matches_vmap(k):
    """The fleet summary reduced block by block, pad rows masked out:
    integer counters exactly the single-device summary's, float columns
    to reduction order."""
    cfg = tiny_cfg().with_trace(64)
    grid = tiny_grid(cfg, policy_ids=(ASA,), n_seeds=3)   # B = 9, pads
    final, _ = _run(grid, 5)
    s0 = obs_metrics.sweep_summary(final, n_steps=cfg.n_steps)
    sk = obs_metrics.sharded_sweep_summary(final, mesh_of(k),
                                           n_steps=cfg.n_steps)
    assert sorted(s0) == sorted(sk)
    for key in s0:
        a, b = sk[key], s0[key]
        assert a.dtype == b.dtype, key
        if a.dtype.is_floating_point:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=0.0, err_msg=key)
        else:
            assert torch.equal(a, b), key


@pytest.mark.parametrize("k", KS)
def test_sharded_rl_replay_buffers_bit_identical(k):
    f0, m0, t0 = single("rl")
    fk, mk, tk = _collect(mesh=mesh_of(k))
    # the REINFORCE replay (obs + chosen bins) must be block-count-free
    assert torch.equal(f0.rl_obs, fk.rl_obs)
    assert torch.equal(f0.rl_act, fk.rl_act)
    assert bool((f0.rl_act >= 0).any())
    assert_trees_equal(f0, fk)
    assert_trees_equal(m0, mk)
    for a, b in zip(t0, tk):
        assert torch.equal(a, b)


# ----------------------------------------------- parity with the reference


def test_one_shard_run_grid_matches_reference():
    """The port's ``run_grid(n_shards=1)`` against the reference's
    ``run_grid(n_shards=1)`` (jax sees one CPU device) from the same
    reference-built states: integer and event fields exact, floats
    within the sweep parity tests' tolerance, metrics within
    ``METRIC_RTOL``."""
    cfg = jgrid.XSimConfig(n_warm=8, n_backlog=6, n_arrivals=8,
                           max_stages=9, t0=1800.0, pred_mode="sample")
    grid = jgrid.make_grid(cfg, center_names=("hpc2n",),
                           workflows=("blast",),
                           policy_ids=(BIGJOB, PER_STAGE, ASA, ASA_NAIVE),
                           n_seeds=1, shrink=1 / 64.0)
    fleet = jpolicies.init_fleet(int(grid.geo_idx.max()) + 1)
    ref, ref_m = jgrid.run_grid(grid, fleet, pred_seed=3, n_shards=1)
    got, got_m = run_grid(_carried(grid, 3), pred_seed=3, n_shards=1,
                          device=CPU)
    want = convert.to_numpy(convert.scenario_state(
        jax.tree.map(np.asarray, ref)))
    _compare_states(convert.to_numpy(got), want)
    for key, v in ref_m.items():
        a, b = got_m[key].numpy(), np.asarray(v)
        if b.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=key)
        else:
            assert _rel(a, b) <= METRIC_RTOL, key

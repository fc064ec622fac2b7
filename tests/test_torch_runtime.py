"""The port's runtime side of the campaign and the elastic plan
(``runtime.campaign``, ``runtime.elastic.reshard_plan``,
``parallel.sharding``) against the reference (CPU).

* ``tests/test_runtime.py::test_campaign_overlaps_waits`` rerun on the
  port with its seeds (estimator 3, warm-up sim 11, measured sim 12).
* ``examples/campaign_schedule.py``'s ASA campaign (estimator 1, warm-up
  sim 41, measured sim 42) through the port and through the reference:
  every outcome equal field by field (the port's QueueSim is the
  reference's, its estimator draws the reference's threefry stream).
* ``test_reshard_plan_reports_moves`` (``tests/test_runtime.py``) and
  ``test_sharding_rules_divisibility`` (``tests/test_optimizer_data.py``)
  rerun on the port.
* ``spec_for`` and ``reshard_plan`` over every parameter of every config
  (the reference's ``jax.eval_shape(init_params)`` against the port's
  meta tensors of the same shapes) on the meshes {data:16, model:16},
  {pod:2, data:16, model:16}, {data:8, model:16} and {data:1, model:1}:
  spec strings, ``bytes_total`` and ``moves`` equal to the reference's.
* Placing on the production mesh (item 10's meta devices) splits a
  leaf into one ``meta`` shard a position (item 11: no longer raises).
"""

import dataclasses
import itertools

import jax
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import get_arch as jget_arch
from repro.parallel import sharding as jsharding
from repro.runtime import campaign as jcampaign
from repro.runtime import elastic as jelastic
from repro.sched import centers as jcenters
from repro.sched import queue_sim as jqueue_sim
from repro.sched import strategies as jstrategies
from repro.train.step import init_params as jinit_params
from repro_torch.launch import mesh as tmesh
from repro_torch.parallel.sharding import P, ShardingRules
from repro_torch.runtime import campaign as tcampaign
from repro_torch.runtime import elastic as telastic
from repro_torch.runtime.pool import ResourcePool
from repro_torch.sched.centers import UPPMAX
from repro_torch.sched.queue_sim import QueueSim
from repro_torch.sched.strategies import ASAEstimator

jax.config.update("jax_threefry_partitionable", True)
torch.set_num_threads(1)   # small tensors: threads only contend

CPU = "cpu"
# examples/campaign_schedule.py's stages
EXAMPLE_STAGES = [
    ("data-prep", 160, 1800.0, "-"),
    ("pretrain", 640, 7200.0, "qwen3-moe-235b-a22b"),
    ("anneal", 320, 3600.0, "qwen3-moe-235b-a22b"),
    ("sft", 320, 2400.0, "deepseek-7b"),
    ("eval", 160, 1200.0, "-"),
]
MESHES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 8, "model": 16}, {"data": 1, "model": 1})


class FakeMesh:
    def __init__(self, shape_map):
        self.shape = shape_map
        self.axis_names = tuple(shape_map)


# ------------------------------------------------------------- campaign


def test_campaign_overlaps_waits():
    """ASA campaign scheduling hides queue waits behind running stages."""
    est = ASAEstimator(seed=3, device=CPU)
    stages = [tcampaign.CampaignStage(f"s{i}", 160, 3000.0)
              for i in range(4)]
    # warm-up campaign (state persists, §4.3)
    sched0 = tcampaign.CampaignScheduler(QueueSim(UPPMAX, seed=11), est)
    sched0.sim.run_until(3600)
    sched0.run(stages)
    # measured campaign
    sim = QueueSim(UPPMAX, seed=12)
    sim.run_until(3600)
    rep = tcampaign.CampaignScheduler(sim, est).run(stages)
    waits = [o.real_wait_s for o in rep.outcomes]
    pwts = [o.perceived_wait_s for o in rep.outcomes[1:]]
    # later-stage perceived waits must be far below the raw queue waits
    assert sum(pwts) < 0.5 * sum(waits[1:])
    assert rep.makespan_s > 0


def _campaign(pkg, est_seed: int, warm_seed: int, sim_seed: int, stages):
    """Warm-up campaign then measured campaign, both sims run to 3600 s
    first (the example's ``fresh_sim``); returns both reports and the
    measured run's pool."""
    if pkg == "port":
        est = ASAEstimator(seed=est_seed, device=CPU)
        mk_sim, sched = (lambda s: QueueSim(UPPMAX, seed=s),
                         tcampaign.CampaignScheduler)
    else:
        est = jstrategies.ASAEstimator(seed=est_seed)
        mk_sim, sched = (lambda s: jqueue_sim.QueueSim(jcenters.UPPMAX,
                                                       seed=s),
                         jcampaign.CampaignScheduler)
    reps = []
    for seed in (warm_seed, sim_seed):
        sim = mk_sim(seed)
        sim.run_until(3600)
        s = sched(sim, est)
        reps.append(s.run(stages))
    return reps, s.pool


@pytest.mark.parametrize("seeds,stages", [
    ((3, 11, 12), [("s0", 160, 3000.0, ""), ("s1", 160, 3000.0, ""),
                   ("s2", 160, 3000.0, ""), ("s3", 160, 3000.0, "")]),
    ((1, 41, 42), EXAMPLE_STAGES),
], ids=["test_seeds", "example_seeds"])
def test_campaign_matches_reference(seeds, stages):
    """The port's campaign equals the reference's outcome by outcome,
    warm-up included, and so do the report's totals."""
    got, pool = _campaign(
        "port", *seeds, [tcampaign.CampaignStage(*s) for s in stages])
    want, _ = _campaign(
        "reference", *seeds, [jcampaign.CampaignStage(*s) for s in stages])
    for g, w in zip(got, want):
        assert [dataclasses.asdict(o) for o in g.outcomes] == \
               [dataclasses.asdict(o) for o in w.outcomes]
        assert (g.makespan_s, g.total_perceived_wait_s, g.slice_hours) == \
               (w.makespan_s, w.total_perceived_wait_s, w.slice_hours)
    assert pool.available() == sum(s[1] for s in stages)


def test_campaign_scheduler_defaults():
    """A fresh estimator lives on ``device`` (the card by default), and
    a fresh pool is made."""
    sched = tcampaign.CampaignScheduler(QueueSim(UPPMAX, seed=0),
                                        device=CPU)
    assert sched.est.state.log_p.device.type == "cpu"
    assert isinstance(sched.pool, ResourcePool)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tcampaign.CampaignScheduler(QueueSim(UPPMAX, seed=0))
    assert tcampaign.CampaignReport().makespan_s == 0.0


# ------------------------------------------------------ reshard plans


def test_reshard_plan_reports_moves():
    r16 = ShardingRules(FakeMesh({"data": 16, "model": 16}))
    r8 = ShardingRules(FakeMesh({"data": 8, "model": 16}))
    params = {"mlp": {"w_gate": torch.zeros((4096, 16384),
                                            device="meta")}}
    plan = telastic.reshard_plan(params, r16, r8)
    assert len(plan) == 1
    assert plan[0].bytes_total == 4096 * 16384 * 4
    assert plan[0].moves


def test_sharding_rules_divisibility():
    rules = ShardingRules(FakeMesh({"data": 16, "model": 16}))
    # gemma: 8 heads NOT divisible by 16 -> replicated head dim
    spec = rules.spec_for("layers/attn/wq", (18, 2048, 8, 256))
    assert spec == P(None, ("data",), None, None)
    # qwen3 experts: 128 divisible -> EP on model
    spec = rules.spec_for("layers/moe/w_gate", (94, 128, 4096, 1536))
    assert spec == P(None, "model", ("data",), None)
    # d_ff divisible -> TP on model
    spec = rules.spec_for("layers/mlp/w_gate", (18, 2048, 16384))
    assert spec == P(None, ("data",), "model")
    # norms replicated
    spec = rules.spec_for("layers/attn_norm/scale", (18, 2048))
    assert spec == P(None, None)


def test_partition_spec_matches_reference():
    """Printing, equality and iteration as jax's ``PartitionSpec``: a
    one-name tuple is the bare name, a longer tuple stays."""
    JP = jax.sharding.PartitionSpec
    for parts in [(), (None,), (None, ("data",)), (("pod", "data"), None),
                  ("model", ("data",), None), ("scenarios",)]:
        assert str(P(*parts)) == str(JP(*parts))
        assert repr(P(*parts)) == repr(JP(*parts))
        assert tuple(P(*parts)) == tuple(JP(*parts))
        assert P(*parts) == JP(*parts)
    assert P(None, ("data",)) == P(None, "data")
    assert P() != P(None)


def _reference_trees():
    for name in sorted(JARCHS):
        cfg = jget_arch(name)
        shapes = jax.eval_shape(lambda k, c=cfg: jinit_params(k, c),
                                jax.random.PRNGKey(0))
        meta = jax.tree.map(
            lambda x: torch.empty(
                x.shape, dtype=getattr(torch, str(x.dtype)),
                device="meta"), shapes)
        yield name, shapes, meta


def test_specs_and_plans_match_reference_on_every_config():
    """``spec_for``/``tree_specs`` and ``reshard_plan`` of the port against
    the reference's over every parameter of every config, on four meshes
    and every ordered pair of them."""
    meshes = [(FakeMesh(m), m) for m in MESHES]
    n_leaves = 0
    for name, shapes, meta in _reference_trees():
        flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
        n_leaves += len(flat)
        for fm, m in meshes:
            jr, tr = jsharding.ShardingRules(fm), ShardingRules(FakeMesh(m))
            jspecs = jax.tree_util.tree_leaves(
                jr.tree_specs(shapes),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
            tspecs = jax.tree_util.tree_leaves(
                tr.tree_specs(meta), is_leaf=lambda x: isinstance(x, P))
            assert [str(s) for s in tspecs] == [str(s) for s in jspecs], \
                (name, m)
            assert jr.batch_spec(32, 3) == tr.batch_spec(32, 3)
            assert jr.kv_cache_spec(32, 8) == tr.kv_cache_spec(32, 8)
        for (fa, a), (fb, b) in itertools.product(meshes, meshes):
            want = jelastic.reshard_plan(shapes, jsharding.ShardingRules(fa),
                                         jsharding.ShardingRules(fb))
            got = telastic.reshard_plan(meta, ShardingRules(FakeMesh(a)),
                                        ShardingRules(FakeMesh(b)))
            assert [dataclasses.asdict(e) for e in got] == \
                   [dataclasses.asdict(e) for e in want], (name, a, b)
    assert n_leaves > 100


def test_reshard_plan_counts_bfloat16_bytes():
    rules = ShardingRules(FakeMesh({"data": 16, "model": 16}))
    params = {"layers": [torch.empty((4, 64, 32), dtype=torch.bfloat16,
                                     device="meta")], "b": None}
    plan = telastic.reshard_plan(params, rules, rules)
    assert [(e.path, e.bytes_total, e.moves) for e in plan] == \
        [("layers/0", 4 * 64 * 32 * 2, False)]


# ------------------------------------- placement on the production mesh


def test_production_mesh_placement_gives_meta_shards():
    """Placing a leaf that the production mesh's axes split splits it:
    one ``meta`` shard a position, of the sharding's shard shape, in the
    mesh's device order, nothing allocated; the shardings themselves
    equal ``spec_for``'s."""
    from repro_torch.parallel.sharding import ShardedTensor

    rules = ShardingRules(FakeMesh({"data": 16, "model": 16}))
    params = {"layers": {"mlp": {"w_up": torch.zeros((2, 32, 64),
                                                     device="meta")}}}
    sh = rules.tree_shardings(params)["layers"]["mlp"]["w_up"]
    assert sh.spec == rules.spec_for("layers/mlp/w_up", (2, 32, 64))
    mesh = tmesh.make_production_mesh()
    assert mesh.shape == {"data": 16, "model": 16}
    placed = telastic.apply_resize(params, mesh, ShardingRules(mesh))
    leaf = placed["layers"]["mlp"]["w_up"]
    assert isinstance(leaf, ShardedTensor)
    assert leaf.sharding.spec == P(None, "data", "model")
    assert len(leaf.shards) == 256 and leaf.shape == (2, 32, 64)
    assert all(x.shape == (2, 2, 4) and x.device.type == "meta"
               for x in leaf.shards)
    # position (d, m) holds rows 2d..2d+1 and columns 4m..4m+3
    assert leaf.indices[17] == (slice(0, 2), slice(2, 4), slice(4, 8))
    assert leaf.gather().device.type == "meta"

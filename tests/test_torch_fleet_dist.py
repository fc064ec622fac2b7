"""One process a block (ROADMAP Queue 1 item 12(g)): the fleet's sharded
paths over ``torch.distributed`` against the one-process blocks route,
on the CPU with ``gloo``.

Under a process group ``make_scenarios_mesh`` builds the ranks'
``scenarios`` mesh: rank r sweeps block r alone and the blocks meet in an
all-gather (``parallel.fleet.all_gather_tree``), so every rank holds the
whole result. At world sizes 2 and 3 (``tests/torch_dist_ranks.py``'s
spawned ranks; the batch of 8 pads at 3), every rank's results are held
**bitwise** against the same calls on one process's
``ScenariosMesh(["cpu"] * world)``: the sweep of each family with
ASA-Naive (``faulty`` traced) with its metrics, per-block metrics and
fleet summary; ``warm_fleet``; a rollout and one ``reinforce_step``;
``serve_step`` composed over four batches; an ``ASAServer`` on rank 0
(the other ranks ``follow`` its messages) over a stream, with evictions,
a save and a restore. On four ranks, ``apply_resize`` moves each of the
six families' float32 reduced trees from (2, 2) to (4, 1) to (1, 4)
bitwise the one-process ``apply_resize``, no rank receiving more than
its new shard's bytes. One test holds the ranks' gathered sweep against
the reference's ``run_grid``; a ``cuda``-marked one holds two ranks on
the card against the one-process route there. Both routes run with one CPU thread a
process: a float32 product's rounding may depend on the thread count.
"""

import jax
import numpy as np
import pytest
import torch

import torch_dist_ranks as R
from repro_torch.launch.mesh import DeviceMesh, ScenariosMesh
from repro_torch.parallel.sharding import ShardedTensor, ShardingRules, place
from repro_torch.runtime.elastic import apply_resize
from repro_torch.serve import asa as serve_asa
from repro_torch.serve.loop import ASAServer, ServeConfig, ServeSupervisor, \
    follow
from repro_torch.train import optimizer as TO
from test_torch_xsim import TIME_RTOL, _rel

jax.config.update("jax_threefry_partitionable", True)
torch.set_num_threads(1)   # as each rank: the products' rounding is kept

WORLDS = (2, 3)
RESIZE_WORLD = 4


def cpu_mesh(data: int, model: int) -> DeviceMesh:
    grid = np.empty((data, model), dtype=object)
    grid.fill(torch.device("cpu"))
    return DeviceMesh(grid, ("data", "model"))


def one_process_resize() -> dict:
    """{arch: [each stage's tree]} of the one-process ``apply_resize``
    through ``R.resize_meshes``."""
    (d0, m0), *moves = R.resize_meshes(RESIZE_WORLD)
    out = {}
    for arch in R.ARCHS6:
        tree = R.resize_tree(arch)
        mesh = cpu_mesh(d0, m0)
        tree = place(tree, ShardingRules(mesh).tree_shardings(tree))
        stages = []
        for data, model in moves:
            new = cpu_mesh(data, model)
            tree = apply_resize(tree, new, ShardingRules(new))
            stages.append(TO.leaves(tree))
        out[arch] = stages
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the one-process route's results by world, the one-process resize,
    each spawn's ranks' results, the serve spawns' under ``"serve"``):
    the spawns start first and run while this process computes the
    one-process route. The serve spawns' group times out after
    ``R.SERVE_TIMEOUT_S``, so their idle server's keep-alives come within
    the test's time."""
    spawned = {w: R.Ranks("fleet", w, tmp_path_factory.mktemp(f"fleet{w}"))
               for w in WORLDS}
    serving = {w: R.Ranks("serve", w, tmp_path_factory.mktemp(f"serve{w}"),
                          timeout_s=R.SERVE_TIMEOUT_S)
               for w in WORLDS}
    spawned[RESIZE_WORLD] = R.Ranks("resize", RESIZE_WORLD,
                                    tmp_path_factory.mktemp("resize"),
                                    model=2)
    one = {}
    for w in WORLDS:
        mesh = ScenariosMesh(["cpu"] * w)
        one[w] = R.fleet_cases(mesh)
        one[w]["serve"] = R.serve_cases(
            mesh, tmp_path_factory.mktemp(f"one{w}") / "ckpt")
    resized = one_process_resize()
    got = {}
    for w, ranks in spawned.items():
        ranks.check()
        got[w] = [torch.load(ranks.work / f"rank{r}.pt", weights_only=False)
                  for r in range(w)]
    for w, ranks in serving.items():
        ranks.check()
        for r in range(w):
            got[w][r]["serve"] = torch.load(ranks.work / f"rank{r}.pt",
                                            weights_only=False)
    return one, resized, got


def assert_same(a, b, path: str = "") -> None:
    """``a`` and ``b`` equal bit for bit, tensors and arrays by dtype
    too, nested containers by key and position."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def _case(runs, world: int, name: str):
    one, _, got = runs
    return one[world][name], [g[name] for g in got[world]]


@pytest.mark.parametrize("family", R.FLEET_FAMILIES)
@pytest.mark.parametrize("world", WORLDS)
def test_sweep_is_the_one_process_route_bitwise(runs, world, family):
    """Final states (rings and estimator keys included) and metrics on
    every rank."""
    want, ranks = _case(runs, world, family)
    assert want["final"]["status"].shape[0] == 8
    for r, got in enumerate(ranks):
        assert_same(got["final"], want["final"], f"rank {r}")
        assert_same(got["metrics"], want["metrics"], f"rank {r}")
    if family == "faulty":
        assert "trace.head" in want["final"]
        assert int(want["final"]["restarts"].sum()) > 0
    assert int((want["final"]["policy"] == 3).sum()) > 0   # ASA-Naive


@pytest.mark.parametrize("family", R.FLEET_FAMILIES)
@pytest.mark.parametrize("world", WORLDS)
def test_block_metrics_are_the_one_process_route_bitwise(runs, world,
                                                         family):
    """``sharded_batched_metrics``: each rank reduces its own block, the
    columns are all-gathered."""
    want, ranks = _case(runs, world, family)
    for r, got in enumerate(ranks):
        assert_same(got["block_metrics"], want["block_metrics"], f"rank {r}")


@pytest.mark.parametrize("family", R.FLEET_FAMILIES)
@pytest.mark.parametrize("world", WORLDS)
def test_summary_is_the_one_process_route_bitwise(runs, world, family):
    """``sharded_sweep_summary``: each rank's raw sums (pad rows masked)
    all-gathered and added in mesh order, counters and float columns
    alike; the counters equal the unsharded summary's too."""
    want, ranks = _case(runs, world, family)
    for r, got in enumerate(ranks):
        assert_same(got["summary"], want["summary"], f"rank {r}")
        assert_same(got["summary_whole"], want["summary_whole"],
                    f"rank {r}")
    assert int(want["summary"]["n_scenarios"]) == 8
    if family == "faulty":
        assert int(want["summary"]["trace_events"]) > 0
    for k, v in want["summary_whole"].items():
        if not v.dtype.is_floating_point:
            assert torch.equal(want["summary"][k], v), k


@pytest.mark.parametrize("world", WORLDS)
def test_warm_fleet_is_the_one_process_route_bitwise(runs, world):
    """Two warm rounds: each round's gathered states update the fleet on
    every rank alike."""
    want, ranks = _case(runs, world, "warm")
    for r, got in enumerate(ranks):
        assert_same(got, want, f"rank {r}")
    assert int(want.t.sum()) > 0


@pytest.mark.parametrize("world", WORLDS)
def test_rollout_and_reinforce_are_the_one_process_route_bitwise(runs,
                                                                 world):
    """The rollout's gathered state, metrics and trajectory, and the head
    after one REINFORCE step, equal on every rank."""
    want, ranks = _case(runs, world, "rollout")
    for r, got in enumerate(ranks):
        assert_same(got, want, f"rank {r}")
    assert bool((want["traj"][1] >= 0).any())


@pytest.mark.parametrize("world", WORLDS)
def test_serve_step_composed_is_the_one_process_route_bitwise(runs, world):
    """Four decision steps: each rank's one replica and the decisions
    equal the one-process replicas'."""
    want, ranks = _case(runs, world, "serve_step")
    for r, got in enumerate(ranks):
        for i, (a, b) in enumerate(zip(got, want)):
            assert a["replicas"] == 1
            assert_same(a["table"], b["table"], f"rank {r} step {i}")
            assert_same(a["decisions"], b["decisions"],
                        f"rank {r} step {i}")


@pytest.mark.parametrize("world", WORLDS)
def test_server_and_restart_are_the_one_process_route_bitwise(runs, world):
    """Rank 0's server answers the stream as the one-process server does
    (decisions and slots, evictions and re-admissions into freed slots
    included), every follower's replica equals it, and the servers
    restored from the save (rank 0's, the followers' replicas) do too; so
    does a server run by its loop thread, idle between requests."""
    want, ranks = _case(runs, world, "serve")
    head = ranks[0]
    for key in ("first", "second", "slots", "live_table",
                "restored_second", "restored_table", "threaded",
                "threaded_table"):
        assert_same(head[key], want[key], key)
    assert head["replicas"] == 1
    assert head["second"] == head["restored_second"]
    for r, got in enumerate(ranks[1:], 1):
        for key in ("live_table", "restored_table", "threaded_table"):
            assert_same(got[key], want[key], f"rank {r} {key}")


@pytest.mark.parametrize("world", WORLDS)
def test_followers_start_from_the_replica_rank_0_restored(runs, world):
    """Rank 0's server restored from the latest save (no step named)
    while the followers are started with no step: its first message
    names the step it read, so every follower's replica starts there and
    the third stream's decisions and replicas are the one-process
    server's. (The step-2 replica is not a fresh table, so a follower
    started fresh would step the wrong posteriors.)"""
    want, ranks = _case(runs, world, "serve")
    assert_same(ranks[0]["latest_third"], want["latest_third"])
    cfg = ServeConfig(**R.SERVE_CFG)
    fresh = serve_asa.init_table(cfg.n_slots, cfg.m, cfg.seed, device="cpu")
    assert not all(torch.equal(a, b) for a, b in zip(want["live_table"],
                                                     fresh))
    for r, got in enumerate(ranks):
        assert_same(got["latest_table"], want["latest_table"], f"rank {r}")


@pytest.mark.parametrize("world", WORLDS)
def test_an_idle_server_keeps_its_followers_alive(runs, world):
    """The loop thread's server, idle once past a quarter of the group's
    collective timeout, sends a keep-alive (a message beyond its batches'
    and the stop), and every follower takes each message it sends."""
    _, ranks = _case(runs, world, "serve")
    head = ranks[0]
    assert head["threaded_messages"] > head["threaded_batches"] + 1
    for r, got in enumerate(ranks[1:], 1):
        assert got["threaded_messages"] == head["threaded_messages"], r


@pytest.mark.parametrize("world", WORLDS)
def test_the_ranks_mesh_and_collectives(runs, world):
    """Each rank's mesh is the group's (its block its rank); blocks meet
    in all-gathers, the server's messages in broadcasts, and nothing is
    gathered to one rank."""
    _, _, got = runs
    for r, g in enumerate(got[world]):
        text, index, shape = g["mesh"]
        assert index == r and shape == {"scenarios": world}
        assert f"rank {r} of {world}" in text
        c, s = g["counts"], g["serve"]["counts"]
        assert c["all_gather"]["calls"] > 0
        assert s["all_gather"]["calls"] > 0 and s["broadcast"]["calls"] > 0
        for counts in (c, s):
            assert counts["gather"]["calls"] == 0
            assert counts["all_to_all"]["calls"] == 0
        assert g["mesh_checks"] == [None, f"n_shards 1 is not the {world} "
                                    "ranks of the process group (one block "
                                    "a rank)"]


@pytest.mark.parametrize("arch", R.ARCHS6)
def test_apply_resize_across_processes_is_bitwise(runs, arch):
    """(2, 2) -> (4, 1) -> (1, 4): every rank's shard of every leaf of
    params, m and v equals the one-process shard at its position."""
    _, resized, got = runs
    n_split = 0
    for r, ranks in enumerate(got[RESIZE_WORLD]):
        for stage, want in zip(ranks[arch], resized[arch]):
            for k, (a, x) in enumerate(zip(stage["shards"], want)):
                split = isinstance(x, ShardedTensor)
                n_split += split
                w = x.shards[r] if split else x
                assert a.dtype == w.dtype and torch.equal(a, w), (r, k)
    assert n_split > 0


@pytest.mark.parametrize("arch", R.ARCHS6)
def test_apply_resize_receives_at_most_the_new_shard(runs, arch):
    """A leaf split before and after moves by an all-to-all that brings a
    rank at most its new shard's bytes and no all-gather; only a leaf
    the new mesh leaves whole is gathered."""
    _, _, got = runs
    moved = 0
    for ranks in got[RESIZE_WORLD]:
        for stage in ranks[arch]:
            for leaf in stage["leaves"]:
                if leaf["was_split"] and leaf["split"]:
                    assert 0 < leaf["a2a"] <= leaf["shard_bytes"], leaf
                    assert leaf["gathered"] == 0, leaf
                    moved += 1
                elif not leaf["was_split"]:
                    assert leaf["a2a"] == leaf["gathered"] == 0, leaf
    assert moved > 0


def test_process_route_matches_the_reference(runs):
    """The reference's ``run_grid`` on the ``clean`` grid (pred_mode
    "sample", pred_seed 3) against the three ranks' gathered final state:
    every field bitwise but ``busy_cs``, whose float32 sum the two
    packages round apart (within ``TIME_RTOL``, as the sweep parity
    tests hold it); the reference's metrics' integer columns exactly."""
    from repro.xsim import grid as jgrid
    from repro.xsim import policies as jpolicies
    from repro_torch import convert

    cfg = jgrid.XSimConfig(n_warm=8, n_backlog=6, n_arrivals=8,
                           max_stages=9, t0=1800.0, pred_mode="sample")
    grid = jgrid.make_grid(cfg, policy_ids=(0, 1, 2, 3), n_seeds=1,
                           **R.FLEET_GRID)
    fleet = jpolicies.init_fleet(int(grid.geo_idx.max()) + 1)
    ref, ref_m = jgrid.run_grid(grid, fleet, pred_seed=3)
    want = convert.to_numpy(convert.scenario_state(
        jax.tree.map(np.asarray, ref)))
    _, ranks = _case(runs, 3, "clean")
    for got in ranks:
        f = got["final"]
        assert f.keys() == want.keys()
        for k in want:
            if k == "busy_cs":
                assert _rel(f[k], want[k]) <= TIME_RTOL
            else:
                np.testing.assert_array_equal(f[k], want[k], err_msg=k)
        for k, v in ref_m.items():
            v = np.asarray(v)
            if v.dtype.kind in "biu":
                np.testing.assert_array_equal(got["metrics"][k].numpy(), v)


class _FakeGroup:
    """A stand-in for ``dist.Group`` (no process group is joined)."""

    def __init__(self, size: int, index: int):
        self.size, self.index = size, index


def test_a_group_mesh_refuses_what_it_does_not_run():
    """A follower's rank cannot hold the server, rank 0 cannot follow,
    the supervisor refuses a process group's mesh, and a mesh's blocks
    must be the group's ranks."""
    cfg = ServeConfig(n_slots=8, batch_size=6)
    with pytest.raises(ValueError, match="follow"):
        ASAServer(cfg, mesh=ScenariosMesh(["cpu"] * 2,
                                          groups=_FakeGroup(2, 1)),
                  device="cpu")
    with pytest.raises(ValueError, match="rank other than 0"):
        follow(cfg, ScenariosMesh(["cpu"] * 2, groups=_FakeGroup(2, 0)),
               device="cpu")
    with pytest.raises(ValueError, match="rank other than 0"):
        follow(cfg, ScenariosMesh(["cpu"] * 2), device="cpu")
    with pytest.raises(ValueError, match="ServeSupervisor"):
        ServeSupervisor(cfg, mesh=ScenariosMesh(["cpu"] * 2,
                                                groups=_FakeGroup(2, 0)),
                        device="cpu")
    with pytest.raises(ValueError, match="3 blocks over a group of 2"):
        ScenariosMesh(["cpu"] * 3, groups=_FakeGroup(2, 0))


@pytest.mark.cuda
def test_two_ranks_on_the_card_sweep_phase_10_bitwise(tmp_path):
    """Two ranks on ``cuda:0`` (``gloo`` through pinned host buffers) run
    chip_smoke.py's phase 10 ``faulty`` setting, its warm round included,
    bitwise the one-process route over two blocks of the card, every
    scan launch ``fused``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the hand-written CUDA kernels have "
                    "no CPU or interpret mode")
    dev = torch.device("cuda", 0)
    ranks = R.Ranks("fleet_cuda", 2, tmp_path, deadline_s=600,
                    timeout_s=300)
    want = R.phase10_faulty(ScenariosMesh([dev] * 2), dev)
    ranks.check()
    for r in range(2):
        got = torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
        for key in ("fleet", "final", "metrics"):
            assert_same(got[key], want[key], f"rank {r} {key}")
        designs = got["designs"]
        assert designs["fused"] > 0 and sum(designs.values()) == \
            designs["fused"], designs

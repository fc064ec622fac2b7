"""Ranks for the port's process-group tests (``tests/test_torch_train_dist*.py``,
``tests/test_torch_fleet_dist.py``).

``spawn`` starts ``world`` processes (``multiprocessing``'s ``spawn``
start method), each of which joins a ``gloo`` group through a file under
the test's directory (no port is fixed) and runs one job of this module
as its rank; the parent waits for them until a deadline and kills what
is left. A rank's traceback is written to ``err<rank>.txt`` and fails
the test. This module imports ``torch`` and ``repro_torch`` only, so a
rank starts without jax.
"""

from __future__ import annotations

import dataclasses
import json
import multiprocessing
import os
import time
import traceback
from pathlib import Path

import torch

ARCHS6 = ("qwen2-0.5b", "moonshot-v1-16b-a3b", "rwkv6-3b", "zamba2-1.2b",
          "whisper-tiny", "pixtral-12b")
# as tests/test_torch_train_model_split.py: whisper's stacks split at
# d_ff 1024
WIDER = {"whisper-tiny": {"d_ff": 1024}}
RUN = dict(reduced=True, batch=4, seq=32, log_every=1)
CKPT_ARCH = "qwen2-0.5b"


def family_cfg(arch: str):
    """tests/test_torch_train_model_split.py's float32 reduced model."""
    from repro_torch.configs import ARCHS

    return dataclasses.replace(ARCHS[arch].reduced(), dtype="float32",
                               **WIDER.get(arch, {}))


def family_steps(arch: str, mesh, n: int = 2):
    """``n`` steps of ``arch`` on ``mesh`` from the parameters and
    batches of tests/test_torch_train_model_split.py -> (losses, grad
    norms, params, opt state)."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.parallel.sharding import ShardingRules, place
    from repro_torch.train import optimizer as TO
    from repro_torch.train.data import make_batch_fn
    from repro_torch.train.step import init_params, make_train_step

    cfg = family_cfg(arch)
    p = TO.tree_map(lambda x: x.float(), init_params(
        dataclasses.replace(cfg, dtype="bfloat16"), seed=2, device="cpu"))
    p = place(p, ShardingRules(mesh).tree_shardings(p))
    o = TO.init(p)
    step = make_train_step(cfg, remat="none")
    batch_fn = make_batch_fn(cfg, ShapeSpec("t", 32, 4, "train"), seed=1,
                             device="cpu")
    losses, norms = [], []
    for i in range(n):
        p, o, m = step(p, o, batch_fn(i))
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
    return losses, norms, p, o


def f32_archs():
    """The registry with ``CKPT_ARCH`` in float32, as
    tests/test_torch_train_sharded.py trains it."""
    from repro_torch.configs import ARCHS

    return dict(ARCHS, **{CKPT_ARCH: dataclasses.replace(
        ARCHS[CKPT_ARCH], dtype="float32")})


# ------------------------------------------------- the fleet's paths
#
# ``fleet_cases`` and ``serve_cases`` run the same calls on any
# ``scenarios`` mesh: the ranks' mesh (``make_scenarios_mesh`` under the
# group) or one process's ``ScenariosMesh(["cpu"] * world)``, so the
# test holds the two routes' results key by key.

FLEET_FAMILIES = ("clean", "faulty", "elastic", "preempt")
FLEET_GRID = dict(center_names=("hpc2n",), workflows=("blast",),
                  scales=(28, 112), shrink=1 / 64.0)


def fleet_cfg(pred_mode: str = "sample"):
    from repro_torch.xsim.grid import XSimConfig

    return XSimConfig(n_warm=8, n_backlog=6, n_arrivals=8, max_stages=9,
                      t0=1800.0, pred_mode=pred_mode)


def fleet_grid(family: str, cfg=None, policy_ids=(0, 1, 2, 3), n_seeds=1,
               seed: int = 0):
    """hpc2n at two of its scales, blast: B = 2 · |policies| · n_seeds (8
    for policies 0-3: padded on three blocks)."""
    from repro_torch.xsim.families import family_grid

    return family_grid(cfg or fleet_cfg(), family, policy_ids=policy_ids,
                       n_seeds=n_seeds, seed=seed, device="cpu",
                       **FLEET_GRID)


def _host(tree):
    """``tree`` with each ScenarioState as ``convert.to_numpy``'s dict and
    each tensor copied to the host (so a saved result holds no view of a
    larger buffer)."""
    from repro_torch import convert
    from repro_torch.xsim.state import ScenarioState

    if isinstance(tree, ScenarioState):
        return convert.to_numpy(tree)
    if isinstance(tree, torch.Tensor):
        return tree.cpu().clone()
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_host(x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_host(x) for x in tree)
    return tree


def fleet_cases(mesh) -> dict:
    """Every fleet path over ``mesh``: the sweep of each family with
    ASA-Naive (``faulty`` traced), with its ``sharded_batched_metrics`` and
    ``sharded_sweep_summary``; ``warm_fleet``; a rollout and one
    ``reinforce_step``; ``serve_step`` over several batches. Host copies,
    by case."""
    from repro_torch.core import prng
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.parallel import fleet as pfleet
    from repro_torch.rl import policy as rl_policy
    from repro_torch.rl import rollout
    from repro_torch.rl.train import reinforce_step
    from repro_torch.serve import asa as serve_asa
    from repro_torch.xsim import compare, policies
    from repro_torch.xsim.grid import run_grid, warm_fleet
    from repro_torch.xsim.state import RL

    out = {}
    for name in FLEET_FAMILIES:
        cfg = fleet_cfg().with_trace(64) if name == "faulty" else fleet_cfg()
        grid = fleet_grid(name, cfg)
        fleet = policies.init_fleet(int(grid.geo_idx.max()) + 1,
                                    device="cpu")
        final, m = run_grid(grid, fleet, pred_seed=3, mesh=mesh,
                            device="cpu")
        out[name] = dict(
            final=final, metrics=m,
            block_metrics=compare.sharded_batched_metrics(final, mesh),
            summary=obs_metrics.sharded_sweep_summary(
                final, mesh, n_steps=grid.cfg.n_steps),
            summary_whole=obs_metrics.sweep_summary(
                final, n_steps=grid.cfg.n_steps))
    grid = fleet_grid("clean", policy_ids=(1, 2), n_seeds=2)
    out["warm"] = warm_fleet(
        policies.init_fleet(int(grid.geo_idx.max()) + 1, device="cpu"),
        grid, rounds=2, mesh=mesh, device="cpu")
    grid = fleet_grid("clean", policy_ids=(RL,), n_seeds=2)   # B = 4
    params = rl_policy.init_params(prng.PRNGKey(0), device="cpu")
    final, m, traj = rollout.collect(
        grid, params, policies.init_fleet(int(grid.geo_idx.max()) + 1,
                                          device="cpu"),
        pred_seed=7, rl_mode="sample", mesh=mesh, device="cpu")
    new, ent = reinforce_step(params, traj.obs, traj.act, traj.reward, 0.3)
    out["rollout"] = dict(final=final, metrics=m, traj=tuple(traj),
                          params=tuple(new), entropy=ent)
    table = serve_asa.init_table(16, seed=3, device="cpu")
    steps = []
    for i in range(4):
        q, mask = pfleet.pad_batch(serve_query(10, seed=i), 12)
        table, dec = serve_asa.serve_step(table, q, mask, mesh=mesh)
        steps.append(dict(table=tuple(serve_asa.first_replica(table)),
                          replicas=len(table), decisions=tuple(dec)))
    out["serve_step"] = steps
    return _host(out)


def serve_query(n: int, seed: int = 0):
    """A busy batch: repeated decision slots, unique observation slots
    (the invariant the host batcher guarantees)."""
    import numpy as np

    from repro_torch.serve import asa as serve_asa

    rng = np.random.default_rng(seed)
    slot = rng.integers(0, 12, n).astype(np.int32)
    has = np.zeros(n, bool)
    seen = set()
    for i in range(n):
        if int(slot[i]) not in seen and rng.random() < 0.7:
            seen.add(int(slot[i]))
            has[i] = True
    return serve_asa.QueryBatch(
        slot=torch.as_tensor(slot),
        observed_wait=torch.as_tensor(
            rng.uniform(20.0, 3000.0, n).astype(np.float32)),
        has_obs=torch.as_tensor(has))


SERVE_CFG = dict(n_slots=8, batch_size=6)
# the serve job's group timeout: its idle server sends a keep-alive after
# a quarter of it
SERVE_TIMEOUT_S = 30


def _serve_stream(server, seed: int, rounds: int = 5) -> list:
    """``rounds`` batches of requests from 10 tenants through
    ``step_once``; the decisions as tuples."""
    import numpy as np

    rng = np.random.default_rng(seed)
    got = []
    for _ in range(rounds):
        futs = [server.submit(int(rng.integers(0, 10)),
                              float(rng.uniform(20, 2000))
                              if rng.random() < 0.6 else None)
                for _ in range(6)]
        while not all(f.done() for f in futs):
            server.step_once(wait_s=0)
        for f in futs:
            try:
                d = f.result()
                got.append((d.tenant, d.lead_s, d.expected_s, d.entropy))
            except Exception as e:   # a full table: its type is the answer
                got.append(type(e).__name__)
    return got


def serve_cases(mesh, ckpt: Path) -> dict:
    """An ``ASAServer`` over ``mesh`` (on a process group's mesh: rank 0;
    the other ranks ``follow``): a stream, saves at steps 1 and 2 around
    evictions and a stream that re-admits into freed slots; a server
    restored at step 1 fed that second stream; a server restored from
    the latest save (step 2) fed a third; then a fresh server's loop
    thread, idle between requests and once for longer than the keep-alive
    period. Its decisions, slots and replicas; on a group, the messages
    the loop thread's server sent (and each follower took) and its
    batches."""
    from repro_torch.parallel import dist
    from repro_torch.serve import asa as serve_asa
    from repro_torch.serve import loop
    from repro_torch.serve.loop import ASAServer, ServeConfig, follow

    cfg = ServeConfig(checkpoint_dir=str(ckpt), **SERVE_CFG)
    groups = getattr(mesh, "groups", None)
    # the followers start each replica as rank 0's server started it
    # (fresh, restored at step 1, restored from the latest step)
    if groups is not None and groups.index != 0:
        out = {key: tuple(follow(cfg, mesh, device="cpu"))
               for key in ("live_table", "restored_table", "latest_table")}
        sent = dist.COUNTS["broadcast"]["calls"]
        out["threaded_table"] = tuple(follow(cfg, mesh, device="cpu"))
        out["threaded_messages"] = dist.COUNTS["broadcast"]["calls"] - sent
        return _host(out)
    server = ASAServer(cfg, mesh=mesh, device="cpu")
    first = _serve_stream(server, seed=9)
    server.save(step=1)
    for t in sorted(server._slot_of)[:3]:
        server.evict(t)
    second = _serve_stream(server, seed=10)
    server.save(step=2)
    out = dict(first=first, second=second, slots=dict(server._slot_of),
               live_table=tuple(serve_asa.first_replica(server._table)),
               replicas=len(server._table))
    server.stop()
    restored = ASAServer.restore(cfg, step=1, mesh=mesh, device="cpu")
    for t in sorted(restored._slot_of)[:3]:
        restored.evict(t)
    out["restored_second"] = _serve_stream(restored, seed=10)
    out["restored_table"] = tuple(
        serve_asa.first_replica(restored._table))
    restored.stop()
    latest = ASAServer.restore(cfg, mesh=mesh, device="cpu")
    out["latest_third"] = _serve_stream(latest, seed=11)
    out["latest_table"] = tuple(serve_asa.first_replica(latest._table))
    latest.stop()
    # the loop thread: one request at a time, idle between them; on a
    # group, once past the keep-alive period (a share of the group's
    # collective timeout)
    idle = (loop.KEEPALIVE_SHARE * dist.timeout_s() + 0.5
            if groups is not None else 0.02)
    sent = dist.COUNTS["broadcast"]["calls"]
    server = ASAServer(cfg, mesh=mesh, device="cpu")
    server.start()
    threaded = []
    for t in range(4):
        time.sleep(idle if t == 2 else 0.02)
        d = server.submit(t, 100.0 * (t + 1)).result(timeout=60)
        threaded.append((d.tenant, d.lead_s, d.expected_s, d.entropy))
    server.stop()
    out["threaded"] = threaded
    out["threaded_table"] = tuple(serve_asa.first_replica(server._table))
    if groups is not None:
        out["threaded_messages"] = dist.COUNTS["broadcast"]["calls"] - sent
        out["threaded_batches"] = server.stats["batches"]
    return _host(out)


# chip_smoke.py's phase 10 setting (benchmarks/run.py's xsim leg with
# ASA-Naive), under the faulty family
PHASE10_CFG = dict(n_warm=24, n_backlog=16, n_arrivals=24, max_stages=9,
                   t0=3600.0)
PHASE10_GRID = dict(n_seeds=4, shrink=1 / 64.0, policy_ids=(0, 1, 2, 3))


def phase10_faulty(mesh, device) -> dict:
    """Phase 10's ``faulty`` run over ``mesh`` on ``device``: one warm
    round (through the mesh too), then the sweep at ``pred_seed=7``; the
    fleet, the final state, the metrics and the scan's launches by
    design."""
    from repro_torch.xsim import backfill, policies
    from repro_torch.xsim.families import family_grid
    from repro_torch.xsim.grid import XSimConfig, run_grid, warm_fleet

    grid = family_grid(XSimConfig(**PHASE10_CFG), "faulty", device=device,
                       **PHASE10_GRID)
    fleet = warm_fleet(policies.init_fleet(int(grid.geo_idx.max()) + 1,
                                           device=device),
                       grid, rounds=1, mesh=mesh, device=device)
    for counts in (backfill.KERNEL_LAUNCHES, backfill.DESIGN_LAUNCHES):
        counts.update({k: 0 for k in counts})
    final, m = run_grid(grid, fleet, pred_seed=7, mesh=mesh, device=device)
    return _host(dict(fleet=fleet, final=final, metrics=m,
                      designs=dict(backfill.DESIGN_LAUNCHES)))


def resize_meshes(world: int):
    """The meshes (data, model) a resize walks through: (2, 2), (4, 1),
    (1, 4) on four ranks."""
    return ((2, 2), (4, 1), (1, 4)) if world == 4 else ()


def resize_tree(arch: str):
    """tests/test_torch_train_model_split.py's float32 parameters of
    ``arch`` and an m and v made from them (a resize only moves values)."""
    from repro_torch.train import optimizer as TO
    from repro_torch.train.step import init_params

    cfg = family_cfg(arch)
    p = TO.tree_map(lambda x: x.float(), init_params(
        dataclasses.replace(cfg, dtype="bfloat16"), seed=2, device="cpu"))
    return {"params": p, "m": TO.tree_map(torch.sin, p),
            "v": TO.tree_map(lambda x: x * x, p)}


# ------------------------------------------------------------------ jobs


def job_families(rank: int, work: Path, model: int) -> None:
    """Every family's steps on the group's (world // model, model) mesh:
    this rank's losses, grad norms and own shards of params, m and v,
    and its collective counts."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel import dist
    from repro_torch.parallel.sharding import ShardedTensor
    from repro_torch.train import optimizer as TO

    mesh = make_local_mesh(model, device="cpu")
    out = {}
    for arch in ARCHS6:
        dist.reset_counts()
        losses, norms, p, o = family_steps(arch, mesh)

        def own(tree):
            return [x.shards[0] if isinstance(x, ShardedTensor) else x
                    for x in TO.leaves(tree)]

        out[arch] = dict(losses=losses, norms=norms, params=own(p),
                         m=own(o.m), v=own(o.v),
                         counts=json.loads(json.dumps(dist.COUNTS)))
    torch.save(out, work / f"rank{rank}.pt")


def job_restarts(rank: int, work: Path, model: int) -> None:
    """``launch.train`` on the group's mesh (qwen2, float32): (a) two
    steps saved at step 2 into ``proc``; (b) the one-process run's step
    2 resumed to step 4 in ``resume``; (c) the reference's step 2
    resumed to step 4 in ``ref_to_proc``."""
    from repro_torch.launch import train as ttrain

    ttrain.ARCHS = f32_archs()
    got = {}
    for name, steps in (("proc", 2), ("resume", 4), ("ref_to_proc", 4)):
        got[name] = ttrain.train(CKPT_ARCH, steps=steps,
                                 ckpt_dir=str(work / name), ckpt_every=2,
                                 model_parallel=model, device="cpu", **RUN)
    (work / f"restarts{rank}.json").write_text(json.dumps(got))


def job_collectives(rank: int, work: Path, model: int) -> None:
    """Each of ``dist``'s collectives on values that name their sender:
    what every rank received, and the counts."""
    from repro_torch.parallel import dist

    g = dist.mesh_groups(torch.distributed.get_world_size() // model,
                         model)
    mine = torch.arange(3, dtype=torch.float32) + 10 * rank
    out = {
        "position": (g.row, g.col),
        "data": g.data.ranks, "model": g.model.ranks,
        "world_gather": dist.all_gather(mine, g.world),
        "model_gather": dist.all_gather(mine.bfloat16(), g.model),
        "scalar_gather": dist.all_gather(torch.tensor(float(rank)),
                                         g.data),
        "to_all": dist.all_to_all([mine + 100 * k
                                   for k in range(g.data.size)], g.data),
        "gather": dist.gather(mine, g.world, 0),
        "broadcast": dist.broadcast(mine, g.world, 1),
        "agree": dist.agree(rank == 0, g.world),
        "counts": json.loads(json.dumps(dist.COUNTS)),
    }
    torch.save(out, work / f"rank{rank}.pt")


def job_fail(rank: int, work: Path, model: int) -> None:
    """A step in which rank 1 raises inside its loss (the MLP of the
    first layer): the other ranks wait in a collective until the group
    tells them that rank 1 is gone."""
    from repro_torch.models import layers as L

    real = L.apply_mlp

    def apply_mlp(*args, **kw):
        if torch.distributed.get_rank() == 1:
            raise RuntimeError("rank 1 fails mid-step on purpose")
        return real(*args, **kw)

    L.apply_mlp = apply_mlp
    from repro_torch.launch.mesh import make_local_mesh

    family_steps(CKPT_ARCH, make_local_mesh(model, device="cpu"), n=1)


def job_fleet(rank: int, work: Path, model: int) -> None:
    """``fleet_cases`` on the ranks' ``scenarios`` mesh, and each rank's
    collective counts."""
    from repro_torch.launch.mesh import make_scenarios_mesh, \
        shards_arg_error
    from repro_torch.parallel import dist

    mesh = make_scenarios_mesh(device="cpu")
    dist.reset_counts()
    out = fleet_cases(mesh)
    out["counts"] = json.loads(json.dumps(dist.COUNTS))
    out["mesh"] = (repr(mesh), mesh.groups.index, mesh.shape)
    out["mesh_checks"] = [shards_arg_error(n, flag="n_shards",
                                           device="cpu")
                          for n in (mesh.groups.size, 1)]
    torch.save(out, work / f"rank{rank}.pt")


def job_serve(rank: int, work: Path, model: int) -> None:
    """``serve_cases`` on the ranks' ``scenarios`` mesh, and each rank's
    collective counts."""
    from repro_torch.launch.mesh import make_scenarios_mesh
    from repro_torch.parallel import dist

    mesh = make_scenarios_mesh(device="cpu")
    dist.reset_counts()
    out = serve_cases(mesh, work / "serve_ckpt")
    out["counts"] = json.loads(json.dumps(dist.COUNTS))
    torch.save(out, work / f"rank{rank}.pt")


def job_resize(rank: int, work: Path, model: int) -> None:
    """For each family, ``resize_tree`` placed on (2, 2) and moved by
    ``apply_resize`` to (4, 1), then to (1, 4): this rank's shards after
    each move, and, leaf by leaf through ``device_put``, the bytes it
    received and its new shard's bytes."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel import dist
    from repro_torch.parallel.sharding import (ShardedTensor, ShardingRules,
                                               device_put, place)
    from repro_torch.runtime.elastic import apply_resize
    from repro_torch.train import optimizer as TO

    world = torch.distributed.get_world_size()
    (d0, m0), *moves = resize_meshes(world)
    out = {}
    for arch in ARCHS6:
        tree = resize_tree(arch)
        mesh = make_local_mesh(m0, device="cpu")
        tree = place(tree, ShardingRules(mesh).tree_shardings(tree))
        stages = []
        for _data, m in moves:
            new = make_local_mesh(m, device="cpu")
            rules = ShardingRules(new)
            leaves = []
            for x, sh in zip(TO.leaves(tree),
                             TO.leaves(rules.tree_shardings(tree))):
                dist.reset_counts()
                y = device_put(x, sh)
                split = isinstance(y, ShardedTensor)
                leaves.append(dict(
                    was_split=isinstance(x, ShardedTensor), split=split,
                    a2a=dist.COUNTS["all_to_all"]["bytes"],
                    gathered=dist.COUNTS["all_gather"]["bytes"],
                    shard_bytes=(y.shards[0] if split else y).numel()
                    * x.dtype.itemsize))
            tree = apply_resize(tree, new, rules)
            stages.append(dict(
                shards=[x.shards[0].clone() if isinstance(x, ShardedTensor)
                        else x.clone() for x in TO.leaves(tree)],
                leaves=leaves))
        out[arch] = stages
    torch.save(out, work / f"rank{rank}.pt")


def job_fleet_cuda(rank: int, work: Path, model: int) -> None:
    """``phase10_faulty`` on the ranks' ``scenarios`` mesh, every rank on
    its ``dist.local_device`` (``cuda:0`` on a one-card host)."""
    from repro_torch.launch.mesh import make_scenarios_mesh
    from repro_torch.parallel import dist

    dev = dist.local_device("cuda")
    torch.cuda.set_device(dev)
    mesh = make_scenarios_mesh(device="cuda")
    torch.save(phase10_faulty(mesh, dev), work / f"rank{rank}.pt")


JOBS = {f.__name__[4:]: f for f in (job_families, job_restarts,
                                    job_collectives, job_fail, job_fleet,
                                    job_serve, job_resize, job_fleet_cuda)}


def _rank(rank: int, world: int, work: str, job: str, model: int,
          timeout_s: float) -> None:
    from repro_torch.parallel import dist

    work = Path(work)
    try:
        dist.init(rank, world, init_method=f"file://{work / 'init'}",
                  timeout_s=timeout_s)
        torch.set_num_threads(1)   # as the one-process route in the tests
        JOBS[job](rank, work, model)
    except BaseException:
        (work / f"err{rank}.txt").write_text(traceback.format_exc())
        os._exit(1)
    dist.destroy()


class Ranks:
    """``world`` rank processes of ``job``, started at once; ``wait``
    joins them until ``deadline_s`` after the start -> {rank: exit code},
    killing what still runs (code None). ``timeout_s`` is the group's."""

    def __init__(self, job: str, world: int, work: Path, *, model: int = 1,
                 deadline_s: float = 240, timeout_s: float = 120):
        ctx = multiprocessing.get_context("spawn")
        work.mkdir(parents=True, exist_ok=True)
        self.work = work
        self.procs = [ctx.Process(target=_rank,
                                  args=(r, world, str(work), job, model,
                                        timeout_s))
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self.end = time.monotonic() + deadline_s

    def wait(self) -> dict:
        for p in self.procs:
            p.join(max(0.0, self.end - time.monotonic()))
        codes = {}
        for r, p in enumerate(self.procs):
            if p.is_alive():
                p.kill()
                p.join()
                codes[r] = None
            else:
                codes[r] = p.exitcode
        return codes

    def check(self) -> None:
        """``wait``, failing with the ranks' tracebacks unless every rank
        ended with 0 before the deadline."""
        codes = self.wait()
        assert all(c == 0 for c in codes.values()), (codes,
                                                     errors(self.work))


def spawn(job: str, world: int, work: Path, **kw) -> dict:
    """Run ``job`` on ``world`` ranks (``Ranks``) -> {rank: exit code}."""
    return Ranks(job, world, work, **kw).wait()


def errors(work: Path) -> str:
    """The ranks' tracebacks, if any."""
    return "\n".join(f"--- {f.name}\n{f.read_text()}"
                     for f in sorted(work.glob("err*.txt")))


def run(job: str, world: int, work: Path, **kw) -> None:
    """``spawn``, failing with the ranks' tracebacks unless every rank
    ended with 0 before the deadline."""
    Ranks(job, world, work, **kw).check()

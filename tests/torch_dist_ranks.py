"""Ranks for the port's process-group tests (``tests/test_torch_train_dist*.py``).

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


JOBS = {f.__name__[4:]: f for f in (job_families, job_restarts,
                                    job_collectives, job_fail)}


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


def spawn(job: str, world: int, work: Path, *, model: int = 1,
          deadline_s: float = 240, timeout_s: float = 120) -> dict:
    """Run ``job`` on ``world`` ranks of a (world // model, model) mesh
    -> {rank: exit code}, killing what still runs at ``deadline_s``
    (code None). ``timeout_s`` is the group's."""
    ctx = multiprocessing.get_context("spawn")
    work.mkdir(parents=True, exist_ok=True)
    procs = [ctx.Process(target=_rank, args=(r, world, str(work), job,
                                             model, timeout_s))
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline_s
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    codes = {}
    for r, p in enumerate(procs):
        if p.is_alive():
            p.kill()
            p.join()
            codes[r] = None
        else:
            codes[r] = p.exitcode
    return codes


def errors(work: Path) -> str:
    """The ranks' tracebacks, if any."""
    return "\n".join(f"--- {f.name}\n{f.read_text()}"
                     for f in sorted(work.glob("err*.txt")))


def run(job: str, world: int, work: Path, **kw) -> None:
    """``spawn``, failing with the ranks' tracebacks unless every rank
    ended with 0 before the deadline."""
    codes = spawn(job, world, work, **kw)
    assert all(c == 0 for c in codes.values()), (codes, errors(work))

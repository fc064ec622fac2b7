"""End-to-end training driver (port of ``repro.launch.train``): the config
registry, parameters placed on the host's (data, model) mesh, the
synthetic data pipeline, AdamW, and checkpoint/restart (it resumes
automatically from the latest complete step).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
      --device cuda --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

(``--reduced --device cpu`` for a seconds-long CPU run.)

The parameters and AdamW's m and v are placed by
``ShardingRules.tree_shardings`` on the mesh (FSDP over ``data``, TP/EP
over ``model``): a leaf that an axis of extent > 1 splits becomes a
``ShardedTensor``, gathered at use by the step (``train.step``), which
takes a microbatch a data row of the mesh. ``mesh=`` (a
``launch.mesh.DeviceMesh``, whose positions may repeat a device) stands
in for the reference's faked devices: ``train(..., mesh=DeviceMesh(grid,
("data", "model")))`` with ``grid`` a (2, 2) array of ``cpu`` trains
with every parameter split on the CPU. Without it the mesh is
``make_local_mesh(model_parallel)`` over the host's devices. A restart
restores its checkpoint onto the mesh it is given, whatever mesh wrote
it (an elastic restart); on a one-device mesh nothing is split and the
route is the unsplit one.

Parameters are kept in float32, as the reference keeps them, and cast to
the activation type at use (``train.step.params_at_use``): an update
smaller than half a bfloat16 step of its weight still lands. The starting
weights come from the port's ``init_lm`` (a ``torch.Generator``), so
``train(seed=s)`` starts from other weights than the reference's
``train(seed=s)``; the two packages are compared through
``convert.lm_params`` or through checkpoints, which restore in either.
The batches are the reference's, bitwise. The checkpoint holds
``{"params", "m", "v", "step"}`` in the reference's format, written by
``save_async`` every ``ckpt_every`` steps; the last save is joined before
returning. The loss is read back to the host only at the ``log_every``
steps (and the last).
"""

from __future__ import annotations

import argparse
import time

from repro_torch.configs import ARCHS, ShapeSpec
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.parallel.sharding import (NamedSharding, PartitionSpec as P,
                                           ShardingRules, place)
from repro_torch.runtime import checkpoint as CKPT
from repro_torch.train import optimizer as OPT
from repro_torch.train.data import make_batch_fn
from repro_torch.train.step import init_params, make_train_step


def train(arch: str, *, reduced: bool = True, steps: int = 50,
          batch: int = 8, seq: int = 128, ckpt_dir: str | None = None,
          ckpt_every: int = 20, seed: int = 0, remat: str = "none",
          log_every: int = 10, model_parallel: int = 1,
          device: str = "cuda", mesh=None) -> dict:
    cfg = ARCHS[arch]
    if reduced:
        cfg = cfg.reduced()
    if mesh is None:
        mesh = make_local_mesh(model=model_parallel, device=device)
    rules = ShardingRules(mesh)
    shape = ShapeSpec("custom", seq, batch, "train")

    params = OPT.tree_map(lambda p: p.float(),
                          init_params(cfg, seed=seed, device=mesh.device))
    shardings = rules.tree_shardings(params)
    params = place(params, shardings)
    opt_state = OPT.init(params)

    start_step = 0
    if ckpt_dir:
        last = CKPT.latest_step(ckpt_dir)
        if last is not None:
            state = CKPT.restore(
                {"params": params, "m": opt_state.m, "v": opt_state.v,
                 "step": opt_state.step}, ckpt_dir, last,
                shardings={"params": shardings, "m": shardings,
                           "v": shardings,
                           "step": NamedSharding(mesh, P())})
            params = state["params"]
            opt_state = OPT.AdamWState(step=state["step"], m=state["m"],
                                       v=state["v"])
            start_step = last
            print(f"resumed from step {last}")

    step_fn = make_train_step(cfg, remat=remat)
    batch_fn = make_batch_fn(cfg, shape, seed=seed, device=mesh.device)

    losses = []
    t0 = time.time()
    pending_save = None
    for step in range(start_step, steps):
        b = batch_fn(step)
        params, opt_state, metrics = step_fn(params, opt_state, b)
        if step % log_every == 0 or step == steps - 1:
            l = float(metrics["loss"])
            losses.append((step, l))
            print(f"step {step:5d}  loss {l:.4f}  "
                  f"({time.time() - t0:.1f}s)", flush=True)
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            pending_save = CKPT.save_async(
                {"params": params, "m": opt_state.m, "v": opt_state.v,
                 "step": opt_state.step}, ckpt_dir, step + 1)
    if pending_save is not None:
        pending_save.join()
    return {"losses": losses, "final_loss": losses[-1][1],
            "first_loss": losses[0][1], "steps": steps}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    res = train(args.arch, reduced=args.reduced, steps=args.steps,
                batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, remat=args.remat,
                model_parallel=args.model_parallel, device=args.device)
    print(f"loss {res['first_loss']:.4f} -> {res['final_loss']:.4f}")


if __name__ == "__main__":
    main()

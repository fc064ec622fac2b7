"""Dry run of every (arch × shape × mesh) cell on meta tensors (port of
``repro.launch.dryrun``).

The reference lowers and compiles each cell for 256 or 512 fake CPU
devices and reads XLA's memory and cost analysis. The port has no
compiler to ask, so it plans each cell on the ``meta`` device, where
tensors have shapes and dtypes but no storage: nothing is allocated and
no card is needed. Each record keeps the reference's keys where they mean
the same thing:

* ``memory.argument_size_in_bytes``: per device, the sum of each
  argument's local shard (``NamedSharding.shard_shape`` of its
  ``PartitionSpec`` on the mesh): for train the parameters, the AdamW
  state and the batch; for prefill the parameters and the inputs; for
  decode the parameters, the caches or state, the token and the index.
  Parameters are float32, as the reference lowers them (and as
  ``launch.train`` keeps them).
* ``memory.temp_size_in_bytes``: the peak of the bytes that one step of
  the step function allocates (``LiveBytes``: each op's new outputs added,
  taken off when the last tensor on their storage dies), the step run on
  meta tensors at the per-device batch. A train step on a mesh whose
  ``model`` axis is m > 1 runs split over a (1, m) mesh of meta devices,
  each layer's compute split over ``model`` (``parallel.model_split``),
  and counts one position: a tensor made from one position's blocks (its
  gathered blocks, its heads', columns' or experts' activations, its
  logits' block, the backward's buffers of its share, its blocks'
  gradients and new blocks) at that position alone, the rest (replicated
  work, the sums across positions, leaves no rule splits over ``model``,
  the global norm's buffer) at every position. Leaves split over the
  FSDP axes only are gathered whole and their gradients kept whole, so
  the count is still an upper bound on one device's working memory.
* ``cost.flops``: ``torch.utils.flop_counter.FlopCounterMode`` over the
  same step at the global shape (matrix products and attention; a
  recomputing ``remat`` counts its recomputation).
* ``n_devices``, and ``fits_80gb``: arguments plus temporaries within an
  H100's 80 GB.

There is no HLO, so the reference's ``collectives`` inventory is absent
(``collectives_absent`` says why). Records go to
``experiments/dryrun_torch/``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
import weakref
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS, cells
from repro_torch.launch import specs as SPECS
from repro_torch.launch.mesh import DeviceMesh, make_production_mesh
from repro_torch.models import lm, lm_module
from repro_torch.parallel.sharding import (NamedSharding, PartitionSpec as P,
                                           ShardedTensor, ShardingRules,
                                           flatten_with_path, model_dim,
                                           place, taken_by_layer)
from repro_torch.serve.step import make_decode_step, make_prefill_step
from repro_torch.train import optimizer as OPT
from repro_torch.train.step import make_train_step, params_at_use

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
HBM_BYTES = 80 * 10 ** 9
META = torch.device("meta")
NO_COLLECTIVES = ("no HLO to read collectives from: one process gathers "
                  "split parameters, sums the model positions' partial "
                  "outputs (parallel.model_split) and adds row gradients "
                  "itself (train.step); copies between cards and one "
                  "process a position are later work (ROADMAP Queue 1 "
                  "item 12(e)-(f), item 11's follow-ups)")
TEMP_NOTE = ("peak bytes one step allocates on meta tensors at the "
             "per-device batch, at one 'model' position: a layer split "
             "over 'model' at one position's width and its gradients at "
             "their block size; leaves split over the FSDP axes alone are "
             "gathered whole and their gradients kept whole: an upper "
             "bound")


class LiveBytes(TorchDispatchMode):
    """Counts the bytes that ops allocate while the mode is on: an op's
    output on a storage that no input shares is a new allocation; the
    bytes come off when the last tensor seen on that storage dies.
    ``positions`` names the ``model`` position of some tensors (a
    position's blocks); an op whose inputs are of one position makes
    tensors of that position, counted for it alone, and the others count
    for every position: ``peak`` is the most that was live at once at one
    position."""

    def __init__(self, positions=()):
        super().__init__()
        self.peak = 0
        self.live: dict = {}                # position (None: all) -> bytes
        self._refs: dict[int, int] = {}     # storage -> live tensors on it
        self._position = {t.untyped_storage()._cdata: j   # storage -> j
                          for t, j in positions}

    def _release(self, key: int, nbytes: int, j) -> None:
        self._refs[key] -= 1
        if not self._refs[key]:
            del self._refs[key]
            self._position.pop(key, None)
            self.live[j] -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        inputs = {t.untyped_storage()._cdata
                  for t in tree_leaves((args, kwargs))
                  if isinstance(t, torch.Tensor)}
        of = {self._position[k] for k in inputs if k in self._position}
        j = of.pop() if len(of) == 1 else None
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            store = t.untyped_storage()
            key, nbytes = store._cdata, store.nbytes()
            if key not in self._refs:
                if key in inputs:
                    continue            # a view of memory from outside
                self._refs[key] = 0
                if j is not None:
                    self._position[key] = j
                self.live[j] = self.live.get(j, 0) + nbytes
                self.peak = max(self.peak, self.live.get(None, 0) + max(
                    (v for k, v in self.live.items() if k is not None),
                    default=0))
            self._refs[key] += 1
            weakref.finalize(t, self._release, key, nbytes, j)
        return out


def param_specs(cfg) -> dict:
    """The parameter tree as float32 meta tensors."""
    return lm.unflatten({
        path: torch.empty(leaf.shape, dtype=torch.float32, device=META)
        for path, leaf in lm_module(cfg).flat_specs(cfg).items()})


def _nbytes(shape, dtype) -> int:
    n = torch.empty((), dtype=dtype).element_size()
    for d in shape:
        n *= d
    return n


def local_leaves(tree, shardings) -> dict:
    """``{path: (leaf, its sharding)}`` of ``tree`` and the tree of
    ``NamedSharding`` that matches it."""
    sh = dict(flatten_with_path(shardings))
    return {path: (x, sh[path]) for path, x in flatten_with_path(tree)}


def local_bytes(tree, shardings) -> int:
    """Per-device bytes of the leaves of ``tree`` under the matching
    leaves of ``shardings``."""
    return sum(_nbytes(s.shard_shape(tuple(x.shape)), x.dtype)
               for x, s in local_leaves(tree, shardings).values())


def position_blocks(tree) -> list:
    """(block, j) for each block of a leaf of ``tree`` (parameters, or
    trees holding them such as the AdamW state) that its spec splits over
    ``model`` (``sharding.model_dim``): the blocks of ``model`` position
    j."""
    out = []
    for path, x in flatten_with_path(tree):
        if not isinstance(x, ShardedTensor):
            continue
        leaf = "/".join(k for k in path if isinstance(k, str))
        d = model_dim(x.sharding.spec, taken_by_layer(leaf))
        if d is None:
            continue
        width = x.shape[d] // x.sharding.mesh.shape["model"]
        out += [(x.shards[k], x.indices[k][d].start // width)
                for k in x.firsts]
    return out


def _prefill_step(cfg):
    """The reference's prefill step: the serving prefill of a transformer,
    the encoder–decoder and the VLM; for RWKV-6 and Zamba2 the last row
    of the teacher-forced forward, as the reference's (the port's serving
    prefill of Zamba2 takes the prompt past its KV ring a token at a
    time)."""
    if cfg.family in ("ssm", "hybrid"):
        forward = lm_module(cfg).forward
        return lambda params, tokens: forward(params, tokens, cfg)[:, -1:]
    return make_prefill_step(cfg)


def _step(cfg, shape, *, remat: str, accum: int, model: int = 1):
    """(run, args): one step of ``shape.kind`` on meta stand-ins at
    ``shape``'s batch, with the arguments it was given. A train step with
    ``model`` > 1 runs on parameters split over a (1, ``model``) mesh of
    meta devices: the split step, a layer's compute split over ``model``
    (``parallel.model_split``)."""
    params = param_specs(cfg)
    if shape.kind == "train":
        if model > 1:
            grid = np.empty((1, model), dtype=object)
            grid.fill(META)
            mesh = DeviceMesh(grid, ("data", "model"))
            params = place(params, ShardingRules(mesh).tree_shardings(params))
        opt = OPT.init(params)
        batch = SPECS.train_batch_specs(cfg, shape)
        step = make_train_step(cfg, accum=accum, remat=remat)
        return (lambda: step(params, opt, batch)), (params, opt, batch)
    used = params_at_use(params, cfg)
    if shape.kind == "prefill":
        args = SPECS.prefill_args(cfg, shape)
        step = _prefill_step(cfg)
        return (lambda: step(used, *args)), (params,) + args
    args = SPECS.decode_args(cfg, shape)
    step = make_decode_step(cfg)
    index = shape.seq_len - 1
    if cfg.family == "ssm":
        run = lambda: step(used, *args)                       # noqa: E731
    else:
        run = lambda: step(used, args[0], args[1], index)     # noqa: E731
    return run, (params,) + args


def _arg_shardings(cfg, shape, rules, mesh, args):
    scalar = NamedSharding(mesh, P())
    p_sh = rules.tree_shardings(args[0])
    if shape.kind == "train":
        opt = OPT.AdamWState(step=scalar, m=p_sh, v=p_sh)
        return (p_sh, opt, SPECS.batch_shardings(args[2], rules, mesh))
    if shape.kind == "prefill":
        return (p_sh,) + tuple(
            NamedSharding(mesh, rules.batch_spec(a.shape[0], a.dim()))
            for a in args[1:])
    return (p_sh,) + tuple(SPECS.decode_shardings(cfg, shape, rules, mesh))


def plan_cell(cfg, shape, mesh, mesh_name: str, *, remat: str = "dots",
              accum: int = 1) -> dict:
    """The record of one (arch × shape × mesh) cell (see the module's
    docstring)."""
    rec = {"arch": cfg.name, "shape": shape.name, "mesh": mesh_name,
           "kind": shape.kind, "remat": remat, "accum": accum,
           "status": "pending"}
    t0 = time.time()
    rules = ShardingRules(mesh)
    run, args = _step(cfg, shape, remat=remat, accum=accum)
    shardings = _arg_shardings(cfg, shape, rules, mesh, args)
    arg_bytes = local_bytes(args, shardings)
    with FlopCounterMode(display=False) as flops:
        run()
    del run, args
    rec["plan_s"] = round(time.time() - t0, 1)

    B = shape.global_batch
    n = rules.n_fsdp if rules.fsdp and B % rules.n_fsdp == 0 else 1
    local = dataclasses.replace(shape, global_batch=B // n)
    run, args = _step(cfg, local, remat=remat, accum=accum,
                      model=mesh.shape.get("model", 1))
    with LiveBytes(position_blocks(args)) as live:
        out = run()
        del out
    del run, args
    temp = live.peak
    rec["memory"] = {"argument_size_in_bytes": arg_bytes,
                     "temp_size_in_bytes": temp, "temp_note": TEMP_NOTE}
    rec["cost"] = {"flops": flops.get_total_flops()}
    rec["collectives_absent"] = NO_COLLECTIVES
    rec["n_devices"] = int(mesh.devices.size)
    rec["local_batch"] = B // n
    rec["fits_80gb"] = arg_bytes + temp <= HBM_BYTES
    rec["status"] = "ok"
    rec["total_s"] = round(time.time() - t0, 1)
    return rec


def run_cells(cell_list, mesh_names, out_dir: Path, remat: str = "dots"):
    """Plan every cell on every named mesh (``single``: 16×16, ``multi``:
    2×16×16), a JSON record a cell in ``out_dir`` (a cell already there
    is kept)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    meshes = {name: make_production_mesh(multi_pod=(name == "multi"))
              for name in mesh_names}
    results = []
    for cfg, shape, skip in cell_list:
        for mesh_name, mesh in meshes.items():
            out_path = out_dir / f"{cfg.name}__{shape.name}__{mesh_name}.json"
            if skip:
                rec = {"arch": cfg.name, "shape": shape.name,
                       "mesh": mesh_name, "status": "skip", "reason": skip}
            elif out_path.exists():
                print(f"cached  {out_path.name}")
                continue
            else:
                print(f"plan    {cfg.name} × {shape.name} × {mesh_name} ...",
                      flush=True)
                try:
                    rec = plan_cell(cfg, shape, mesh, mesh_name, remat=remat)
                    m = rec["memory"]
                    print(f"  ok    args {m['argument_size_in_bytes']} B "
                          f"temp {m['temp_size_in_bytes']} B flops "
                          f"{rec['cost']['flops']:.4g} fits_80gb "
                          f"{rec['fits_80gb']} ({rec['total_s']} s)",
                          flush=True)
                except Exception as e:
                    rec = {"arch": cfg.name, "shape": shape.name,
                           "mesh": mesh_name, "status": "fail",
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-3000:]}
                    print(f"  FAIL  {type(e).__name__}: {str(e)[:160]}",
                          flush=True)
            out_path.write_text(json.dumps(rec, indent=1, default=str))
            results.append(rec)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=sorted(ARCHS))
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi",
                                                       "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--remat", default="dots")
    ap.add_argument("--out", default=str(OUT_DIR))
    args = ap.parse_args(argv)

    mesh_names = (["single", "multi"] if args.mesh == "both"
                  else [args.mesh])
    all_cells = cells()
    # cheap first, as the reference orders them
    cost_rank = {"whisper-tiny": 0, "qwen2-0.5b": 1, "gemma-2b": 2,
                 "zamba2-1.2b": 3, "rwkv6-3b": 4, "qwen1.5-4b": 5,
                 "deepseek-7b": 6, "moonshot-v1-16b-a3b": 7,
                 "pixtral-12b": 8, "qwen3-moe-235b-a22b": 9}
    all_cells.sort(key=lambda c: (cost_rank.get(c[0].name, 99),
                                  c[1].seq_len * c[1].global_batch))
    if not args.all:
        if args.arch:
            all_cells = [c for c in all_cells if c[0].name == args.arch]
        if args.shape:
            all_cells = [c for c in all_cells if c[1].name == args.shape]
    results = run_cells(all_cells, mesh_names, Path(args.out),
                        remat=args.remat)
    ok = sum(1 for r in results if r.get("status") == "ok")
    fail = sum(1 for r in results if r.get("status") == "fail")
    skip = sum(1 for r in results if r.get("status") == "skip")
    print(f"\ndone: {ok} ok, {fail} fail, {skip} skip")
    return 1 if fail else 0


if __name__ == "__main__":
    raise SystemExit(main())

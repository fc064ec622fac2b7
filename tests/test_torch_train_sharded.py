"""Training with parameters split over a (data, model) mesh, on the CPU
(``parallel.sharding.ShardedTensor``, ``train.step.make_train_step`` on
split trees, ``launch.train(mesh=)``, ``runtime.checkpoint.restore(shardings=)``,
``runtime.elastic.apply_resize``).

The meshes repeat the one CPU at every position (``DeviceMesh`` over
``cpu``): the port's counterpart of the reference's
``--xla_force_host_platform_device_count``. The reference runs in a
subprocess with 4 fake devices, its (2, 2) mesh built with automatic
axes (``AxisType.Auto``, GSPMD's): jax 0.9's ``make_mesh`` defaults to
explicit axes, under which the reference's ``train(model_parallel=2)``
fails at its embedding gather.

* Placement: every leaf's local shard at each mesh position equals the
  reference's ``addressable_shards`` on the same position (index, shape
  and values, bit for bit), for one reduced model of each of the six
  families (moonshot's experts split over ``model``), each with leaves
  of its stacks of layers split; and the batch's rows (tokens, labels,
  whisper's ``frames``, pixtral's ``patch_embeds``) that the split step
  gives each data row are the reference's blocks of the batch at that
  row's positions.
* The step: on a (k, 1) mesh, bitwise ``make_train_step(accum=k)`` on
  one device from the same state (loss, grad norm, parameters, m, v
  after 2 steps), for all six families under ``remat`` "none" and
  "dots" (and "full" for the hybrid). A mesh with a ``model`` axis m > 1
  splits each layer's compute over it and adds the positions' partial
  sums (ROADMAP Queue 1 item 12(d); ``tests/test_torch_train_model_split.py``):
  on (1, m) the step is held in float32 to the unsplit step, the losses
  within ``LOSS_ULPS``, the grad norms within ``GRAD_REL``, the
  parameters within ``PARAM_ATOL`` and m and v within ``MOMENT_REL``
  (rel_rms), under the same policies. One step function follows its tree onto another
  mesh: it reads the data rows from the leaves.
* One layer at a time: during a step's forward and backward, under each
  ``remat`` policy, the gathered tensors alive at any gather are one
  layer's, of its leaves split over ``model`` one position's block, and
  the top-level leaves'; none of a layer's is alive when the backward
  starts. Each split leaf's gradient is summed in block accumulators
  (on (2, 1) each bitwise its slice of the ``accum=2`` route's whole
  accumulator, on (2, 2) bitwise its rows' block gradients summed), the
  positions that hold a block sharing its accumulator; the global norm
  assembles one leaf at a time in one buffer. A spec that splits the
  layer axis gathers and differentiates as the unsplit leaf.
* Checkpoints both ways, in float32: the reference's ``train`` with
  ``model_parallel=2`` saves at step 2, the port resumes on its (2, 2)
  mesh, and the other way round; the losses of steps 2 and 3 within
  ``LOSS_ULPS`` float32 steps of the other package's uninterrupted run,
  the step-4 parameters within ``PARAM_ATOL`` (1.4e-7, the float32
  steps' reading in ``tests/test_torch_train.py``). Measured: losses 1
  and 2 float32 steps apart (8.5e-8 and 1.7e-7 relative at a loss of
  5.5), parameters 1.5e-8 and 3.0e-8. The loss is a step further off
  than the one-device steps' 1.7e-7 reading allows for because the two
  programs reduce in other orders: the reference's partitioned step
  adds each data row's partial sums across the mesh, the port takes
  each row's mean and averages the rows.
* Elastic restart: saved on (2, 2), resumed on (4, 1) and on (1, 1),
  each bitwise the ``accum=4`` or ``accum=1`` run from the same
  checkpoint; ``apply_resize`` (2, 2) → (4, 1) bitwise.
* On the dry run's meta mesh a split leaf gets a ``meta`` shard a
  position and allocates nothing.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, ShapeSpec
from repro_torch.launch import dryrun as D
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import DeviceMesh, make_production_mesh
from repro_torch.models import lm
from repro_torch.parallel import model_split as MS
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.sharding import (NamedSharding, PartitionSpec as P,
                                           ShardedTensor, ShardingRules,
                                           SplitAtUse, gather_tree, place)
from repro_torch.runtime import checkpoint as TCKPT
from repro_torch.runtime.elastic import apply_resize
from repro_torch.train import optimizer as TO
from repro_torch.train import step as TS
from repro_torch.train.data import make_batch_fn
from repro_torch.train.step import init_params, make_train_step

torch.set_num_threads(1)   # small tensors: threads only contend

SRC = Path(__file__).resolve().parents[1] / "src"
RUN = dict(reduced=True, batch=4, seq=32, log_every=1)
LOSS_ULPS = 3
PARAM_ATOL = 1.4e-7
# over a ``model`` split (float32): the gradients' limit in
# tests/test_torch_train.py, rel_rms 1e-4, bounds the grad norm (| |a| -
# |b| | <= |a - b|) and m, a sum of gradients; v, of their squares, twice
# it. Measured at most 2.2e-6 (the norm) and 5.4e-6 (rwkv6's moments).
GRAD_REL = 1e-4
MOMENT_REL = {"m": 1e-4, "v": 2e-4}
SHARD_ARCHS = ("qwen2-0.5b", "moonshot-v1-16b-a3b", "rwkv6-3b",
               "zamba2-1.2b", "whisper-tiny", "pixtral-12b")
CKPT_ARCH = "qwen2-0.5b"
# Widths past ``reduced()``'s: the rules take only ``layers/...`` paths
# as stacked, so whisper's ``enc_layers/...`` and ``dec_layers/...``
# leaves fall to the fallback rule, which splits a leaf's largest
# dimension over the FSDP axes only when it is at least 1024 (both
# packages alike). At d_ff 1024 the MLPs of both stacks split: ``w_up``
# and ``b_up`` on their d_ff axis, ``w_down`` on its first.
WIDER = {"whisper-tiny": {"d_ff": 1024}}
# Leaves of each model's stacks of layers that a (2, 2) mesh splits.
STACK_SPLITS = {
    "qwen2-0.5b": ("layers/attn/wq", "layers/mlp/w_down"),
    "moonshot-v1-16b-a3b": ("layers/moe/w_gate", "layers/attn/wo"),
    "rwkv6-3b": ("layers/time_mix/wr", "layers/channel_mix/w_in"),
    "zamba2-1.2b": ("layers/mamba/w_in_x", "layers/mamba/w_out"),
    "whisper-tiny": ("enc_layers/mlp/w_up", "enc_layers/mlp/b_up",
                     "enc_layers/mlp/w_down", "dec_layers/mlp/w_up",
                     "dec_layers/mlp/b_up", "dec_layers/mlp/w_down"),
    "pixtral-12b": ("layers/attn/wq", "layers/mlp/w_up"),
}


def cpu_mesh(data: int, model: int) -> DeviceMesh:
    grid = np.empty((data, model), dtype=object)
    grid.fill(torch.device("cpu"))
    return DeviceMesh(grid, ("data", "model"))


def _f32(arch: str):
    return dataclasses.replace(ARCHS[arch], dtype="float32")


def _cfg(arch: str):
    return dataclasses.replace(ARCHS[arch].reduced(), **WIDER.get(arch, {}))


def _params(arch: str, seed: int = 0) -> dict:
    return TO.tree_map(lambda p: p.float(), init_params(
        _cfg(arch), seed=seed, device="cpu"))


def _batch_fn(arch: str):
    return make_batch_fn(_cfg(arch), ShapeSpec("t", 32, 4, "train"), seed=1,
                         device="cpu")


REF = r'''
import os, sys, json, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
import numpy as np
jax.config.update("jax_threefry_partitionable", True)
from repro.configs import ARCHS
from repro.launch import train as jtrain
from repro.parallel.sharding import ShardingRules

from jax.sharding import AxisType


def auto_local_mesh(model=1):
    # jax 0.9's make_mesh defaults to explicit axes, under which the
    # reference's jitted step cannot gather from a split embedding; its
    # code was written for GSPMD's automatic axes
    n = len(jax.devices())
    return jax.make_mesh((n // model, model), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


jtrain.make_local_mesh = auto_local_mesh
work = sys.argv[1]
job = json.loads(open(os.path.join(work, "job.json")).read())
mesh = auto_local_mesh(model=2)
assert mesh.devices.shape == (2, 2)
out, index = {}, {}
for arch in job["shard_archs"]:
    flat = dict(np.load(os.path.join(work, arch + ".npz")))
    tree = {}
    for path, x in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = x
    rules = ShardingRules(mesh)
    for path, x in flat.items():
        arr = jax.device_put(x, jax.sharding.NamedSharding(
            mesh, rules.spec_for(path, x.shape)))
        by_dev = {s.device: s for s in arr.addressable_shards}
        for i, d in enumerate(mesh.devices.flat):
            s = by_dev[d]
            key = f"{arch}|{path}|{i}"
            out[key] = np.asarray(s.data)
            index[key] = [[sl.start or 0, x.shape[j] if sl.stop is None
                           else sl.stop] for j, sl in enumerate(s.index)]
for arch, shapes in job["batch_shapes"].items():
    rules = ShardingRules(mesh)
    for name, shape in shapes.items():
        blocks = jax.sharding.NamedSharding(
            mesh, rules.batch_spec(shape[0], len(shape))
        ).devices_indices_map(tuple(shape))
        for i, d in enumerate(mesh.devices.flat):
            index[f"{arch}|batch/{name}|{i}"] = [
                [sl.start or 0, shape[j] if sl.stop is None else sl.stop]
                for j, sl in enumerate(blocks[d])]
np.savez(os.path.join(work, "shards.npz"), **out)
arch = job["ckpt_arch"]
jtrain.ARCHS = dict(ARCHS, **{arch: dataclasses.replace(ARCHS[arch],
                                                        dtype="float32")})
run = dict(job["run"], model_parallel=2)
full = jtrain.train(arch, steps=4, ckpt_dir=os.path.join(work, "ref"),
                    ckpt_every=2, **run)
resumed = jtrain.train(arch, steps=4,
                       ckpt_dir=os.path.join(work, "port_to_ref"),
                       ckpt_every=2, **run)
json.dump({"index": index, "full": full["losses"],
           "resumed": resumed["losses"]}, sys.stdout)
'''


@pytest.fixture(scope="module")
def packages(tmp_path_factory):
    """The port's float32 run on its (2, 2) mesh (saves at steps 2 and
    4), then one reference subprocess: the local shards of the port's
    parameters, the reference's float32 run with ``model_parallel=2``
    (saves at 2 and 4) and its resumption from the port's step 2."""
    work = tmp_path_factory.mktemp("sharded")
    for arch in SHARD_ARCHS:
        flat = {path: x.numpy() for path, x in
                lm.flatten(_params(arch, seed=5)).items()}
        np.savez(work / f"{arch}.npz", **flat)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttrain, "ARCHS",
                   dict(ARCHS, **{CKPT_ARCH: _f32(CKPT_ARCH)}))
        port = ttrain.train(CKPT_ARCH, steps=4, ckpt_dir=str(work / "port"),
                            ckpt_every=2, mesh=cpu_mesh(2, 2), device="cpu",
                            **RUN)
    (work / "port_to_ref").mkdir()
    shutil.copytree(work / "port" / "step_2",
                    work / "port_to_ref" / "step_2")
    (work / "job.json").write_text(json.dumps({
        "shard_archs": list(SHARD_ARCHS), "ckpt_arch": CKPT_ARCH,
        "run": RUN, "batch_shapes": {
            arch: {k: list(v.shape) for k, v in _batch_fn(arch)(0).items()}
            for arch in SHARD_ARCHS}}))
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", REF, str(work)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    ref = json.loads(res.stdout.strip().splitlines()[-1])
    return work, port, ref


@pytest.mark.parametrize("arch", SHARD_ARCHS)
def test_local_shards_are_the_reference_addressable_shards(packages, arch):
    work, _, ref = packages
    want = np.load(work / "shards.npz")
    mesh = cpu_mesh(2, 2)
    params = _params(arch, seed=5)
    placed = place(params, ShardingRules(mesh).tree_shardings(params))
    n_split = 0
    for path, x in lm.flatten(placed).items():
        whole = lm.flatten(params)[path]
        shards = x.shards if isinstance(x, ShardedTensor) else [x] * 4
        n_split += isinstance(x, ShardedTensor)
        for i, shard in enumerate(shards):
            key = f"{arch}|{path}|{i}"
            np.testing.assert_array_equal(shard.numpy(), want[key],
                                          err_msg=key)
            assert shard.shape == want[key].shape, key
            if isinstance(x, ShardedTensor):
                got = [[s.start, s.stop] for s in x.indices[i]]
                assert got == ref["index"][key], key
        assert x.shape == whole.shape
    assert n_split >= 8
    for path in STACK_SPLITS[arch]:
        assert isinstance(lm.flatten(placed)[path], ShardedTensor), path
    if arch == "moonshot-v1-16b-a3b":   # experts split over model (EP)
        w = lm.flatten(placed)["layers/moe/w_gate"]
        assert isinstance(w, ShardedTensor)
        assert w.sharding.spec[1] == "model"


@pytest.mark.parametrize("arch", SHARD_ARCHS)
def test_data_rows_take_the_reference_batch_blocks(packages, arch,
                                                   monkeypatch):
    """The rows of every batch entry (whisper's frames and pixtral's
    patch embeddings with the tokens and labels) that the split step's
    loss reads for data row r are the reference's block of the batch at
    each position of row r."""
    _, _, ref = packages
    cfg = _cfg(arch)
    batch = _batch_fn(arch)(0)
    assert {"audio": "frames", "vlm": "patch_embeds"}.get(
        cfg.family, "tokens") in batch
    rows = []
    real = TS.model_loss

    def spy(params, b, cfg, **kw):
        rows.append(b)
        return real(params, b, cfg, **kw)

    monkeypatch.setattr(TS, "model_loss", spy)
    mesh = cpu_mesh(2, 2)
    p0 = _params(arch, seed=2)
    sp = place(p0, ShardingRules(mesh).tree_shardings(p0))
    make_train_step(cfg, remat="none")(sp, TO.init(sp), batch)
    assert len(rows) == 2
    for name, x in batch.items():
        for i in range(4):
            (lo, hi), *rest = ref["index"][f"{arch}|batch/{name}|{i}"]
            assert rest == [[0, n] for n in x.shape[1:]]
            assert torch.equal(rows[i // 2][name], x[lo:hi]), (name, i)


def _steps(arch: str, data: int, model: int, n: int = 2,
           remat: str = "none"):
    """``n`` steps on a (data, model) mesh and ``accum=data`` on one
    device from the same state and batches: bitwise where ``model`` is
    1; over a ``model`` split, which adds the positions' partial sums
    (ROADMAP Queue 1 item 12(d)), in float32, the losses within
    ``LOSS_ULPS``, the grad norms within ``GRAD_REL``, the parameters
    within ``PARAM_ATOL`` and the moments within ``MOMENT_REL``. Either
    way each shard holds its block of the split route's own leaves."""
    cfg = _cfg(arch) if model == 1 else dataclasses.replace(_cfg(arch),
                                                           dtype="float32")
    batch_fn = _batch_fn(arch)
    p0 = _params(arch, seed=2)
    ref_p = TO.tree_map(lambda p: p.clone(), p0)
    ref_o = TO.init(ref_p)
    mesh = cpu_mesh(data, model)
    sp = place(TO.tree_map(lambda p: p.clone(), p0),
               ShardingRules(mesh).tree_shardings(p0))
    so = TO.init(sp)
    assert any(isinstance(x, ShardedTensor) for x in TO.leaves(sp))
    step = make_train_step(cfg, accum=data, remat=remat)
    sstep = make_train_step(cfg, remat=remat)
    for i in range(n):
        b = batch_fn(i)
        ref_p, ref_o, rm = step(ref_p, ref_o, b)
        sp, so, sm = sstep(sp, so, b)
        if model == 1:
            assert torch.equal(rm["loss"], sm["loss"]), (rm, sm)
            assert torch.equal(rm["grad_norm"], sm["grad_norm"])
        else:
            assert _ulps(sm["loss"], rm["loss"]) <= LOSS_ULPS, (rm, sm)
            assert abs(float(sm["grad_norm"]) - float(rm["grad_norm"])) \
                <= GRAD_REL * float(rm["grad_norm"]), (rm, sm)
    for name, got, want in (("params", sp, ref_p), ("m", so.m, ref_o.m),
                            ("v", so.v, ref_o.v)):
        for a, b in zip(TO.leaves(gather_tree(got)), TO.leaves(want)):
            if model == 1:
                assert torch.equal(a, b), name
            elif name == "params":
                assert float((a - b).abs().max()) <= PARAM_ATOL, name
            elif b.any():
                assert _rel_rms(a, b) <= MOMENT_REL[name], name
            else:
                assert not a.any(), name
    assert int(so.step) == n
    # the shards hold their blocks of the updated leaves, and the
    # positions that a spec replicates hold equal copies
    for x, whole in zip(TO.leaves(sp), TO.leaves(gather_tree(sp))):
        if isinstance(x, ShardedTensor):
            for index, shard in zip(x.indices, x.shards):
                assert torch.equal(shard, whole[index])


def _rel_rms(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).double().pow(2).mean().sqrt()
                 / want.double().pow(2).mean().sqrt())


def _ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """|got − want| in float32 steps at ``want``."""
    return abs(float(got) - float(want)) / float(
        np.spacing(np.float32(abs(float(want)))))


REMATS = [(arch, "dots") for arch in SHARD_ARCHS] + [("zamba2-1.2b",
                                                      "full")]


@pytest.mark.parametrize("arch", SHARD_ARCHS)
def test_split_step_is_the_accum_step_bitwise(arch):
    _steps(arch, 2, 1)


@pytest.mark.parametrize("arch,remat", REMATS)
def test_split_step_under_remat_is_the_accum_step_bitwise(arch, remat):
    _steps(arch, 2, 1, remat=remat)


def test_four_data_rows_are_accum_four_bitwise():
    _steps("qwen2-0.5b", 4, 1)


@pytest.mark.parametrize("model", [2, 4])
def test_one_row_mesh_is_the_unsplit_step_to_float32(model):
    _steps("qwen2-0.5b", 1, model)


@pytest.mark.parametrize("arch,remat",
                         [(arch, "none") for arch in SHARD_ARCHS[1:]]
                         + REMATS)
def test_one_row_mesh_of_each_family_is_the_unsplit_step_to_float32(
        arch, remat):
    _steps(arch, 1, 2, remat=remat)


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
@pytest.mark.parametrize("arch", SHARD_ARCHS)
def test_one_layer_is_gathered_at_a_time(arch, remat, monkeypatch):
    """Every tensor a gather builds (``sharding._build``: a forward's
    gather, a backward's or a recomputation's gather again) is watched
    by a weak reference. At each gather the layers' gathered tensors
    alive are of one layer and, of its leaves split over ``model``, one
    position's block (gathered over the FSDP axes), with at most the
    top-level gathers beside them; when the backward starts none of a
    layer's is alive (autograd saved how to gather them again, not
    them)."""
    cfg = _cfg(arch)
    mesh = cpu_mesh(2, 2)
    p0 = _params(arch, seed=2)
    sp = place(p0, ShardingRules(mesh).tree_shardings(p0))
    split = {path: x for path, x in lm.flatten(sp).items()
             if isinstance(x, ShardedTensor)}

    def per_use(path, x):      # gathers a use: a block a model position
        stacked = SH.taken_by_layer(path)
        return (2 if SH.model_dim(x.sharding.spec, stacked) is not None
                else 1) * (x.shape[0] if stacked else 1)

    n_top = sum(per_use(path, x) for path, x in split.items()
                if not SH.taken_by_layer(path))
    n_layer_gathers = sum(per_use(path, x) for path, x in split.items()
                          if SH.taken_by_layer(path))
    key_of, live = {}, []
    gathers = {"forward": 0, "backward": 0}
    phase = ["forward"]
    real_layer, real_build, real_grad = (SH.SplitAtUse.layer, SH._build,
                                         torch.autograd.grad)

    def layer(self, i):
        plans = [(self._layers[i][0], None)] + [
            (plan, j) for j, (plan, _) in enumerate(
                self._positions[i] if self._positions else ())]
        for plan, j in plans:      # the plans kept: their ids stay
            key_of[id(plan)] = (plan, (i, j))
        return real_layer(self, i)

    def alive():
        return [k for ref, k in live if ref() is not None]

    def build(plan, blocks):
        out = real_build(plan, blocks)
        live.append((weakref.ref(out), key_of.get(id(plan), (0, None))[1]))
        gathers[phase[0]] += 1
        now = alive()
        layers = [k for k in now if k is not None]
        assert len({i for i, _ in layers}) <= 1, remat
        assert len({j for _, j in layers if j is not None}) <= 1, remat
        assert now.count(None) <= n_top
        return out

    def grad(*args, **kw):
        assert [k for k in alive() if k is not None] == [], remat
        phase[0] = "backward"
        try:
            return real_grad(*args, **kw)
        finally:
            phase[0] = "forward"

    monkeypatch.setattr(SH.SplitAtUse, "layer", layer)
    monkeypatch.setattr(SH, "_build", build)
    monkeypatch.setattr(torch.autograd, "grad", grad)
    make_train_step(cfg, remat=remat)(sp, TO.init(sp), _batch_fn(arch)(0))
    # two data rows: each gathers the top-level leaves once (a block a
    # position where split over model) and every stacked leaf a layer
    # (and a position) at a time, and gathers again in its backward
    assert n_layer_gathers >= 4
    assert gathers["forward"] == 2 * (n_top + n_layer_gathers)
    assert gathers["backward"] >= 2


@pytest.mark.parametrize("arch", SHARD_ARCHS)
def test_block_accumulators_are_slices_of_the_accum_accumulator(
        arch, monkeypatch):
    """The gradients that ``OPT.update`` takes from a split step: each
    split leaf's is one float32 accumulator a distinct block, of the
    shard's shape (no whole-leaf accumulator), shared by the positions
    that hold the block; the global norm assembles the split leaves one
    at a time in one buffer. On a (2, 1) mesh each accumulator is
    bitwise its slice of the ``accum=2`` route's whole accumulator; on
    (2, 2), whose ``model`` split computes other partial sums, it is
    bitwise the rows' block gradients of the split route's own run,
    summed in row order and divided by the rows."""
    cfg = _cfg(arch)
    p0 = _params(arch, seed=2)
    batch = _batch_fn(arch)(0)
    taken, norm_outs, added = [], [], []
    real_update, real_gather = TO.update, ShardedTensor.gather
    real_add = TS._add_blocks

    def update(params, grads, state, **kw):
        taken.append(grads)
        return real_update(params, grads, state, **kw)

    def gather(self, device=None, dtype=None, out=None):
        if out is not None:
            norm_outs.append((out.untyped_storage().data_ptr(), out.numel()))
        return real_gather(self, device, dtype, out)

    def add_blocks(blocks, grads):
        added.append((blocks, [(slot, g.clone()) for slot, g in grads
                               if g is not None]))
        return real_add(blocks, grads)

    monkeypatch.setattr(TO, "update", update)
    monkeypatch.setattr(ShardedTensor, "gather", gather)
    monkeypatch.setattr(TS, "_add_blocks", add_blocks)
    ref_p = TO.tree_map(lambda p: p.clone(), p0)
    make_train_step(cfg, accum=2, remat="none")(ref_p, TO.init(ref_p),
                                                batch)
    whole = taken.pop()
    for data, model in ((2, 1), (2, 2)):
        added.clear()
        norm_outs.clear()
        mesh = cpu_mesh(data, model)
        sp = place(TO.tree_map(lambda p: p.clone(), p0),
                   ShardingRules(mesh).tree_shardings(p0))
        make_train_step(cfg, remat="none")(sp, TO.init(sp), batch)
        split = taken.pop()
        # the split route's own rows, summed in order into fresh blocks
        own = {}
        for blocks, grads in added:
            acc = own.setdefault(id(blocks[0]), [torch.zeros_like(b)
                                                 for b in blocks])
            for (b, j), g in grads:
                (acc[b] if j is None else acc[b][j]).add_(g)
        n_split = 0
        for g, want, x in zip(split, whole, TO.leaves(sp)):
            if not isinstance(x, ShardedTensor):
                if model == 1:
                    assert torch.equal(g, want)
                continue
            n_split += 1
            assert isinstance(g, ShardedTensor) and g.dtype == torch.float32
            blocks = g.blocks()
            for k, (index, shard) in enumerate(zip(g.indices, g.shards)):
                assert shard is blocks[g.block_of[k]]
                assert shard.shape == x.shards[k].shape
                assert shard.numel() < want.numel()
                if model == 1:
                    assert torch.equal(shard, want[index])
                else:
                    assert torch.equal(
                        shard, own[id(blocks[0])][g.block_of[k]] / 2)
        assert n_split >= 8
        sizes = [x.numel() for x in TO.leaves(sp)
                 if isinstance(x, ShardedTensor)]
        assert len(norm_outs) == n_split
        assert len({ptr for ptr, _ in norm_outs}) == 1
        assert sorted(n for _, n in norm_outs) == sorted(sizes)


@pytest.mark.parametrize("spec", [P("data", None, "model"),
                                  P(("data", "model"), None, None),
                                  P(None, "model", "data")])
def test_a_split_stacked_leaf_gathers_and_differentiates_by_layer(spec):
    """``SplitAtUse`` on a stacked leaf whose spec may split the layer
    axis: layer i gathered is the unsplit leaf's ``x[i]`` in the use
    type, bitwise (whole, where the spec splits a dimension over
    ``model`` and layer i is handed out as its positions' blocks), and
    the inputs' gradients of a loss over every layer are the unsplit
    leaf's gradient (through the same cast), block by block and layer by
    layer, rounded to float32; a leaf outside the stacks is gathered
    whole."""
    rng = np.random.default_rng(0)
    mesh = cpu_mesh(2, 2)
    x = torch.from_numpy(rng.normal(size=(4, 6, 8)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(4, 6, 8)).astype(np.float32))
    sx = place(x, NamedSharding(mesh, spec))
    assert isinstance(sx, ShardedTensor)
    leaf = x.clone().requires_grad_()
    cast = leaf.to(torch.bfloat16)
    want = torch.autograd.grad(sum(
        torch.sum(torch.sin(cast[i].float()) * w[i]) for i in range(4)),
        leaf)[0]
    at = SplitAtUse(sx, torch.bfloat16, stacked=True)
    layers = [_whole(at.layer(i)) for i in range(4)]
    for i, got in enumerate(layers):
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, x[i].to(torch.bfloat16))
    gs = torch.autograd.grad(sum(
        torch.sum(torch.sin(layers[i].float()) * w[i]) for i in range(4)),
        at.inputs)
    blocks = [sx.indices[k] for k in sx.firsts]
    assert len(gs) == len(at.slots) == sum(b[0].stop - b[0].start
                                           for b in blocks)
    for (b, j), g in zip(at.slots, gs):
        index = blocks[b]
        assert g.dtype == torch.float32
        assert torch.equal(g, want[index][j])
    whole = SplitAtUse(sx, torch.bfloat16, stacked=False).whole()
    assert torch.equal(whole, x.to(torch.bfloat16))


def _whole(x):
    """A layer as ``SplitAtUse`` hands it out, whole (``model_split.Blocks``
    gathered whole)."""
    return x.whole() if isinstance(x, MS.Blocks) else x


def test_a_split_leaf_reads_as_a_stacked_leaf_in_its_use_type():
    """The forwards take layer i of a stacked leaf with ``[i]``
    (``models.lm.layer``) and cast every leaf to its use type
    (``train.step.params_at_use``): on a ``SplitAtUse`` ``[i]`` is layer
    i gathered (here as its ``model`` positions' blocks, whole on
    ``whole()``), ``lm.layer`` gathers through it, and the cast to its
    own type is itself; a cast to another type raises, since its layers
    are gathered in one type."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(4, 6, 8)).astype(np.float32))
    sx = place(x, NamedSharding(cpu_mesh(2, 2), P("data", None, "model")))
    at = SplitAtUse(sx, torch.bfloat16, stacked=True)
    assert at.to(torch.bfloat16) is at
    with pytest.raises(ValueError, match="split at use"):
        at.to(torch.float32)
    for i in range(4):
        assert torch.equal(_whole(at[i]), x[i].to(torch.bfloat16))
        got = lm.layer({"mlp": {"w": at}, "b": x}, i)
        assert torch.equal(_whole(got["mlp"]["w"]), x[i].to(torch.bfloat16))
        assert torch.equal(got["b"], x[i])


def test_one_step_follows_its_tree_onto_another_mesh():
    """A step function built once takes its data rows from the tree it is
    given: a step on (2, 2), then parameters, m and v moved by
    ``apply_resize`` onto (4, 1) and a step there, bitwise a separate
    run of the (2, 2) split step (its ``model`` split computes its own
    partial sums) gathered onto one device and then ``accum=4``."""
    cfg = ARCHS["qwen2-0.5b"].reduced()
    batch_fn = make_batch_fn(cfg, ShapeSpec("t", 32, 4, "train"), seed=1,
                             device="cpu")
    p0 = _params("qwen2-0.5b", seed=2)
    old, new = cpu_mesh(2, 2), cpu_mesh(4, 1)

    def on_old():
        sp = place(TO.tree_map(lambda p: p.clone(), p0),
                   ShardingRules(old).tree_shardings(p0))
        return sp, TO.init(sp)

    ref_p, ref_o = on_old()
    ref_p, ref_o, first = make_train_step(cfg, remat="none")(
        ref_p, ref_o, batch_fn(0))
    ref_p, ref_m, ref_v = (gather_tree(t) for t in (ref_p, ref_o.m,
                                                    ref_o.v))
    ref_o = TO.AdamWState(ref_o.step, ref_m, ref_v)
    sp, so = on_old()
    sstep = make_train_step(cfg, remat="none")
    for i, accum in enumerate((2, 4)):
        if accum == 4:
            rules = ShardingRules(new)
            sp = apply_resize(sp, new, rules)
            so = TO.AdamWState(so.step, apply_resize(so.m, new, rules),
                               apply_resize(so.v, new, rules))
            ref_p, ref_o, rm = make_train_step(cfg, accum=4, remat="none")(
                ref_p, ref_o, batch_fn(i))
        else:
            rm = first
        sp, so, sm = sstep(sp, so, batch_fn(i))
        assert torch.equal(rm["loss"], sm["loss"]), accum
        assert torch.equal(rm["grad_norm"], sm["grad_norm"]), accum
    assert all(x.sharding.mesh is new for x in TO.leaves(sp)
               if isinstance(x, ShardedTensor))
    for got, want in ((sp, ref_p), (so.m, ref_o.m), (so.v, ref_o.v)):
        for a, b in zip(TO.leaves(gather_tree(got)), TO.leaves(want)):
            assert torch.equal(a, b)


def _losses_close(got, want) -> float:
    want = dict(want)
    assert [s for s, _ in got] == [2, 3]
    worst = 0.0
    for s, loss in got:
        ulps = abs(loss - want[s]) / float(np.spacing(np.float32(want[s])))
        worst = max(worst, ulps)
        assert ulps <= LOSS_ULPS, (s, loss, want[s])
    return worst


def _params_close(got_dir: Path, want_dir: Path) -> float:
    def read(d):
        man = json.loads((d / "step_4" / "manifest.json").read_text())
        tree = {m["name"]: torch.zeros(m["shape"], dtype=torch.float32)
                for m in man["leaves"] if m["name"].startswith("params_")}
        return TCKPT.restore(tree, d, 4, device="cpu")
    got, want = read(got_dir), read(want_dir)
    assert got.keys() == want.keys()
    worst = max(float((got[k] - want[k]).abs().max()) for k in want)
    assert worst <= PARAM_ATOL, worst
    return worst


def test_reference_checkpoint_resumes_on_the_port_mesh(packages,
                                                       monkeypatch):
    work, port, ref = packages
    monkeypatch.setattr(ttrain, "ARCHS",
                        dict(ARCHS, **{CKPT_ARCH: _f32(CKPT_ARCH)}))
    (work / "ref_to_port").mkdir(exist_ok=True)
    shutil.copytree(work / "ref" / "step_2", work / "ref_to_port" / "step_2",
                    dirs_exist_ok=True)
    resumed = ttrain.train(CKPT_ARCH, steps=4,
                           ckpt_dir=str(work / "ref_to_port"), ckpt_every=2,
                           mesh=cpu_mesh(2, 2), device="cpu", **RUN)
    _losses_close(resumed["losses"], ref["full"])
    _params_close(work / "ref_to_port", work / "ref")


def test_port_checkpoint_resumes_on_the_reference_mesh(packages):
    work, port, ref = packages
    _losses_close([tuple(x) for x in ref["resumed"]], port["losses"])
    _params_close(work / "port_to_ref", work / "port")


def _read(directory, step: int, like) -> dict:
    return TCKPT.restore(like, directory, step, device="cpu")


def test_elastic_restart_onto_other_meshes_bitwise(tmp_path):
    """Saved on (2, 2) at step 2; resumed on (4, 1) and on (1, 1) to step
    4, each bitwise the ``accum=4`` / ``accum=1`` steps from the restored
    checkpoint on one device."""
    arch = CKPT_ARCH
    cfg = ARCHS[arch].reduced()
    ttrain.train(arch, steps=2, ckpt_dir=str(tmp_path / "a"), ckpt_every=2,
                 mesh=cpu_mesh(2, 2), device="cpu", **RUN)
    params = _params(arch)
    opt = TO.init(params)
    like = {"params": params, "m": opt.m, "v": opt.v, "step": opt.step}
    batch_fn = make_batch_fn(cfg, ShapeSpec("custom", RUN["seq"],
                                            RUN["batch"], "train"),
                             seed=0, device="cpu")
    for (data, model), accum in (((4, 1), 4), ((1, 1), 1)):
        d = tmp_path / f"{data}x{model}"
        d.mkdir()
        shutil.copytree(tmp_path / "a" / "step_2", d / "step_2")
        got = ttrain.train(arch, steps=4, ckpt_dir=str(d), ckpt_every=2,
                           mesh=cpu_mesh(data, model), device="cpu", **RUN)
        state = _read(d, 2, like)
        p, o = state["params"], TO.AdamWState(state["step"], state["m"],
                                              state["v"])
        step = make_train_step(cfg, accum=accum, remat="none")
        losses = []
        for s in (2, 3):
            p, o, m = step(p, o, batch_fn(s))
            losses.append((s, float(m["loss"])))
        assert got["losses"] == losses, (data, model)
        final = _read(d, 4, like)
        for name, want in (("params", p), ("m", o.m), ("v", o.v)):
            for a, b in zip(TO.leaves(final[name]), TO.leaves(want)):
                assert torch.equal(a, b), (data, model, name)


def test_apply_resize_is_bitwise():
    params = _params("moonshot-v1-16b-a3b")
    old, new = cpu_mesh(2, 2), cpu_mesh(4, 1)
    placed = place(params, ShardingRules(old).tree_shardings(params))
    moved = apply_resize(placed, new, ShardingRules(new))
    for path, x in lm.flatten(moved).items():
        whole = lm.flatten(params)[path]
        if isinstance(x, ShardedTensor):
            assert x.sharding.mesh is new
            assert len(x.shards) == 4
            for index, shard in zip(x.indices, x.shards):
                assert torch.equal(shard, whole[index]), path
            assert torch.equal(x.gather(), whole), path
        else:
            assert torch.equal(x, whole), path


def test_device_put_on_the_meta_production_mesh():
    """The dry run's 16×16 mesh of ``meta`` devices: a split leaf of
    qwen2-0.5b at published size gets 256 ``meta`` shards of its shard
    shape, and the argument bytes a device count those shards."""
    mesh = make_production_mesh()
    rules = ShardingRules(mesh)
    params = D.param_specs(ARCHS["qwen2-0.5b"])
    shardings = rules.tree_shardings(params)
    placed = place(params, shardings)
    n_split = 0
    want_bytes = 0
    for path, x in lm.flatten(placed).items():
        sh = lm.flatten(shardings)[path]
        shard = sh.shard_shape(tuple(x.shape))
        want_bytes += 4 * int(np.prod(shard))
        if isinstance(x, ShardedTensor):
            n_split += 1
            assert len(x.shards) == 256
            assert all(s.device.type == "meta" and tuple(s.shape) == shard
                       for s in x.shards), path
        else:
            assert x.device.type == "meta"
    assert n_split >= 8
    assert D.local_bytes(params, shardings) == want_bytes

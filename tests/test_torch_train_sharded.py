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
  and values, bit for bit), for the reduced qwen2-0.5b and moonshot
  (experts split over ``model``).
* The step: on a (k, m) mesh, bitwise ``make_train_step(accum=k)`` on
  one device from the same state (loss, grad norm, parameters, m, v
  after 2 steps), for the ``dense``, ``moe`` and ``hybrid`` families; on
  a (1, m) mesh bitwise the unsplit step. One step function follows its
  tree onto another mesh: it reads the data rows from the leaves.
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
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, ShapeSpec
from repro_torch.launch import dryrun as D
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import DeviceMesh, make_production_mesh
from repro_torch.models import lm
from repro_torch.parallel.sharding import (ShardedTensor, ShardingRules,
                                           gather_tree, place)
from repro_torch.runtime import checkpoint as TCKPT
from repro_torch.runtime.elastic import apply_resize
from repro_torch.train import optimizer as TO
from repro_torch.train.data import make_batch_fn
from repro_torch.train.step import init_params, make_train_step

torch.set_num_threads(1)   # small tensors: threads only contend

SRC = Path(__file__).resolve().parents[1] / "src"
RUN = dict(reduced=True, batch=4, seq=32, log_every=1)
LOSS_ULPS = 3
PARAM_ATOL = 1.4e-7
SHARD_ARCHS = ("qwen2-0.5b", "moonshot-v1-16b-a3b")
CKPT_ARCH = "qwen2-0.5b"


def cpu_mesh(data: int, model: int) -> DeviceMesh:
    grid = np.empty((data, model), dtype=object)
    grid.fill(torch.device("cpu"))
    return DeviceMesh(grid, ("data", "model"))


def _f32(arch: str):
    return dataclasses.replace(ARCHS[arch], dtype="float32")


def _params(arch: str, seed: int = 0) -> dict:
    return TO.tree_map(lambda p: p.float(), init_params(
        ARCHS[arch].reduced(), seed=seed, device="cpu"))


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
        "run": RUN}))
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
    if arch == "moonshot-v1-16b-a3b":   # experts split over model (EP)
        w = lm.flatten(placed)["layers/moe/w_gate"]
        assert isinstance(w, ShardedTensor)
        assert w.sharding.spec[1] == "model"


def _steps(arch: str, data: int, model: int, n: int = 2):
    """``n`` steps on a (data, model) mesh and ``accum=data`` on one
    device from the same state and batches."""
    cfg = ARCHS[arch].reduced()
    batch_fn = make_batch_fn(cfg, ShapeSpec("t", 32, 4, "train"), seed=1,
                             device="cpu")
    p0 = _params(arch, seed=2)
    ref_p = TO.tree_map(lambda p: p.clone(), p0)
    ref_o = TO.init(ref_p)
    mesh = cpu_mesh(data, model)
    sp = place(TO.tree_map(lambda p: p.clone(), p0),
               ShardingRules(mesh).tree_shardings(p0))
    so = TO.init(sp)
    assert any(isinstance(x, ShardedTensor) for x in TO.leaves(sp))
    step = make_train_step(cfg, accum=data, remat="none")
    sstep = make_train_step(cfg, remat="none")
    for i in range(n):
        b = batch_fn(i)
        ref_p, ref_o, rm = step(ref_p, ref_o, b)
        sp, so, sm = sstep(sp, so, b)
        assert torch.equal(rm["loss"], sm["loss"]), (rm, sm)
        assert torch.equal(rm["grad_norm"], sm["grad_norm"])
    for name, got, want in (("params", sp, ref_p), ("m", so.m, ref_o.m),
                            ("v", so.v, ref_o.v)):
        for a, b in zip(TO.leaves(gather_tree(got)), TO.leaves(want)):
            assert torch.equal(a, b), name
    assert int(so.step) == n
    # the shards hold their blocks of the updated leaves, and the
    # positions that a spec replicates hold equal copies
    for x, whole in zip(TO.leaves(sp), TO.leaves(ref_p)):
        if isinstance(x, ShardedTensor):
            for index, shard in zip(x.indices, x.shards):
                assert torch.equal(shard, whole[index])


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "moonshot-v1-16b-a3b",
                                  "zamba2-1.2b"])
def test_split_step_is_the_accum_step_bitwise(arch):
    _steps(arch, 2, 2)


def test_four_data_rows_are_accum_four_bitwise():
    _steps("qwen2-0.5b", 4, 1)


@pytest.mark.parametrize("model", [2, 4])
def test_one_row_mesh_is_the_unsplit_step_bitwise(model):
    _steps("qwen2-0.5b", 1, model)


def test_one_step_follows_its_tree_onto_another_mesh():
    """A step function built once takes its data rows from the tree it is
    given: a step on (2, 2), then parameters, m and v moved by
    ``apply_resize`` onto (4, 1) and a step there, bitwise ``accum=2``
    then ``accum=4`` on one device."""
    cfg = ARCHS["qwen2-0.5b"].reduced()
    batch_fn = make_batch_fn(cfg, ShapeSpec("t", 32, 4, "train"), seed=1,
                             device="cpu")
    p0 = _params("qwen2-0.5b", seed=2)
    ref_p = TO.tree_map(lambda p: p.clone(), p0)
    ref_o = TO.init(ref_p)
    old, new = cpu_mesh(2, 2), cpu_mesh(4, 1)
    sp = place(TO.tree_map(lambda p: p.clone(), p0),
               ShardingRules(old).tree_shardings(p0))
    so = TO.init(sp)
    sstep = make_train_step(cfg, remat="none")
    for i, accum in enumerate((2, 4)):
        if accum == 4:
            rules = ShardingRules(new)
            sp = apply_resize(sp, new, rules)
            so = TO.AdamWState(so.step, apply_resize(so.m, new, rules),
                               apply_resize(so.v, new, rules))
        b = batch_fn(i)
        ref_p, ref_o, rm = make_train_step(cfg, accum=accum, remat="none")(
            ref_p, ref_o, b)
        sp, so, sm = sstep(sp, so, b)
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

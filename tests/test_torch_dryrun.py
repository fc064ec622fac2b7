"""The port's dry run (``launch.mesh.make_production_mesh``,
``launch.specs``, ``launch.dryrun``) against the reference's, on the CPU.

The reference needs 512 fake CPU devices
(``--xla_force_host_platform_device_count=512`` before jax is imported,
as ``repro.launch.dryrun`` sets it), so it runs in a subprocess that
prints JSON; the port's meshes are ``meta`` devices and need nothing.

* The production meshes: shapes and axes.
* For every (arch × shape) cell of ``configs.cells()`` on both meshes
  (16×16 and 2×16×16): each parameter leaf's and each input leaf's
  (train batch, prefill arguments, decode token, caches or state and
  index) shape, dtype, ``PartitionSpec`` and one device's shard shape
  equal to the reference's ``ShardingRules``, ``launch.specs`` and
  ``NamedSharding.shard_shape``.
* Per-device argument bytes equal to the reference's
  ``compiled.memory_analysis().argument_size_in_bytes``, exactly, for a
  reduced train cell and a reduced decode cell of qwen2-0.5b and a
  reduced prefill cell of pixtral-12b on a (2, 4) mesh.
* FLOPs of a reduced dense train cell (remat none) within 5% of
  6·N·tokens plus the attention term 12·L·B·S²·H·hd (forward and
  backward of the score and value products, full S² as the counter
  counts them; measured: 0.2-0.3%).
* A record's keys, the CLI and the skip of a long_500k dense cell.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, ShapeSpec, cells
from repro_torch.launch import dryrun as D
from repro_torch.launch import specs as SPECS
from repro_torch.launch.mesh import DeviceMesh, make_production_mesh
from repro_torch.models import lm_module
from repro_torch.parallel.sharding import (NamedSharding, ShardingRules,
                                           flatten_with_path, path_str)

SRC = Path(__file__).resolve().parents[1] / "src"

_REF_HEAD = r'''
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
from jax.sharding import NamedSharding
from repro.parallel.sharding import ShardingRules, _key_str


def leaves(tree, shard):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    sh = jax.tree.leaves(shard, is_leaf=lambda x: isinstance(x,
                                                            NamedSharding))
    return {"/".join(_key_str(k) for k in p):
            [list(x.shape), str(x.dtype), str(s.spec),
             list(s.shard_shape(x.shape))] for (p, x), s in zip(flat, sh)}
'''

REF_SPECS = _REF_HEAD + r'''
from repro.configs import cells
from repro.launch import specs as SPECS
from repro.launch.dryrun import param_shapes
from repro.launch.mesh import make_production_mesh

out = {}
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    rules = ShardingRules(mesh)
    name = "multi" if multi else "single"
    out[name] = [list(mesh.devices.shape), list(mesh.axis_names)]
    for cfg, shape, skip in cells():
        if skip:
            continue
        key = f"{cfg.name}|params|{name}"
        if key not in out:
            ps = param_shapes(cfg)
            out[key] = leaves(ps, rules.tree_shardings(ps))
        if shape.kind == "train":
            b = SPECS.train_batch_specs(cfg, shape)
            s = SPECS.batch_shardings(b, rules, mesh)
        elif shape.kind == "prefill":
            b = SPECS.prefill_args(cfg, shape)
            s = tuple(NamedSharding(mesh, rules.batch_spec(a.shape[0],
                                                           a.ndim))
                      for a in b)
        else:
            b = SPECS.decode_args(cfg, shape)
            s = SPECS.decode_shardings(cfg, shape, rules, mesh)
        out[f"{cfg.name}|{shape.name}|{name}"] = leaves(b, s)
json.dump(out, sys.stdout)
'''

# (arch, kind, seq_len, global batch) of the reduced cells on a (2, 4) mesh
MEMORY_CELLS = (("qwen2-0.5b", "train", 64, 8),
                ("qwen2-0.5b", "decode", 128, 8),
                ("pixtral-12b", "prefill", 32, 8))

REF_MEMORY = _REF_HEAD + r'''
import numpy as np
from jax.sharding import Mesh
from repro.configs import ARCHS
from repro.configs.base import ShapeSpec
from repro.launch.dryrun import lower_cell

mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
out = {}
for arch, kind, seq, batch in json.loads(sys.argv[1]):
    rec = lower_cell(ARCHS[arch].reduced(), ShapeSpec("t", seq, batch, kind),
                     mesh, "2x4", remat="none")
    out[f"{arch}|{kind}"] = rec["memory"]["argument_size_in_bytes"]
json.dump(out, sys.stdout)
'''


def _reference(script: str, *args: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", script, *args], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout)


@pytest.fixture(scope="module")
def ref_specs() -> dict:
    return _reference(REF_SPECS)


def _port_leaves(tree, shardings) -> dict:
    return {path_str(path): [list(x.shape), str(x.dtype)[len("torch."):],
                             str(s.spec), list(s.shard_shape(tuple(x.shape)))]
            for path, (x, s) in D.local_leaves(tree, shardings).items()}


def _meshes():
    return {"single": make_production_mesh(),
            "multi": make_production_mesh(multi_pod=True)}


def test_production_meshes(ref_specs):
    for name, mesh in _meshes().items():
        shape, axes = ref_specs[name]
        assert list(mesh.devices.shape) == shape
        assert list(mesh.axis_names) == axes
        assert all(d == torch.device("meta") for d in mesh.devices.flat)


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
def test_every_cell_specs_and_shards_match_reference(ref_specs, mesh_name):
    mesh = _meshes()[mesh_name]
    rules = ShardingRules(mesh)
    checked = 0
    for cfg, shape, skip in cells():
        if skip:
            continue
        key = f"{cfg.name}|params|{mesh_name}"
        params = D.param_specs(cfg)
        assert _port_leaves(params, rules.tree_shardings(params)) \
            == ref_specs[key], key
        if shape.kind == "train":
            b = SPECS.train_batch_specs(cfg, shape)
            s = SPECS.batch_shardings(b, rules, mesh)
        elif shape.kind == "prefill":
            b = SPECS.prefill_args(cfg, shape)
            s = tuple(NamedSharding(mesh, rules.batch_spec(a.shape[0],
                                                           a.dim()))
                      for a in b)
        else:
            b = SPECS.decode_args(cfg, shape)
            s = SPECS.decode_shardings(cfg, shape, rules, mesh)
        key = f"{cfg.name}|{shape.name}|{mesh_name}"
        assert _port_leaves(b, s) == ref_specs[key], key
        assert all(x.device.type == "meta"
                   for _, x in flatten_with_path(b))
        checked += 1
    assert checked == sum(1 for c in cells() if not c[2])


def _mesh_2x4() -> DeviceMesh:
    grid = np.empty((2, 4), dtype=object)
    grid.fill(torch.device("meta"))
    return DeviceMesh(grid, ("data", "model"))


def test_argument_bytes_equal_reference_memory_analysis():
    want = _reference(REF_MEMORY, json.dumps(MEMORY_CELLS))
    mesh = _mesh_2x4()
    for arch, kind, seq, batch in MEMORY_CELLS:
        rec = D.plan_cell(ARCHS[arch].reduced(),
                          ShapeSpec("t", seq, batch, kind), mesh, "2x4",
                          remat="none")
        assert rec["status"] == "ok"
        assert rec["memory"]["argument_size_in_bytes"] \
            == want[f"{arch}|{kind}"], (arch, kind)
        assert rec["n_devices"] == 8 and rec["local_batch"] == batch // 2


@pytest.mark.parametrize("seq", [64, 256])
def test_train_flops_match_6nt_plus_attention(seq):
    cfg = ARCHS["qwen2-0.5b"].reduced()
    batch = 8
    rec = D.plan_cell(cfg, ShapeSpec("t", seq, batch, "train"), _mesh_2x4(),
                      "2x4", remat="none")
    # every weight that enters a product (the tied table once, unembedding)
    n = sum(int(np.prod(leaf.shape))
            for path, leaf in lm_module(cfg).flat_specs(cfg).items()
            if len(leaf.shape) >= 2 + path.startswith("layers/"))
    attention = 12 * cfg.n_layers * batch * seq * seq * cfg.n_heads * cfg.hd
    want = 6 * n * batch * seq + attention
    assert abs(rec["cost"]["flops"] - want) <= 0.05 * want


def test_record_keys_temp_bytes_and_cli(tmp_path, capsys):
    rec = D.plan_cell(ARCHS["pixtral-12b"].reduced(),
                      ShapeSpec("t", 32, 8, "train"), _mesh_2x4(), "2x4")
    assert rec["status"] == "ok" and rec["kind"] == "train"
    assert set(rec["memory"]) == {"argument_size_in_bytes",
                                  "temp_size_in_bytes", "temp_note"}
    assert "item 11" in rec["collectives_absent"]
    assert "collectives" not in rec
    # the step allocates at least its gradients and new float32 leaves
    n = sum(int(np.prod(leaf.shape)) for leaf in lm_module(
        ARCHS["pixtral-12b"].reduced()).flat_specs(
            ARCHS["pixtral-12b"].reduced()).values())
    assert rec["memory"]["temp_size_in_bytes"] >= 4 * n
    assert rec["fits_80gb"] is True and rec["cost"]["flops"] > 0
    # a long_500k dense cell is skipped, an ssm one planned (its decode
    # state does not grow with the context)
    rc = D.main(["--arch", "qwen2-0.5b", "--shape", "long_500k", "--mesh",
                 "single", "--out", str(tmp_path)])
    assert rc == 0
    skip = json.loads((tmp_path / "qwen2-0.5b__long_500k__single.json")
                      .read_text())
    assert skip["status"] == "skip" and "quadratic" in skip["reason"]
    rc = D.main(["--arch", "rwkv6-3b", "--shape", "long_500k", "--mesh",
                 "multi", "--out", str(tmp_path)])
    assert rc == 0
    rec = json.loads((tmp_path / "rwkv6-3b__long_500k__multi.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["n_devices"] == 512
    assert rec["fits_80gb"] is True
    assert "done: 1 ok, 0 fail, 0 skip" in capsys.readouterr().out


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
def test_placing_on_the_production_mesh_splits_into_meta_shards(mesh_name):
    """Placing the arguments of a train cell on the production mesh no
    longer raises: every split leaf gets one ``meta`` shard a position of
    its shard shape, and the first position's shards hold the dry run's
    argument bytes a device."""
    from repro_torch.parallel.sharding import ShardedTensor, place

    mesh = _meshes()[mesh_name]
    cfg = ARCHS["qwen2-0.5b"]
    shape = ShapeSpec("t", 4096, 256, "train")
    rules = ShardingRules(mesh)
    run, args = D._step(cfg, shape, remat="none", accum=1)
    shardings = D._arg_shardings(cfg, shape, rules, mesh, args)
    placed = place(args, shardings)
    n = int(mesh.devices.size)
    split = [x for _, x in flatten_with_path(placed)
             if isinstance(x, ShardedTensor)]
    assert len(split) >= 20
    for x in split:
        assert len(x.shards) == n
        assert all(s.device.type == "meta"
                   and tuple(s.shape) == x.sharding.shard_shape(x.shape)
                   for s in x.shards)
    got = sum(D._nbytes((x.shards[0] if isinstance(x, ShardedTensor)
                         else x).shape, x.dtype)
              for _, x in flatten_with_path(placed))
    assert D.local_bytes(args, shardings) == got


def test_train_temp_counts_one_model_position():
    """On a mesh whose ``model`` axis is m > 1 a train cell's temporaries
    are one position's: ``LiveBytes`` counts a tensor made from one
    position's blocks (and from what they made) for that position alone,
    and the reduced qwen2-0.5b cell's peak falls as m grows, by at least
    the share of its MLPs' saved activations that the other positions
    hold."""
    w0, w1 = (torch.empty(8, 10, device="meta") for _ in range(2))
    x = torch.empty(4, 8, device="meta")
    with D.LiveBytes([(w0, 0), (w1, 1)]) as live:
        w = torch.cat([w0, w1], 1)      # of both: every position's
        shared = x @ w                  # made from it: every position's
        a = x @ w0                      # position 0's
        a2 = a * 2                      # made from it: still 0's
        b = x @ w1[:, :5]               # a view of 1's block: 1's
    assert live.live == {None: 4 * (8 * 20 + 4 * 20), 0: 4 * 2 * 4 * 10,
                         1: 4 * 4 * 5}
    assert live.peak == 4 * (8 * 20 + 4 * 20 + 2 * 4 * 10)
    del w, shared, a, a2, b

    cfg = ARCHS["qwen2-0.5b"].reduced()
    batch, seq = 8, 64
    temps = []
    for m in (1, 2, 4):
        grid = np.empty((2, m), dtype=object)
        grid.fill(torch.device("meta"))
        rec = D.plan_cell(cfg, ShapeSpec("t", seq, batch, "train"),
                          DeviceMesh(grid, ("data", "model")), f"2x{m}",
                          remat="none")
        assert rec["status"] == "ok" and "one 'model' position" \
            in rec["memory"]["temp_note"]
        temps.append(rec["memory"]["temp_size_in_bytes"])
    assert temps[0] > temps[1] > temps[2]
    # a layer's SwiGLU keeps x @ w_gate, its activation, x @ w_up and
    # their product, (local batch, seq, d_ff) each, in bfloat16
    mlp = cfg.n_layers * 4 * (batch // 2) * seq * cfg.d_ff * 2
    assert temps[0] - temps[2] >= mlp * 3 // 4

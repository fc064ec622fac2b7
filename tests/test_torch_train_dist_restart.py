"""Checkpoints, the launcher and failures of the split training step with
one process a mesh position (ROADMAP Queue 1 item 12(f)), on the CPU with
``gloo`` (ranks from ``tests/torch_dist_ranks.py``).

``launch.train`` (qwen2 reduced, float32, batch 4 × 32, as
``tests/test_torch_train_sharded.py`` trains it) on the (2, 2) mesh of
four ranks:

* a checkpoint it writes (rank 0 writes, from the shards gathered to
  it) is byte for byte the one-process route's on ``DeviceMesh`` of
  repeated ``"cpu"``, and it resumes one-process onto (4, 1) and (1, 1)
  bitwise their ``accum`` steps from it;
* the one-process route's step-2 checkpoint, resumed by the ranks to
  step 4: the losses bitwise the uninterrupted run's and the step-4
  checkpoint byte for byte its;
* the reference's step-2 checkpoint from its (2, 2) mesh of faked CPU
  devices (automatic axes, as ``tests/test_torch_train_sharded.py``
  builds it), resumed by the ranks: the losses within that file's 3
  float32 steps of the reference's uninterrupted run and the step-4
  parameters within 1.4e-7;
* ``python -m torch.distributed.run --standalone --nproc-per-node 2 -m
  repro_torch.launch.train ... --model-parallel 2`` prints the
  one-process run's losses;
* a rank that raises mid-step ends every rank within the group's
  timeout.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_dist_ranks as R
from repro_torch.configs import ARCHS, ShapeSpec
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import DeviceMesh
from repro_torch.runtime import checkpoint as TCKPT
from repro_torch.train import optimizer as TO
from repro_torch.train.data import make_batch_fn
from repro_torch.train.step import init_params, make_train_step

torch.set_num_threads(1)   # as each rank: the products' rounding is kept

SRC = Path(__file__).resolve().parents[1] / "src"
ARCH = R.CKPT_ARCH
LOSS_ULPS = 3              # tests/test_torch_train_sharded.py's limits
PARAM_ATOL = 1.4e-7

REF = r'''
import os, sys, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
import json
jax.config.update("jax_threefry_partitionable", True)
from jax.sharding import AxisType
from repro.configs import ARCHS
from repro.launch import train as jtrain


def auto_local_mesh(model=1):
    # as tests/test_torch_train_sharded.py: GSPMD's automatic axes
    n = len(jax.devices())
    return jax.make_mesh((n // model, model), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


jtrain.make_local_mesh = auto_local_mesh
arch, work = sys.argv[1], sys.argv[2]
jtrain.ARCHS = dict(ARCHS, **{arch: dataclasses.replace(ARCHS[arch],
                                                        dtype="float32")})
full = jtrain.train(arch, steps=4, ckpt_dir=os.path.join(work, "ref"),
                    ckpt_every=2, model_parallel=2, **json.loads(sys.argv[3]))
json.dump(full["losses"], sys.stdout)
'''


def cpu_mesh(data: int, model: int) -> DeviceMesh:
    grid = np.empty((data, model), dtype=object)
    grid.fill(torch.device("cpu"))
    return DeviceMesh(grid, ("data", "model"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one-process (2, 2) run to step 4 (saved at 2 and 4), the
    reference's likewise in a subprocess, then one spawn of four ranks:
    (a) two steps saved at 2, (b) the one-process step 2 resumed to 4,
    (c) the reference's step 2 resumed to 4."""
    work = tmp_path_factory.mktemp("dist_restart")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttrain, "ARCHS", R.f32_archs())
        one = ttrain.train(ARCH, steps=4, ckpt_dir=str(work / "one"),
                           ckpt_every=2, mesh=cpu_mesh(2, 2), device="cpu",
                           **R.RUN)
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", REF, ARCH, str(work),
                          json.dumps(R.RUN)], env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    ref = [tuple(x) for x in json.loads(res.stdout.strip().splitlines()[-1])]
    for name, src in (("resume", "one"), ("ref_to_proc", "ref")):
        shutil.copytree(work / src / "step_2", work / name / "step_2")
    R.run("restarts", 4, work, model=2)
    got = [json.loads((work / f"restarts{r}.json").read_text())
           for r in range(4)]
    assert all(g == got[0] for g in got[1:])   # every rank's dict
    return work, one, ref, {k: [tuple(x) for x in v["losses"]]
                            for k, v in got[0].items()}


def _same_files(a: Path, b: Path) -> None:
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


def test_process_checkpoint_is_the_one_process_checkpoint(runs):
    work, one, _, got = runs
    assert got["proc"] == [x for x in one["losses"] if x[0] < 2]
    _same_files(work / "proc" / "step_2", work / "one" / "step_2")


@pytest.mark.parametrize("data,model,accum", [(4, 1, 4), (1, 1, 1)])
def test_process_checkpoint_resumes_one_process_on_other_meshes(
        runs, data, model, accum, tmp_path, monkeypatch):
    """The ranks' step 2 resumed one-process onto (4, 1) and (1, 1) to
    step 4, each bitwise the ``accum`` steps from the restored
    checkpoint on one device."""
    work = runs[0]
    monkeypatch.setattr(ttrain, "ARCHS", R.f32_archs())
    cfg = dataclasses.replace(ARCHS[ARCH], dtype="float32").reduced()
    shutil.copytree(work / "proc" / "step_2", tmp_path / "step_2")
    got = ttrain.train(ARCH, steps=4, ckpt_dir=str(tmp_path), ckpt_every=2,
                       mesh=cpu_mesh(data, model), device="cpu", **R.RUN)
    params = TO.tree_map(lambda p: p.float(), init_params(cfg, device="cpu"))
    opt = TO.init(params)
    like = {"params": params, "m": opt.m, "v": opt.v, "step": opt.step}
    state = TCKPT.restore(like, work / "proc", 2, device="cpu")
    p, o = state["params"], TO.AdamWState(state["step"], state["m"],
                                          state["v"])
    step = make_train_step(cfg, accum=accum, remat="none")
    batch_fn = make_batch_fn(cfg, ShapeSpec("custom", R.RUN["seq"],
                                            R.RUN["batch"], "train"),
                             seed=0, device="cpu")
    losses = []
    for s in (2, 3):
        p, o, m = step(p, o, batch_fn(s))
        losses.append((s, float(m["loss"])))
    assert got["losses"] == losses
    final = TCKPT.restore(like, tmp_path, 4, device="cpu")
    for name, want in (("params", p), ("m", o.m), ("v", o.v)):
        for a, b in zip(TO.leaves(final[name]), TO.leaves(want)):
            assert torch.equal(a, b), name


def test_one_process_checkpoint_resumes_on_processes_bitwise(runs):
    work, one, _, got = runs
    assert got["resume"] == [x for x in one["losses"] if x[0] >= 2]
    _same_files(work / "resume" / "step_4", work / "one" / "step_4")


def test_reference_checkpoint_resumes_on_processes(runs):
    work, _, ref, got = runs
    want = dict(ref)
    assert [s for s, _ in got["ref_to_proc"]] == [2, 3]
    for s, loss in got["ref_to_proc"]:
        ulps = abs(loss - want[s]) / float(np.spacing(np.float32(want[s])))
        assert ulps <= LOSS_ULPS, (s, loss, want[s])

    def params(d):
        man = json.loads((d / "step_4" / "manifest.json").read_text())
        like = {m["name"]: torch.zeros(m["shape"], dtype=torch.float32)
                for m in man["leaves"] if m["name"].startswith("params_")}
        return TCKPT.restore(like, d, 4, device="cpu")

    a, b = params(work / "ref_to_proc"), params(work / "ref")
    assert a.keys() == b.keys() and len(a) >= 8
    worst = max(float((a[k] - b[k]).abs().max()) for k in b)
    assert worst <= PARAM_ATOL, worst


def test_launcher_prints_the_one_process_losses():
    """Two ranks through ``torch.distributed.run`` (each takes half the
    host's CPU threads) against ``launch.train`` in this process with
    as many threads, on the (1, 2) mesh."""
    args = ["--arch", ARCH, "--reduced", "--device", "cpu",
            "--model-parallel", "2", "--steps", "2"]
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-m", "torch.distributed.run",
                          "--standalone", "--nproc-per-node", "2", "-m",
                          "repro_torch.launch.train", *args], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [line.split("(")[0].strip() for line in res.stdout.splitlines()
             if line.startswith("step")]
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // 2))
    try:
        one = ttrain.train(ARCH, reduced=True, steps=2, batch=8, seq=128,
                           log_every=10, device="cpu", mesh=cpu_mesh(1, 2))
    finally:
        torch.set_num_threads(threads)
    assert lines == [f"step {s:5d}  loss {loss:.4f}"
                     for s, loss in one["losses"]]
    assert res.stdout.strip().splitlines()[-1] == (
        f"loss {one['first_loss']:.4f} -> {one['final_loss']:.4f}")


def test_launcher_without_a_card_raises():
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-m", "torch.distributed.run",
                          "--standalone", "--nproc-per-node", "2", "-m",
                          "repro_torch.launch.train", "--arch", ARCH,
                          "--reduced", "--model-parallel", "2",
                          "--steps", "1"], env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode != 0
    assert "torch.cuda.is_available() is False" in res.stderr


def test_a_failing_rank_ends_every_rank(tmp_path):
    """Rank 1 raises inside its first layer's MLP on a (1, 2) mesh; rank
    0, waiting in a collective, fails too, by itself, within the group's
    timeout (no rank is killed by the deadline)."""
    t0 = time.monotonic()
    codes = R.spawn("fail", 2, tmp_path, model=2, timeout_s=30,
                    deadline_s=120)
    assert codes == {0: 1, 1: 1}, (codes, R.errors(tmp_path))
    assert time.monotonic() - t0 < 90
    assert "fails mid-step on purpose" in (tmp_path / "err1.txt").read_text()
    assert (tmp_path / "err0.txt").exists()

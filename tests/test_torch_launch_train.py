"""The port's training driver (``launch.train``), its checkpoints and its
placement on the host's mesh, on the CPU.

* Kill and restart (qwen2-0.5b, zamba2-1.2b and whisper-tiny, reduced):
  a run checkpointed at step 4 and resumed to step 6 equals the
  uninterrupted 6-step run BITWISE, every logged loss (the reference's
  ``tests/test_system.py::test_train_checkpoint_restart_exact`` holds its
  own to 1e-3), and ``test_training_reduces_loss`` rerun.
* Across the packages (reduced qwen2-0.5b and whisper-tiny, bfloat16
  activations): the reference's checkpoint of step 4 restored by the
  port (every leaf equal to the reference's own restore) and the port's
  training resumed from it; and the port's checkpoint of step 4 resumed
  by the reference's ``train``. Each resumed run's losses at steps 4 and
  5 within ``BF16_LOSS_REL`` of the other package's uninterrupted run,
  and its step-6 checkpoint's parameters within ``RESUMED_PARAM_ATOL``
  of that run's. ``BF16_LOSS_REL`` is half a bfloat16 step (2^-9 of the loss):
  both runs start step 4 from the same float32 parameters and draw the
  same batches, and differ only where the two frameworks round a
  bfloat16 activation at other places, which moves the float32 mean of
  the log-probabilities by far less than one rounding step of it
  (measured: at most 3.4e-5 relative). ``RESUMED_PARAM_ATOL`` is twice
  the sum of the two resumed steps' learning rates (1.5e-5, 1.8e-5), the
  most a gradient whose sign flips near zero can move a weight (as in
  ``tests/test_torch_train.py``; measured: at most 2.1e-5, where the two
  resumed steps move a weight by up to 3.7e-5).
* The codec's bfloat16 leaves: a reference checkpoint with bfloat16
  leaves restored by the port, and the port's restored by the
  reference's ``restore``, bit for bit, the payloads byte for byte.
* Placement: on the 1×1 CPU mesh every leaf moves whole to the mesh's
  device; a spec that splits a leaf over an axis of extent > 1 splits it
  into a ``ShardedTensor`` (held in ``tests/test_torch_train_sharded.py``);
  a model axis that does not divide the host's devices raises.
"""

import json
import shutil
import time

import jax
import numpy as np
import pytest
import torch

from repro.launch import train as jtrain
from repro.runtime import checkpoint as JCKPT
from repro_torch.configs import ARCHS
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import DeviceMesh, make_local_mesh
from repro_torch.models import lm
from repro_torch.parallel.sharding import NamedSharding, ShardingRules, place
from repro_torch.runtime import checkpoint as TCKPT
from repro_torch.runtime.elastic import apply_resize
from repro_torch.train import optimizer as TO
from repro_torch.train.step import init_params

jax.config.update("jax_threefry_partitionable", True)
torch.set_num_threads(1)   # small tensors: threads only contend

RUN = dict(reduced=True, batch=2, seq=32, log_every=1)
BF16_LOSS_REL = 2.0 ** -9
RESUMED_PARAM_ATOL = 2 * (1.5e-5 + 1.8e-5)


def _restart_exact(arch: str, tmp_path) -> None:
    r1 = ttrain.train(arch, steps=6, ckpt_dir=None, device="cpu", **RUN)
    ck = str(tmp_path / "ck")
    ttrain.train(arch, steps=4, ckpt_dir=ck, ckpt_every=4, device="cpu",
                 **RUN)
    assert TCKPT.latest_step(ck) == 4
    r2 = ttrain.train(arch, steps=6, ckpt_dir=ck, ckpt_every=100,
                      device="cpu", **RUN)
    assert r2["losses"] == r1["losses"][4:]
    assert r2["final_loss"] == r1["final_loss"]
    assert set(r1) == {"losses", "final_loss", "first_loss", "steps"}


def test_train_checkpoint_restart_exact(tmp_path):
    """Kill-and-restart equals the uninterrupted run, bit for bit."""
    _restart_exact("qwen2-0.5b", tmp_path)


def test_hybrid_train_checkpoint_restart_exact(tmp_path):
    """The same for the ``hybrid`` family (Zamba2: the SSD scan and the
    shared block under autograd)."""
    _restart_exact("zamba2-1.2b", tmp_path)


def test_audio_train_checkpoint_restart_exact(tmp_path):
    """The same for the ``audio`` family (whisper-tiny: the batches'
    frames, the encoder and the decoder's cross attention under
    autograd)."""
    _restart_exact("whisper-tiny", tmp_path)


def test_training_reduces_loss():
    r = ttrain.train("gemma-2b", reduced=True, steps=25, batch=4, seq=64,
                     log_every=24, device="cpu")
    assert r["final_loss"] < r["first_loss"]


def test_train_needs_cuda_unless_the_cpu_is_named():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.train("qwen2-0.5b", steps=1, **RUN)


def test_main_runs_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", [
        "train", "--arch", "qwen2-0.5b", "--reduced", "--device", "cpu",
        "--steps", "2", "--batch", "2", "--seq", "16"])
    ttrain.main()
    assert "loss" in capsys.readouterr().out.splitlines()[-1]


def _copy_step(src, dst, step: int, timeout_s: float = 60.0) -> None:
    """Copy a published step (``train`` joins only its last save, so an
    earlier one may still be landing: wait for its atomic rename)."""
    t0 = time.monotonic()
    while not (src / f"step_{step}" / "manifest.json").exists():
        assert time.monotonic() - t0 < timeout_s, f"step {step} not saved"
        time.sleep(0.05)
    dst.mkdir()
    shutil.copytree(src / f"step_{step}", dst / f"step_{step}")


def _checkpoint(directory, step: int):
    """A checkpoint's leaves as numpy arrays, by name."""
    d = directory / f"step_{step}"
    manifest = json.loads((d / "manifest.json").read_text())
    tree = {m["name"]: np.zeros(m["shape"], np.dtype(m["dtype"]))
            for m in manifest["leaves"]}
    return {k: np.asarray(v) for k, v in
            JCKPT.restore(tree, directory, step).items()}


def _compare_resumed(resumed_losses, full_losses, resumed_dir, full_dir):
    full = dict(full_losses)
    assert [s for s, _ in resumed_losses] == [4, 5]
    for s, loss in resumed_losses:
        assert abs(loss - full[s]) <= BF16_LOSS_REL * abs(full[s]), (s, loss)
    got, want = _checkpoint(resumed_dir, 6), _checkpoint(full_dir, 6)
    assert got.keys() == want.keys()
    assert int(got["step"]) == int(want["step"]) == 6
    for k in want:
        if k.startswith("params_"):
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=RESUMED_PARAM_ATOL, err_msg=k)


def _reference_resumes_in_port(arch: str, tmp_path) -> None:
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    full = jtrain.train(arch, steps=6, ckpt_dir=str(ref_dir),
                        ckpt_every=2, **RUN)
    _copy_step(ref_dir, port_dir, 4)
    # the port restores every leaf of the reference's checkpoint exactly
    cfg = ARCHS[arch].reduced()
    params = TO.tree_map(lambda p: p.float(),
                         init_params(cfg, device="cpu"))
    opt = TO.init(params)
    template = {"params": params, "m": opt.m, "v": opt.v, "step": opt.step}
    state = TCKPT.restore(template, port_dir, 4, device="cpu")
    want = _checkpoint(ref_dir, 4)
    flat = {"_".join(k.split("/")): v for k, v in lm.flatten(state).items()}
    assert flat.keys() == want.keys()
    for k, v in flat.items():
        assert v.dtype == {"step": torch.int32}.get(k, torch.float32)
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    resumed = ttrain.train(arch, steps=6, ckpt_dir=str(port_dir),
                           ckpt_every=2, device="cpu", **RUN)
    _compare_resumed(resumed["losses"], full["losses"], port_dir, ref_dir)


def _port_resumes_in_reference(arch: str, tmp_path) -> None:
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    full = ttrain.train(arch, steps=6, ckpt_dir=str(port_dir),
                        ckpt_every=2, device="cpu", **RUN)
    _copy_step(port_dir, ref_dir, 4)
    resumed = jtrain.train(arch, steps=6, ckpt_dir=str(ref_dir),
                           ckpt_every=2, **RUN)
    _compare_resumed(resumed["losses"], full["losses"], ref_dir, port_dir)


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    _reference_resumes_in_port("qwen2-0.5b", tmp_path)


def test_port_checkpoint_resumes_in_the_reference(tmp_path):
    _port_resumes_in_reference("qwen2-0.5b", tmp_path)


def test_audio_checkpoints_resume_across_the_packages(tmp_path):
    """whisper-tiny's checkpoints (``enc_*`` and ``dec_layers/xattn*``
    leaves) both ways."""
    _reference_resumes_in_port("whisper-tiny", tmp_path / "a")
    _port_resumes_in_reference("whisper-tiny", tmp_path / "b")


def _bf16_tree(seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 5)).astype(np.float32)
    return x, rng.standard_normal((7,)).astype(np.float32)


def test_bfloat16_leaves_round_trip_with_the_reference(tmp_path):
    import jax.numpy as jnp
    a, b = _bf16_tree(0)
    # the reference's checkpoint, restored by the port
    jtree = {"params": {"w": jnp.asarray(a, jnp.bfloat16),
                        "b": jnp.asarray(b)},
             "step": jnp.asarray(3, jnp.int32)}
    JCKPT.save(jtree, tmp_path / "ref", 3)
    ttree = {"params": {"w": torch.from_numpy(a).bfloat16(),
                        "b": torch.from_numpy(b)},
             "step": torch.tensor(3, dtype=torch.int32)}
    got = TCKPT.restore(ttree, tmp_path / "ref", 3, device="cpu")
    assert got["params"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["params"]["w"].view(torch.int16).numpy(),
        np.asarray(jtree["params"]["w"]).view(np.int16))
    np.testing.assert_array_equal(got["params"]["b"].numpy(), b)
    # the port's checkpoint, restored by the reference: equal bits and an
    # equal manifest and payloads
    TCKPT.save(ttree, tmp_path / "port", 3)
    back = JCKPT.restore(jtree, tmp_path / "port", 3)
    assert back["params"]["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(back["params"]["w"]).view(np.int16),
        ttree["params"]["w"].view(torch.int16).numpy())
    for side in ("ref", "port"):
        man = json.loads((tmp_path / side / "step_3" / "manifest.json")
                         .read_text())
        assert {m["name"]: m["dtype"] for m in man["leaves"]} == {
            "params_b": "float32", "params_w": "bfloat16",
            "step": "int32"}
    for name in ("params_b", "params_w", "step"):
        assert ((tmp_path / "ref" / "step_3" / f"{name}.bin").read_bytes()
                == (tmp_path / "port" / "step_3" / f"{name}.bin")
                .read_bytes())


def test_placement_on_the_one_device_cpu_mesh():
    mesh = make_local_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.device == torch.device("cpu")
    rules = ShardingRules(mesh)
    params = init_params(ARCHS["qwen2-0.5b"].reduced(), device="cpu")
    shardings = rules.tree_shardings(params)
    specs = rules.tree_specs(params)
    for path, sh in lm.flatten(shardings).items():
        assert isinstance(sh, NamedSharding) and sh.mesh is mesh
        assert sh.spec == lm.flatten(specs)[path]
    for placed in (place(params, shardings),
                   apply_resize(params, mesh, rules)):
        for path, x in lm.flatten(placed).items():
            assert x.device == torch.device("cpu")
            assert torch.equal(x, lm.flatten(params)[path])


def test_placement_splits_a_leaf_over_a_data_axis():
    """A data axis of 2 splits the leaves it divides (a gather gives each
    back bitwise) and moves the others whole; a model axis that does not
    divide the host's devices raises."""
    from repro_torch.parallel.sharding import ShardedTensor, gather_tree

    cpu = torch.device("cpu")
    grid = np.empty((2, 1), dtype=object)
    grid[:] = [[cpu], [cpu]]
    mesh = DeviceMesh(grid, ("data", "model"))
    rules = ShardingRules(mesh)
    params = init_params(ARCHS["qwen2-0.5b"].reduced(), device="cpu")
    placed = apply_resize(params, mesh, rules)
    split = {path for path, x in lm.flatten(placed).items()
             if isinstance(x, ShardedTensor)}
    assert split and "layers/mlp/w_up" in split
    for path, x in lm.flatten(gather_tree(placed)).items():
        assert torch.equal(x, lm.flatten(params)[path]), path
    # a leaf that no axis splits still moves whole
    scale = params["final_norm"]["scale"]
    assert rules.spec_for("final_norm/scale", tuple(scale.shape)) == (None,)
    assert torch.equal(apply_resize({"final_norm": {"scale": scale}}, mesh,
                                    rules)["final_norm"]["scale"], scale)
    with pytest.raises(ValueError, match="model=2"):
        make_local_mesh(model=2, device="cpu")
    with pytest.raises(ValueError, match="model=2"):
        ttrain.train("qwen2-0.5b", steps=1, model_parallel=2, device="cpu",
                     **RUN)

"""The port's VLM prefix (the ``vlm`` family, pixtral-12b) against the
reference, on the CPU.

Configuration: the reduced ``pixtral-12b`` (2 layers, d64, 4 query heads
over 2 KV heads of 16, vocabulary 256, 16 patches), float32. Parameters:
the reference's ``init_params`` tree with numpy noise on every leaf (its
init sets every norm scale to 1), carried across with
``convert.lm_params``; tokens and patch embeddings from numpy with a
seed.

* ``forward(prefix_embeds=)``: logits over the P + S rows within
  ``F32_REL`` of the reference's largest logit (measured: 4.4e-7), and
  ``use_flash`` on CPU tensors (the kernel's plain version) within the
  same of the plain route; ``last_only`` is the last row of the full
  logits, and ``loss_fn`` with the prefix within 1e-5 relative.
* The served route (``launch.serve.generate``: ``forward`` over the
  patches and the prompt, then decode over the empty cache) against the
  reference's ``vlm`` serve path (``repro/launch/serve.py``: the jitted
  prefill step, then the jitted decode step from ``init_kv_caches``):
  the prefill logits and the first decode logits within ``F32_REL``,
  the greedy tokens equal.
* The batches' ``patch_embeds``: bitwise the reference's in bfloat16
  and in float32 (``prng.normal``, as the audio frames).
* 3 ``make_train_step`` steps against the reference's jitted step:
  losses within 1.7e-7 relative, parameters within 1.4e-7 (the readings
  of the other families in ``tests/test_torch_train.py``; measured here:
  8.5e-8 and 6.0e-8).
* ``launch.train`` checkpointed at step 4 and resumed to step 6 equals
  the uninterrupted run bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.models import transformer as JT
from repro.serve.step import greedy_sample as jgreedy
from repro.serve.step import make_decode_step as jdecode_step
from repro.serve.step import make_prefill_step as jprefill_step
from repro.train import data as JD
from repro.train import optimizer as JO
from repro.train import step as JS
from repro_torch import convert
from repro_torch.configs import ARCHS
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import lm
from repro_torch.models import transformer as TT
from repro_torch.runtime import checkpoint as TCKPT
from repro_torch.train import data as TD
from repro_torch.train import optimizer as TO
from repro_torch.train import step as TS

jax.config.update("jax_threefry_partitionable", True)
torch.set_num_threads(1)   # small tensors: threads only contend

ARCH = "pixtral-12b"
F32_REL = 1e-5
B, S, P, GEN = 2, 12, 8, 6


def _cfgs(dtype: str = "float32"):
    return (dataclasses.replace(JARCHS[ARCH].reduced(), dtype=dtype),
            dataclasses.replace(ARCHS[ARCH].reduced(), dtype=dtype))


def _both_params(seed: int = 0):
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, JS.init_params(jax.random.PRNGKey(seed),
                                                   jcfg))
    tree = jax.tree.map(lambda a: (a + 0.02 * rng.standard_normal(a.shape))
                        .astype(np.float32), tree)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            convert.lm_params(tree, tcfg, dtype=torch.float32))


def _inputs(cfg, seed: int = 1, p: int = P):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    patches = rng.standard_normal((B, p, cfg.d_model)).astype(np.float32)
    return tokens, patches


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def test_forward_with_prefix_matches_reference():
    jcfg, tcfg, jp, tp = _both_params()
    tokens, patches = _inputs(tcfg)
    tt, tpatch = torch.from_numpy(tokens), torch.from_numpy(patches)
    want = np.asarray(JT.forward(jp, tokens, jcfg, prefix_embeds=patches))
    got = TT.forward(tp, tt, tcfg, prefix_embeds=tpatch)
    assert got.shape == want.shape == (B, P + S, TT.padded_vocab(tcfg))
    v = tcfg.vocab_size
    assert _rel(got[..., :v].numpy(), want[..., :v]) <= F32_REL
    flash = TT.forward(tp, tt, tcfg, prefix_embeds=tpatch, use_flash=True)
    assert _rel(flash[..., :v].numpy(), want[..., :v]) <= F32_REL
    last = TT.forward(tp, tt, tcfg, prefix_embeds=tpatch, last_only=True)
    assert last.shape == (B, 1, TT.padded_vocab(tcfg))
    assert _rel(last[..., :v].numpy(), got[:, -1:, :v].numpy()) <= F32_REL
    labels = np.roll(tokens, -1, axis=1)
    jl = float(JT.loss_fn(jp, tokens, labels, jcfg, prefix_embeds=patches,
                          remat="none"))
    tl = float(TT.loss_fn(tp, tt, torch.from_numpy(labels), tcfg,
                          prefix_embeds=tpatch, remat="none"))
    assert abs(tl - jl) <= 1e-5 * abs(jl)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_served_route_matches_reference(use_kernels):
    """The reference's vlm serve path, step by step: prefill through
    ``forward``, decode from an empty cache of S + gen positions."""
    jcfg, tcfg, jp, tp = _both_params()
    tokens, patches = _inputs(tcfg, seed=2)
    jprefill = jax.jit(jprefill_step(jcfg))
    jdecode = jax.jit(jdecode_step(jcfg))
    logits = jprefill(jp, tokens, patches)
    j_prefill_logits = np.asarray(logits)
    token = jgreedy(logits)
    caches = JT.init_kv_caches(jcfg, B, S + GEN)
    j_tokens, j_first = [], None
    for i in range(GEN):
        j_tokens.append(np.asarray(token))
        logits, caches = jdecode(jp, token, caches, jnp.int32(S + i))
        if i == 0:
            j_first = np.asarray(logits)
        token = jgreedy(logits)
    res = tserve.generate(tp, torch.from_numpy(tokens), tcfg, GEN,
                          use_kernels=use_kernels,
                          patches=torch.from_numpy(patches))
    v = tcfg.vocab_size
    assert _rel(res["prefill_logits"][..., :v].numpy(),
                j_prefill_logits[..., :v]) <= F32_REL
    assert _rel(res["decode_logits"][..., :v].numpy(),
                j_first[..., :v]) <= F32_REL
    np.testing.assert_array_equal(res["tokens"].numpy(),
                                  np.concatenate(j_tokens, axis=1))


def test_serve_draws_eight_patches_and_needs_them():
    res = tserve.serve(ARCH, batch=2, prompt_len=10, gen=3, device="cpu")
    cfg = res["cfg"]
    assert res["patches"].shape == (2, tserve.VLM_PATCHES, cfg.d_model)
    assert res["patches"].dtype == torch.bfloat16
    assert res["tokens"].shape == (2, 3)
    again = tserve.serve(ARCH, batch=2, prompt_len=10, gen=3, device="cpu")
    assert torch.equal(res["tokens"], again["tokens"])   # from the seed
    with pytest.raises(ValueError, match="patches"):
        tserve.generate(res["params"], res["prompts"], cfg, 2)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_patch_embeds_match_reference(dtype):
    jcfg, tcfg = _cfgs(dtype)
    for seed, step in ((0, 0), (3, 5)):
        jb = JD.make_batch_fn(jcfg, JShapeSpec("t", 16, 3, "train"),
                              seed=seed)(step)
        tb = TD.make_batch_fn(tcfg, ShapeSpec("t", 16, 3, "train"),
                              seed=seed, device="cpu")(step)
        assert set(tb) == set(jb) == {"tokens", "labels", "patch_embeds"}
        got, want = tb["patch_embeds"], jb["patch_embeds"]
        assert got.shape == want.shape == (3, tcfg.encoder.n_frames,
                                           tcfg.d_model)
        assert str(got.dtype).endswith(dtype)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
        if dtype == "bfloat16":
            np.testing.assert_array_equal(
                got.view(torch.int16).numpy(),
                np.asarray(want).view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                          np.asarray(want).view(np.uint32))


def test_train_steps_match_reference():
    jcfg, tcfg, jp, tp = _both_params()
    jb = JD.make_batch_fn(jcfg, JShapeSpec("t", 32, 4, "train"),
                          seed=0)(0)
    jb = dict(jb, patch_embeds=jnp.asarray(
        np.asarray(jb["patch_embeds"]), jnp.float32))
    tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    jstep = jax.jit(JS.make_train_step(jcfg, remat="none"))
    tstep = TS.make_train_step(tcfg, remat="none")
    jo, to = JO.init(jp), TO.init(tp)
    for _ in range(3):
        jp, jo, jm = jstep(jp, jo, jb)
        tp, to, tm = tstep(tp, to, tb)
        jl, tl = float(jm["loss"]), float(tm["loss"])
        assert abs(tl - jl) <= 1.7e-7 * abs(jl), (tl, jl)
    jflat = lm.flatten(jp)
    for path, x in lm.flatten(tp).items():
        np.testing.assert_allclose(x.numpy(), np.asarray(jflat[path]),
                                   rtol=0, atol=1.4e-7, err_msg=path)
    assert int(to.step) == int(jo.step) == 3


def test_train_checkpoint_restart_exact(tmp_path):
    """Kill-and-restart equals the uninterrupted run, bit for bit (the
    batches' patch embeddings and the prefix under autograd)."""
    run = dict(reduced=True, batch=2, seq=32, log_every=1, device="cpu")
    r1 = ttrain.train(ARCH, steps=6, ckpt_dir=None, **run)
    ck = str(tmp_path / "ck")
    ttrain.train(ARCH, steps=4, ckpt_dir=ck, ckpt_every=4, **run)
    assert TCKPT.latest_step(ck) == 4
    r2 = ttrain.train(ARCH, steps=6, ckpt_dir=ck, ckpt_every=100, **run)
    assert r2["losses"] == r1["losses"][4:]
    assert r2["final_loss"] == r1["final_loss"]

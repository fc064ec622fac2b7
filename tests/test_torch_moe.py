"""The port's MoE path against the reference, on the CPU: the plain
version of the grouped matmul (what ``kernels.moe_gmm.ops`` runs on CPU
tensors) against the reference's Pallas kernel in interpret mode at
aligned shapes and its ``grouped_matmul_ref`` at ragged ones, the grouped
FFN, and ``models.moe.apply_moe`` with its routing. (The CUDA kernel is
held against the plain version on the card by ``test_torch_cuda.py`` and
``chip_smoke.py``.)

Tolerances: float32 rtol 1e-5 / atol 1e-4, as the reference's own kernel
tests (the two sides sum in other orders); bfloat16 ``BF16_ATOL`` (one
rounding to bfloat16 of float32 values that differ in the last bits; the
inputs are scaled so outputs stay below 4, where a bfloat16 step is at
most 0.0156). Routing is exact: expert indices, the dispatch order, the
kept slots and their buffer rows.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs.base import MoECfg
from repro.kernels.moe_gmm.kernel import grouped_matmul as jgmm
from repro.kernels.moe_gmm.ops import grouped_ffn as jgrouped_ffn
from repro.kernels.moe_gmm.ref import grouped_matmul_ref as jgmm_ref
from repro.models import moe as jmoe
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs.base import MoECfg as TMoECfg
from repro_torch.kernels.moe_gmm import ops as tgmm
from repro_torch.models import moe as tmoe

jax.config.update("jax_threefry_partitionable", True)
torch.set_num_threads(1)   # small tensors: threads only contend

BF16_ATOL = 3e-2
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _pair(a, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


# aligned shapes (the reference kernel's tests) and ragged ones
@pytest.mark.parametrize("E,C,D,F,dtype", [
    (4, 128, 256, 512, "float32"), (2, 256, 512, 512, "float32"),
    (8, 128, 128, 1024, "float32"), (2, 128, 512, 512, "bfloat16"),
    (3, 37, 100, 130, "float32"), (2, 8, 176, 88, "float32"),
    (3, 37, 100, 130, "bfloat16"),
])
def test_plain_grouped_matmul_against_reference(E, C, D, F, dtype):
    rng = np.random.default_rng(E * C + F)
    x = rng.normal(size=(E, C, D)).astype(np.float32)
    w = rng.normal(size=(E, D, F)).astype(np.float32)
    if dtype == "bfloat16":
        x, w = 0.5 * x, w / np.sqrt(D)
    (jx, tx), (jw, tw) = _pair(x, dtype), _pair(w, dtype)
    before = dict(tgmm.KERNEL_LAUNCHES)
    got = _np(tgmm.grouped_matmul(tx, tw))
    assert tgmm.KERNEL_LAUNCHES == before   # CPU tensors: plain version
    aligned = C % 128 == 0 and D % 128 == 0 and F % 128 == 0
    want = _np(jgmm(jx, jw, block_c=128, block_f=min(F, 512),
                    block_d=min(D, 512), interpret=True) if aligned
               else jgmm_ref(jx, jw))
    tol = (dict(rtol=1e-5, atol=1e-4) if dtype == "float32"
           else dict(rtol=0, atol=BF16_ATOL))
    assert got.shape == (E, C, F)
    np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("mlp", ["swiglu", "geglu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_grouped_ffn_against_reference_kernel(mlp, dtype):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 128, 256)).astype(np.float32) * 0.1
    ws = [rng.normal(size=s).astype(np.float32) * 0.05
          for s in ((2, 256, 512), (2, 256, 512), (2, 512, 256))]
    jx, tx = _pair(x, dtype)
    jws, tws = zip(*(_pair(w, dtype) for w in ws))
    got = _np(tgmm.grouped_ffn(tx, *tws, mlp=mlp))
    want = _np(jgrouped_ffn(jx, *jws, mlp=mlp, force_interpret=True))
    atol = 1e-4 if dtype == "float32" else BF16_ATOL
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def _moe_cfgs(variant, dtype):
    cfg = dataclasses.replace(ARCHS["moonshot-v1-16b-a3b"].reduced(),
                              dtype=dtype)
    tcfg = dataclasses.replace(TARCHS["moonshot-v1-16b-a3b"].reduced(),
                               dtype=dtype)
    if variant == "wide":   # moonshot's 64 experts, top-6
        cfg = dataclasses.replace(cfg, moe=MoECfg(64, 6, 32))
        tcfg = dataclasses.replace(tcfg, moe=TMoECfg(64, 6, 32))
    return cfg, tcfg


def _moe_params(cfg, rng):
    """Router and x on a grid of 1/8: every router logit is an exact f32
    sum, so both sides round it to bfloat16 alike. Experts 1 and 2 share a
    router column, so their probabilities tie for every token (and other
    ties occur by chance in bfloat16); expert 0 is favoured so that it
    overflows its capacity and slots are dropped."""
    m, D = cfg.moe, cfg.d_model
    router = rng.integers(-8, 9, (D, m.n_experts)).astype(np.float32) / 8
    router[:, 0] += 0.25
    router[:, 2] = router[:, 1]
    return {"router": router,
            "w_gate": rng.normal(0, D ** -0.5, (m.n_experts, D,
                                                m.d_ff_expert)),
            "w_up": rng.normal(0, D ** -0.5, (m.n_experts, D,
                                              m.d_ff_expert)),
            "w_down": rng.normal(0, m.d_ff_expert ** -0.5,
                                 (m.n_experts, m.d_ff_expert, D))}


def _reference_routing(p, x, cfg):
    """The routing steps of the reference's ``apply_moe``
    (``models/moe.py:50-68``) on the same inputs."""
    m = cfg.moe
    xt = x.reshape(-1, x.shape[-1])
    logits = (xt @ p["router"].astype(x.dtype)).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, expert_idx = jax.lax.top_k(probs, m.top_k)
    C = jmoe.capacity(xt.shape[0], cfg)
    flat_e = expert_idx.reshape(-1)
    order = jnp.argsort(flat_e)
    se = flat_e[order]
    counts = jnp.bincount(se, length=m.n_experts)
    starts = jnp.concatenate([jnp.zeros((1,), counts.dtype),
                              jnp.cumsum(counts)[:-1]])
    pos_in_e = jnp.arange(flat_e.shape[0]) - starts[se]
    keep = pos_in_e < C
    dest = jnp.where(keep, se * C + pos_in_e, m.n_experts * C)
    return [np.asarray(a) for a in (expert_idx, order, keep, dest)]


@pytest.mark.parametrize("variant", ["reduced", "wide"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_moe_against_reference(variant, dtype):
    cfg, tcfg = _moe_cfgs(variant, dtype)
    rng = np.random.default_rng(11)
    p = {k: v.astype(np.float32) for k, v in _moe_params(cfg, rng).items()}
    B, S = 2, 24
    x = (rng.integers(-8, 9, (B, S, cfg.d_model)) / 8).astype(np.float32)
    jx, tx = _pair(x, dtype)
    tp = {k: torch.from_numpy(v).to(DTYPES[dtype][1]) for k, v in p.items()}

    # routing: indices, dispatch order, kept slots and rows exact
    want_idx, want_order, want_keep, want_dest = _reference_routing(
        p, jx, cfg)
    gates, idx = tmoe.route(tp, tx.reshape(B * S, -1), tcfg)
    C = tmoe.capacity(B * S, tcfg)
    order, keep, dest = tmoe.dispatch(idx, C, tcfg.moe.n_experts)
    tied = np.isin(want_idx, (1, 2)).sum(-1) == 1   # the tie decided it
    assert tied.any(), "no routing decided by a tie"
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(order.numpy(), want_order)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    np.testing.assert_array_equal(dest.numpy(), want_dest)
    assert not want_keep.all(), "no slot was dropped"
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-6)

    # the layer, plain FFN and kernel route (plain version on CPU tensors)
    want = _np(jmoe.apply_moe(p, jx, cfg))
    atol = 1e-5 if dtype == "float32" else BF16_ATOL
    for use_kernel in (False, True):
        got = _np(tmoe.apply_moe(tp, tx, tcfg, use_kernel=use_kernel))
        np.testing.assert_allclose(got, want, atol=atol, rtol=0)

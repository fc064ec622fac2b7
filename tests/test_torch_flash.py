"""The port's attention against the reference, on the CPU: the plain
version of the flash kernel (what ``kernels.flash_attention.ops`` runs on
CPU tensors) against the reference's Pallas kernel in interpret mode and
its ``attention_ref``, and ``models.layers``' attention for prefill and
decode. (The CUDA kernel is held against the plain version on the card by
``test_torch_cuda.py`` and ``chip_smoke.py``.)

Tolerances are those of the reference's own kernel tests
(``tests/test_kernels.py``): float32 ``F32_ATOL`` (the two sides sum in
other orders; measured worst case here about 1e-6), bfloat16
``BF16_ATOL`` (outputs are rounded to bfloat16 once, from float32 values
that differ in the last bits: one bfloat16 step is 0.0156 at |x| in
[2, 4)).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.kernels.flash_attention.kernel import flash_attention as jflash
from repro.kernels.flash_attention.ref import attention_ref as jattn_ref
from repro.models import layers as jlayers
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.kernels.flash_attention import ops as tflash
from repro_torch.models import layers as tlayers

jax.config.update("jax_threefry_partitionable", True)
torch.set_num_threads(1)   # small tensors: threads only contend

F32_ATOL = 2e-5
BF16_ATOL = 3e-2
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _qkv(shape, seed, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=shape).astype(np.float32) for _ in range(3)]
    jd, td = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jd) for a in arrs],
            [torch.from_numpy(a).to(td) for a in arrs])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# the reference's kernel-test shapes (test_kernels.py), then a ragged S, a
# window on a ragged S, and bfloat16
CASES = [
    (2, 256, 4, 64, True, 0, "float32"),
    (1, 128, 2, 128, True, 0, "float32"),
    (2, 256, 4, 64, False, 0, "float32"),
    (1, 256, 2, 64, True, 128, "float32"),
    (2, 200, 3, 64, True, 0, "float32"),
    (1, 200, 2, 32, True, 48, "float32"),
    (1, 128, 2, 64, True, 0, "bfloat16"),
    (2, 200, 2, 64, True, 64, "bfloat16"),
]


@pytest.mark.parametrize("B,S,H,hd,causal,window,dtype", CASES)
def test_plain_flash_against_reference_kernel_and_ref(B, S, H, hd, causal,
                                                      window, dtype):
    (jq, jk, jv), (tq, tk, tv) = _qkv((B, S, H, hd), B * S + hd, dtype)
    before = dict(tflash.KERNEL_LAUNCHES)
    got = _np(tflash.flash_attention(tq, tk, tv, causal=causal,
                                     window=window))
    assert tflash.KERNEL_LAUNCHES == before   # CPU tensors: plain version
    block = 128 if S % 128 == 0 else S        # the TPU kernel wants S % block
    want_kernel = _np(jflash(jq, jk, jv, causal=causal, window=window,
                             block_q=block, block_k=block, interpret=True))
    want_ref = _np(jattn_ref(jq, jk, jv, causal=causal, window=window))
    atol = F32_ATOL if dtype == "float32" else BF16_ATOL
    assert got.shape == (B, S, H, hd)
    np.testing.assert_allclose(got, want_kernel, atol=atol, rtol=0)
    np.testing.assert_allclose(got, want_ref, atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 24])
def test_sdpa_against_reference(dtype, window):
    (jq, jk, jv), (tq, tk, tv) = _qkv((2, 64, 2, 16), 5, dtype)
    atol = F32_ATOL if dtype == "float32" else BF16_ATOL
    np.testing.assert_allclose(
        _np(tlayers.sdpa(tq, tk, tv, causal=True, window=window)),
        _np(jlayers.sdpa(jq, jk, jv, causal=True, window=window)),
        atol=atol, rtol=0)


def _attn_params(cfg, rng):
    """Attention params of one layer, with nonzero QKV biases."""
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {"wq": rng.normal(0, D ** -0.5, (D, H, hd)),
         "wk": rng.normal(0, D ** -0.5, (D, KV, hd)),
         "wv": rng.normal(0, D ** -0.5, (D, KV, hd)),
         "wo": rng.normal(0, (H * hd) ** -0.5, (H, hd, D))}
    if cfg.qkv_bias:
        p.update(bq=rng.normal(0, 0.1, (H, hd)),
                 bk=rng.normal(0, 0.1, (KV, hd)),
                 bv=rng.normal(0, 0.1, (KV, hd)))
    return {k: v.astype(np.float32) for k, v in p.items()}


def _to_port(p, td):
    return {k: torch.from_numpy(v).to(td) for k, v in p.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,window", [("qwen2-0.5b", 0),
                                         ("moonshot-v1-16b-a3b", 0),
                                         ("gemma-2b", 0), ("qwen2-0.5b", 8)])
def test_layers_attention_prefill_and_decode(arch, window, dtype):
    """Prefill (plain sdpa and the flash route) and three decode steps
    over a cache written in place, against the reference's ``attention``.
    The reduced qwen2 has GQA and QKV biases, moonshot as many KV heads as
    heads, gemma one KV head; a sliding window of 8 is set on qwen2."""
    jd, td = DTYPES[dtype]
    cfg = dataclasses.replace(ARCHS[arch].reduced(), dtype=dtype,
                              sliding_window=window)
    tcfg = dataclasses.replace(TARCHS[arch].reduced(), dtype=dtype,
                               sliding_window=window)
    rng = np.random.default_rng(3)
    p = _attn_params(cfg, rng)
    B, S, smax = 2, 12, 16
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)
    tp = _to_port(p, td)
    atol = F32_ATOL if dtype == "float32" else BF16_ATOL

    want, jkv = jlayers.attention(p, jx, cfg, causal=True)
    for use_flash in (False, True):
        got, tkv = tlayers.attention(tp, tx, tcfg, causal=True,
                                     use_flash=use_flash)
        np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)
        np.testing.assert_allclose(_np(tkv["k"]), _np(jkv["k"]), atol=atol,
                                   rtol=0)

    jcache = {"k": jnp.zeros((B, smax, cfg.n_kv_heads, cfg.hd), jd),
              "v": jnp.zeros((B, smax, cfg.n_kv_heads, cfg.hd), jd)}
    jcache = {n: jax.lax.dynamic_update_slice_in_dim(jcache[n], jkv[n], 0,
                                                     axis=1)
              for n in jcache}
    tcache = {n: torch.zeros((B, smax, cfg.n_kv_heads, cfg.hd), dtype=td)
              for n in ("k", "v")}
    for n in tcache:
        tcache[n][:, :S] = torch.tensor(_np(jkv[n])).to(td)
    for t in range(S, S + 3):
        xt = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
        pos = np.full((1, 1), t, np.int32)
        want, jcache = jlayers.attention(
            p, jnp.asarray(xt).astype(jd), cfg, causal=True,
            positions=jnp.asarray(pos), kv_cache=jcache,
            cache_index=jnp.int32(t))
        got, out_cache = tlayers.attention(
            tp, torch.from_numpy(xt).to(td), tcfg, causal=True,
            positions=torch.from_numpy(pos), kv_cache=tcache, cache_index=t)
        assert out_cache["k"] is tcache["k"]          # written in place
        np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)
        np.testing.assert_allclose(_np(tcache["k"]), _np(jcache["k"]),
                                   atol=atol, rtol=0)
        np.testing.assert_allclose(_np(tcache["v"]), _np(jcache["v"]),
                                   atol=atol, rtol=0)

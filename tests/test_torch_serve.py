"""The port's serving slice as a whole against the reference, on the CPU.

For the reduced ``qwen2-0.5b`` (dense) and ``moonshot-v1-16b-a3b`` (MoE),
the reference's ``init_params`` tree, perturbed with numpy noise so that
QKV biases and norm scales are not trivially 0 and 1, is carried across
with ``convert.lm_params``. The port's ``launch.serve.generate`` (through
the kernel route, which runs the kernels' plain versions on CPU tensors)
is compared with the reference's prefill → cache fill → ``decode_step``
loop of ``repro/launch/serve.py:147-159``, run here:

* float32: greedy tokens exactly equal; logits within ``F32_ATOL``
  (summation order; measured worst case about 5e-7 at logits of about
  0.6);
* bfloat16: logits within ``BF16_ATOL`` (the two frameworks round
  intermediates to bfloat16 at other places; measured worst case 0.007,
  about one bfloat16 step at the logits' scale of 0.6, after two layers).

Also: the port's config registry equals the reference's field by field,
the port's decode equals its own teacher-forced forward (as
``tests/test_decode_consistency.py`` holds the reference), and the
converter refuses a tree that does not fit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.models import transformer as JT
from repro.serve.step import greedy_sample as jgreedy
from repro.train.step import init_params
from repro_torch import convert
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.kernels.flash_attention import ops as tflash
from repro_torch.kernels.moe_gmm import ops as tgmm
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT
from repro_torch.serve import step as tstep

jax.config.update("jax_threefry_partitionable", True)
torch.set_num_threads(1)   # small tensors: threads only contend

F32_ATOL = 2e-5
BF16_ATOL = 3e-2
SERVED = ("qwen2-0.5b", "moonshot-v1-16b-a3b")


def test_config_registry_matches_reference():
    assert sorted(TARCHS) == sorted(ARCHS)
    for name, cfg in ARCHS.items():
        for c, t in ((cfg, TARCHS[name]), (cfg.reduced(),
                                            TARCHS[name].reduced())):
            assert dataclasses.asdict(t) == dataclasses.asdict(c), name
            assert (t.hd, t.subquadratic) == (c.hd, c.subquadratic), name


def _cfgs(arch, dtype):
    return (dataclasses.replace(ARCHS[arch].reduced(), dtype=dtype),
            dataclasses.replace(TARCHS[arch].reduced(), dtype=dtype))


def _perturbed_params(cfg, rng):
    """The reference's params with N(0, 0.1) noise on every norm scale and
    bias (otherwise 1 and 0)."""
    def f(path, x):
        x = np.asarray(x, np.float32)
        names = [getattr(k, "key", "") for k in path]
        if names[-1] in ("scale", "bias", "bq", "bk", "bv", "b_up",
                         "b_down"):
            x = x + rng.normal(0, 0.1, x.shape).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(
        f, init_params(jax.random.PRNGKey(0), cfg))


def _reference_generate(params, prompts, cfg, gen):
    """``repro/launch/serve.py:147-159``: prefill, cache fill, greedy
    decode; returns (tokens, prefill logits, first decode logits)."""
    B, S = prompts.shape
    logits, pf = JT.prefill(params, jnp.asarray(prompts), cfg)
    caches = JT.init_kv_caches(cfg, B, S + gen)
    caches = jax.tree.map(
        lambda c, p: jax.lax.dynamic_update_slice_in_dim(
            c, p.astype(c.dtype), 0, axis=2), caches, pf)
    pf_logits, first = np.asarray(logits, np.float32), None
    token, out = jgreedy(logits), []
    for i in range(gen):
        out.append(token)
        logits, caches = JT.decode_step(params, token, caches,
                                        jnp.int32(S + i), cfg)
        if i == 0:
            first = np.asarray(logits, np.float32)
        token = jgreedy(logits)
    return np.asarray(jnp.concatenate(out, axis=1)), pf_logits, first


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", SERVED)
def test_generate_matches_reference_serve_loop(arch, dtype):
    cfg, tcfg = _cfgs(arch, dtype)
    rng = np.random.default_rng(1)
    tree = _perturbed_params(cfg, rng)
    B, S, G = 2, 16, 8
    prompts = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    want_tok, want_pf, want_dec = _reference_generate(tree, prompts, cfg, G)

    params = convert.lm_params(tree, tcfg, "cpu")
    before = (dict(tflash.KERNEL_LAUNCHES), dict(tgmm.KERNEL_LAUNCHES))
    res = tserve.generate(params, torch.from_numpy(prompts).long(), tcfg, G,
                          use_kernels=True)
    assert (tflash.KERNEL_LAUNCHES, tgmm.KERNEL_LAUNCHES) == before
    v = cfg.vocab_size
    got_pf = res["prefill_logits"].float().numpy()
    got_dec = res["decode_logits"].float().numpy()
    assert res["tokens"].shape == (B, G)
    assert got_pf.shape == want_pf.shape == (B, 1, TT.padded_vocab(tcfg))
    atol = F32_ATOL if dtype == "float32" else BF16_ATOL
    np.testing.assert_allclose(got_pf[..., :v], want_pf[..., :v], atol=atol,
                               rtol=0)
    np.testing.assert_allclose(got_dec[..., :v], want_dec[..., :v],
                               atol=atol, rtol=0)
    if dtype == "float32":
        np.testing.assert_array_equal(res["tokens"].numpy(), want_tok)


def test_lm_params_dtypes_and_refusals():
    cfg, tcfg = _cfgs("qwen2-0.5b", "bfloat16")
    tree = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0), cfg))
    params = convert.lm_params(tree, tcfg, "cpu")
    lay = params["layers"]
    assert lay["attn"]["wq"].dtype == torch.bfloat16
    assert lay["attn"]["bq"].dtype == torch.bfloat16      # used as x.dtype
    assert lay["attn_norm"]["scale"].dtype == torch.float32
    assert params["embed"]["table"].shape == (TT.padded_vocab(tcfg),
                                              tcfg.d_model)
    assert torch.equal(lay["attn"]["wq"], torch.tensor(
        tree["layers"]["attn"]["wq"]).to(torch.bfloat16))
    extra = dict(tree, lm_head=np.zeros((64, 256), np.float32))
    with pytest.raises(ValueError, match="left over.*lm_head"):
        convert.lm_params(extra, tcfg, "cpu")
    missing = dict(tree, final_norm={})
    with pytest.raises(ValueError, match="missing.*final_norm/scale"):
        convert.lm_params(missing, tcfg, "cpu")
    bad = dict(tree, final_norm={"scale": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="shape"):
        convert.lm_params(bad, tcfg, "cpu")


@pytest.mark.parametrize("arch", SERVED)
def test_port_decode_matches_port_forward(arch):
    """The port's prefill + decode against its own teacher-forced forward,
    at the reference test's tolerance (bfloat16)."""
    tcfg = TARCHS[arch].reduced()
    params = TT.init_lm(tcfg, seed=0, device="cpu")
    B, S = 2, 16
    toks = torch.randint(0, tcfg.vocab_size, (B, S),
                         generator=torch.Generator().manual_seed(0))
    full = TT.forward(params, toks, tcfg).float()
    logits, pf = TT.prefill(params, toks[:, :S // 2], tcfg)
    torch.testing.assert_close(logits[:, 0].float(), full[:, S // 2 - 1],
                               atol=2e-2, rtol=0)
    caches = TT.init_kv_caches(tcfg, B, S, device="cpu")
    caches["k"][:, :, :S // 2] = pf["k"]
    caches["v"][:, :, :S // 2] = pf["v"]
    for t in range(S // 2, S):
        logits, caches = TT.decode_step(params, toks[:, t:t + 1], caches, t,
                                        tcfg)
        torch.testing.assert_close(logits[:, 0].float(), full[:, t],
                                   atol=2e-2, rtol=0)


def test_serve_on_cpu_and_unported_families():
    # rwkv6's 21-token prompt is a 16-token chunk and a 5-token tail;
    # zamba2's 40-token one two 16-token chunks and an 8-token tail
    for arch, prompt_len in (("moonshot-v1-16b-a3b", 8), ("rwkv6-3b", 21),
                             ("zamba2-1.2b", 40)):
        res = tserve.serve(arch, batch=2, prompt_len=prompt_len, gen=4,
                           device="cpu")
        assert res["tokens"].shape == (2, 4)
        assert res["tokens"].dtype == torch.int64
        assert int(res["tokens"].max()) < res["cfg"].vocab_size
        assert res["prefill_logits"].shape == (
            2, 1, TT.padded_vocab(res["cfg"]))
        assert res["prefill_logits"].dtype == torch.bfloat16
        again = tserve.serve(arch, batch=2, prompt_len=prompt_len, gen=4,
                             device="cpu")
        assert torch.equal(res["tokens"], again["tokens"])   # from the seed
    # the vlm family, the last unported one until its slice, now serves
    # (tests/test_torch_vlm.py holds it against the reference); an unknown
    # family is refused
    res = tserve.serve("pixtral-12b", batch=2, prompt_len=8, gen=4,
                       device="cpu")
    assert res["tokens"].shape == (2, 4)
    assert res["prefill_logits"].shape == (2, 1,
                                           TT.padded_vocab(res["cfg"]))
    cfg = dataclasses.replace(TARCHS["pixtral-12b"].reduced(),
                              family="unknown")
    with pytest.raises(ValueError, match="unknown"):
        tstep.make_prefill_step(cfg)
    with pytest.raises(ValueError, match="unknown"):
        tstep.make_decode_step(cfg)

"""The port's threefry PRNG against ``jax.random`` (CPU, small sizes).

split, fold_in, bits, uniform, normal and exponential are bitwise (normal
and exponential through XLA's float32 erfinv polynomial and log1p);
categorical picks the same index on every key.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import prng

jax.config.update("jax_threefry_partitionable", True)
torch.set_num_threads(1)   # small tensors: threads only contend

N_KEYS = 500


@pytest.fixture(scope="module")
def keys():
    seeds = np.random.default_rng(0).integers(0, 2 ** 31 - 1, N_KEYS)
    jk = jnp.stack([jax.random.PRNGKey(int(s)) for s in seeds])
    tk = torch.stack([prng.PRNGKey(int(s)) for s in seeds])
    np.testing.assert_array_equal(np.asarray(jk, np.int64), tk.numpy())
    return jk, tk


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a − b| in units of float32 spacing at the larger magnitude."""
    big = np.maximum(np.abs(a), np.abs(b)).astype(np.float32)
    return np.abs(a.astype(np.float64) - b) / np.spacing(big)


BITWISE = {
    "split": (lambda k: jax.random.split(k, 3),
              lambda k: prng.split(k, 3)),
    "bits": (lambda k: jax.random.bits(k, (4, 5)),
             lambda k: prng.bits(k, (4, 5))),
    "uniform": (lambda k: jax.random.uniform(k, (53,)),
                lambda k: prng.uniform(k, (53,))),
    "uniform_range": (
        lambda k: jax.random.uniform(k, (24,), minval=0.05, maxval=1.0),
        lambda k: prng.uniform(k, (24,), 0.05, 1.0)),
    "uniform_open": (
        lambda k: jax.random.uniform(k, (24,), minval=1e-6,
                                     maxval=1.0 - 1e-6),
        lambda k: prng.uniform(k, (24,), 1e-6, 1.0 - 1e-6)),
    "scalar_uniform": (lambda k: jax.random.uniform(k),
                       lambda k: prng.uniform(k)),
}


@pytest.mark.parametrize("name", sorted(BITWISE))
def test_bitwise_against_jax(keys, name):
    jk, tk = keys
    jfn, tfn = BITWISE[name]
    ref = np.asarray(jax.vmap(jfn)(jk))
    got = tfn(tk).numpy()
    if ref.dtype == np.uint32:
        ref = ref.astype(np.int64)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_fold_in_bitwise(keys):
    jk, tk = keys
    data = np.arange(N_KEYS, dtype=np.uint32) * np.uint32(7919) \
        + np.uint32(3_000_000_000)
    ref = jax.vmap(jax.random.fold_in)(jk, jnp.asarray(data))
    got = prng.fold_in(tk, torch.as_tensor(data.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref, np.int64))
    # python-int data on one key, as make_grid folds seeds in
    one = prng.fold_in(prng.PRNGKey(0), 100_003 * 5 + 1)
    np.testing.assert_array_equal(
        one.numpy(), np.asarray(jax.random.fold_in(
            jax.random.PRNGKey(0), 100_003 * 5 + 1), np.int64))


def test_categorical_matches_over_4000_keys():
    rng = np.random.default_rng(1)
    jk = jax.random.split(jax.random.PRNGKey(3), 4000)
    logits = rng.normal(size=(4000, 53)).astype(np.float32)
    logits[:5] = -np.log(53.0)   # all-equal rows: the draw alone decides
    ref = np.asarray(jax.vmap(jax.random.categorical)(jk, logits))
    got = prng.categorical(torch.as_tensor(np.asarray(jk, np.int64)),
                           torch.as_tensor(logits)).numpy()
    np.testing.assert_array_equal(got, ref)


# normal's erfinv is XLA's polynomial and exponential's log1p XLA's float32
# log1p (core.xla_f32.log1p), each multiply-add rounded once: both bitwise
# jax's (ULP bound 0; torch.erfinv, which erfinv_f32 replaced, read 75)
@pytest.mark.parametrize("name,bound", [("normal", 0), ("exponential", 0)])
def test_transcendental_samplers_within_ulps(keys, name, bound):
    jk, tk = keys
    ref = np.asarray(jax.vmap(
        lambda k: getattr(jax.random, name)(k, (64,)))(jk))
    got = getattr(prng, name)(tk, (64,)).numpy()
    assert _ulps(got, ref).max() <= bound
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("name", ["normal", "exponential"])
def test_samplers_bitwise_over_a_million_draws(name):
    """10^6 draws from one key, every one jax's bits (the grid's widths,
    durations and arrival gaps, the audio frames and the VLM patches are
    such draws)."""
    ref = np.asarray(getattr(jax.random, name)(jax.random.PRNGKey(3),
                                               (10 ** 6,)))
    got = getattr(prng, name)(prng.PRNGKey(3), (10 ** 6,)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_normal_affine_is_the_fused_program():
    """``loc + scale * normal`` inside one jitted program, as the grid's
    widths and durations draw it: XLA reassociates the two factors and
    fuses the add, and ``normal_affine`` gives its bits."""
    loc = np.array([[5.1], [8.25], [1.5]], np.float32)
    scale = np.array([[1.3], [0.7], [2.9]], np.float32)
    keys = jnp.stack([jax.random.PRNGKey(s) for s in (1, 2, 3)])
    ref = np.asarray(jax.jit(jax.vmap(
        lambda k, m, s: m + s * jax.random.normal(k, (4096,))))(
            keys, loc, scale))
    tk = torch.as_tensor(np.asarray(keys, np.int64))
    got = prng.normal_affine(tk, (4096,), torch.from_numpy(loc),
                             torch.from_numpy(scale)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


def _bf16_bits(x) -> np.ndarray:
    """The bit patterns of a bfloat16 jax array or torch tensor."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


@pytest.mark.parametrize("minval,maxval", [(0.0, 1.0), (0.05, 0.9),
                                           (-0.99609375, 1.0)])
def test_bfloat16_uniform_bitwise(keys, minval, maxval):
    """bfloat16's uniform: 8-bit words (the low byte of each 32-bit word),
    each step rounded to bfloat16, bit for bit."""
    jk, tk = keys
    ref = jax.vmap(lambda k: jax.random.uniform(
        k, (40,), jnp.bfloat16, minval, maxval))(jk)
    got = prng.uniform(tk, (40,), minval, maxval, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bf16_bits(got), _bf16_bits(ref))


def test_bfloat16_normal_bitwise_over_all_its_values():
    """bfloat16's normal takes one of 128 values (7 random bits); a draw
    that hits every one of them is bitwise jax's."""
    key = jax.random.PRNGKey(27)
    ref = _bf16_bits(jax.random.normal(key, (4096,), jnp.bfloat16))
    got = _bf16_bits(prng.normal(prng.PRNGKey(27), (4096,),
                                 dtype=torch.bfloat16))
    assert len(np.unique(ref)) == 128
    np.testing.assert_array_equal(got, ref)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        prng.normal(prng.PRNGKey(0), (3,), dtype=torch.float16)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_audio_frames_against_reference(dtype):
    """The ``audio`` batches (``train.data.make_batch_fn``): tokens and
    labels bitwise the reference's; frames, ``normal(fold_in(PRNGKey(seed
    ^ 7), step))`` in the activation type, bitwise in bfloat16 and in
    float32, at the reduced config and at
    whisper-tiny's published frame shape (1500 × 384, batch 1)."""
    import dataclasses

    from repro.configs import ARCHS as JARCHS
    from repro.configs.base import ShapeSpec as JShapeSpec
    from repro.train import data as JD
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.train import data as TD

    for reduced, b in ((True, 2), (False, 1)):
        jcfg, tcfg = (dataclasses.replace(
            a["whisper-tiny"].reduced() if reduced else a["whisper-tiny"],
            dtype=dtype) for a in (JARCHS, ARCHS))
        for seed, step in ((0, 0), (3, 5)):
            want = JD.make_batch_fn(jcfg, JShapeSpec("t", 16, b, "train"),
                                    seed=seed)(step)
            got = TD.make_batch_fn(tcfg, ShapeSpec("t", 16, b, "train"),
                                   seed=seed, device="cpu")(step)
            assert set(got) == {"tokens", "labels", "frames"}
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(want[k]))
            f = got["frames"]
            assert f.shape == (b, tcfg.encoder.n_frames, tcfg.d_model)
            if dtype == "bfloat16":
                assert f.dtype == torch.bfloat16
                np.testing.assert_array_equal(_bf16_bits(f),
                                              _bf16_bits(want["frames"]))
            else:
                assert f.dtype == torch.float32
                np.testing.assert_array_equal(
                    f.numpy().view(np.uint32),
                    np.asarray(want["frames"]).view(np.uint32))


def test_batched_keys_broadcast():
    """A (B, 2) key gives B independent streams, each the unbatched one."""
    k = prng.split(prng.PRNGKey(9), 4)
    batched = prng.uniform(k, (7,))
    for i in range(4):
        np.testing.assert_array_equal(batched[i].numpy(),
                                      prng.uniform(k[i], (7,)).numpy())


# ------------------------------------------------ the counter past 2**32
#
# jax hashes the 64-bit flat index i of a draw as the counter words
# (i >> 32, i & 0xffffffff). A draw past index 2**32 is checked without a
# 2**32-element array: jax's threefry primitive hashes explicit counters,
# and a PRNG implementation whose ``random_bits`` starts at an offset runs
# jax's own ``categorical`` over a block of rows of the larger draw.

M32 = 0xFFFFFFFF
BOUNDARY = 2 ** 32


def _jax_bits_at(kd, offset: int, n: int) -> np.ndarray:
    """jax's 32-bit draws (uint32) at flat indices offset .. offset + n - 1
    of the stream of key data ``kd`` (uint32 (2,)), from the threefry
    primitive."""
    from jax._src import prng as jprng
    idx = offset + np.arange(n, dtype=np.uint64)
    hi = jnp.asarray((idx >> np.uint64(32)).astype(np.uint32))
    lo = jnp.asarray((idx & np.uint64(M32)).astype(np.uint32))
    b1, b2 = jprng.threefry2x32_p.bind(kd[0], kd[1], hi, lo)
    return b1 ^ b2


def test_threefry_primitive_is_jax_bits_at_hi_zero(keys):
    """The primitive at counters (0, i) is ``jax.random.bits``: the oracle
    of the tests below."""
    jk, _ = keys
    for kd in np.asarray(jk)[:20]:
        want = np.asarray(jax.random.bits(jnp.asarray(kd), (37,)),
                          np.int64)
        got = np.asarray(_jax_bits_at(jnp.asarray(kd), 0, 37), np.int64)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("offset", [BOUNDARY, BOUNDARY + 12_345,
                                    7 * BOUNDARY + 3, 2 ** 40 + 999,
                                    2 ** 62 + 5])
def test_bits_past_2_32_against_jax(keys, offset):
    jk, tk = keys
    for kd, k in zip(np.asarray(jk)[:10], tk[:10]):
        got = prng.bits(k, (3, 11), offset=offset).reshape(-1).numpy()
        want = _jax_bits_at(jnp.asarray(kd), offset, 33)
        np.testing.assert_array_equal(got, np.asarray(want, np.int64))


def test_block_straddling_2_32_exactly(keys):
    """Indices 2**32 - 40 .. 2**32 + 39 in one block: the part below the
    boundary is the draw it always was (counter (0, i)), the part above
    takes the high word 1, and both are jax's."""
    jk, tk = keys
    off, n = BOUNDARY - 40, 80
    for kd, k in zip(np.asarray(jk)[:10], tk[:10]):
        got = prng.bits(k, (n,), offset=off).numpy()
        want = _jax_bits_at(jnp.asarray(kd), off, n)
        np.testing.assert_array_equal(got, np.asarray(want, np.int64))
        lo = torch.arange(off, BOUNDARY, dtype=torch.int64)
        b1, b2 = prng.threefry2x32(k[0], k[1], torch.zeros_like(lo), lo)
        np.testing.assert_array_equal(got[:40], (b1 ^ b2).numpy())
        assert not np.array_equal(got[40:], prng.bits(k, (40,)).numpy())


def _offset_impl(offset: int):
    """jax's threefry PRNG with ``random_bits`` starting at flat index
    ``offset``: jax's samplers on it draw a block of a larger draw."""
    from jax._src import prng as jprng
    base = jprng.threefry_prng_impl

    def random_bits(key, bit_width, shape):
        assert bit_width == 32
        return _jax_bits_at(key, offset, int(np.prod(shape))).reshape(shape)
    return jprng.PRNGImpl(base.key_shape, base.seed, base.split,
                          random_bits, base.fold_in, name="threefry_at",
                          tag="tfa")


@pytest.mark.parametrize("vocab,row", [(32_000, BOUNDARY // 32_000 - 2),
                                       (151_936, BOUNDARY // 151_936),
                                       (53, 3 * BOUNDARY // 53 + 1)])
def test_categorical_rows_past_2_32_against_jax(vocab, row):
    """Rows of ``categorical(shape=)`` at ``offset = row · V`` past (or
    straddling) flat index 2**32: jax's ``categorical`` on the stream that
    starts there picks the same index in every row."""
    rows = 6
    assert (row + rows) * vocab > BOUNDARY
    kd = jax.random.key_data(jax.random.PRNGKey(11))
    logits = np.random.default_rng(vocab).normal(size=vocab).astype(
        np.float32)
    key = jax.random.wrap_key_data(kd, impl=_offset_impl(row * vocab))
    want = np.asarray(jax.random.categorical(key, jnp.asarray(logits),
                                             shape=(rows,)))
    got = prng.categorical_rows(prng.PRNGKey(11), torch.as_tensor(logits),
                                row, row + rows).numpy()
    np.testing.assert_array_equal(got, want)


def test_categorical_shape_is_its_row_blocks():
    """``categorical(shape=)`` is ``categorical_rows`` block by block."""
    key = prng.PRNGKey(4)
    logits = torch.as_tensor(np.random.default_rng(2).normal(size=300)
                             .astype(np.float32))
    whole = prng.categorical(key, logits, shape=(5, 9))
    parts = torch.cat([prng.categorical_rows(key, logits, 0, 17),
                       prng.categorical_rows(key, logits, 17, 45)])
    np.testing.assert_array_equal(whole.reshape(-1).numpy(), parts.numpy())


def test_bits_raises_at_the_int64_limit():
    key = prng.PRNGKey(0)
    top = prng.bits(key, (3,), offset=2 ** 63 - 3)   # last index 2**63 - 1
    assert top.shape == (3,)
    for offset, shape in ((2 ** 63 - 2, (3,)), (2 ** 63, (1,)), (-1, (2,))):
        with pytest.raises(NotImplementedError, match="2\\*\\*63"):
            prng.bits(key, shape, offset=offset)
    # the old limit is gone: a draw ending at and past 2**32
    assert prng.bits(key, (2,), offset=BOUNDARY - 1).shape == (2,)

"""``repro_torch.core.xla_f32`` against jax's float32 ``exp``, ``log``,
``log1p``, ``sum``, ``cumsum`` and ``logsumexp`` on the CPU: bit for bit, eager and under
``jax.jit``, on seeded draws over the ranges the estimator meets, on
random bit patterns and on the edge cases (subnormals, zeros, infinities,
NaN, the clamp ends of ``exp``, ``log1p``'s branch point sqrt(2) - 1
and its neighbours, values near -1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import xla_f32

torch.set_num_threads(1)

N = 200_000
TINY = np.finfo(np.float32).tiny

EDGES = np.array([
    0.0, -0.0, 1e-45, -1e-45, 1e-40, -1e-40, TINY, -TINY, 1.0, -1.0, 2.0,
    7.0, 47.0, 49.0, 53.0, 0.5, 0.70710677, 0.70710683, 1e-30,
    -87.8, -87.9, -87.33, -87.34, -87.35, -103.9, -126.0,
    88.72, 88.7228, 88.73, 88.8, 88.9, 3.4e38, -3.4e38,
    np.inf, -np.inf, np.nan], np.float32)


def _bits_equal(got: torch.Tensor, want) -> None:
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == np.float32 and want.dtype == np.float32
    both_nan = np.isnan(got) & np.isnan(want)
    bad = (got.view(np.uint32) != want.view(np.uint32)) & ~both_nan
    assert not bad.any(), (np.nonzero(bad)[0][:5], got[bad][:5],
                           want[bad][:5])


def _draws(name: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if name == "exp_estimator":      # exp(log_p − max): [-87, 1]
        return rng.uniform(-87.0, 1.0, N).astype(np.float32)
    if name == "exp_wide":           # past both clamp ends
        return rng.uniform(-110.0, 100.0, N).astype(np.float32)
    if name == "log_estimator":      # sums of exp, waits, bins
        return np.exp(rng.uniform(-10.0, 14.0, N)).astype(np.float32)
    if name == "log_wide":           # every positive normal exponent
        return np.exp2(rng.uniform(-126.0, 128.0, N)).astype(np.float32)
    # any 32-bit pattern
    return rng.integers(0, 2 ** 32, N, dtype=np.uint64).astype(
        np.uint32).view(np.float32)


@pytest.mark.parametrize("draws", ["exp_estimator", "exp_wide", "bits"])
@pytest.mark.parametrize("jit", [False, True])
def test_exp_bitwise(draws, jit):
    x = _draws(draws, 1)
    fn = jax.jit(jnp.exp) if jit else jnp.exp
    _bits_equal(xla_f32.exp(torch.from_numpy(x)), fn(x))
    _bits_equal(xla_f32.exp(torch.from_numpy(EDGES)), fn(EDGES))


@pytest.mark.parametrize("draws", ["log_estimator", "log_wide", "bits"])
@pytest.mark.parametrize("jit", [False, True])
def test_log_bitwise(draws, jit):
    x = _draws(draws, 2)
    fn = jax.jit(jnp.log) if jit else jnp.log
    _bits_equal(xla_f32.log(torch.from_numpy(x)), fn(x))
    _bits_equal(xla_f32.log(torch.from_numpy(EDGES)), fn(EDGES))


LOG1P_EDGES = np.concatenate([EDGES, np.array([
    -1.0, -1.0000001, -0.99999994, -0.9999999, -0.999, -0.5, 0.5,
    -2.0, 1e-20, -1e-20, 2.0 ** -63, -(2.0 ** -63), 2.0 ** -64, 3e-4,
    -3e-4], np.float32)])
# sqrt(2) - 1 in float32 and the 8 floats on each side of it, both signs
_BRANCH = np.float32(0.41421356237309504880).view(np.uint32)
LOG1P_EDGES = np.concatenate([LOG1P_EDGES] + [
    s * (np.arange(_BRANCH - 8, _BRANCH + 9, dtype=np.uint32)
         .view(np.float32)) for s in (np.float32(1), np.float32(-1))])


def _log1p_draws(name: str, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if name == "small":           # the rational branch, every exponent
        return (rng.choice([-1.0, 1.0], N) * np.exp2(
            rng.uniform(-130.0, np.log2(0.4142), N))).astype(np.float32)
    if name == "draws":           # -u, u uniform in [0, 1): exponential's
        return -rng.uniform(0.0, 1.0, N).astype(np.float32)
    if name == "near_minus_one":  # -x², the erf_inv argument at |x| ~ 1
        return -(1.0 - np.exp2(rng.uniform(-24.0, -1.0, N))).astype(
            np.float32)
    return _draws("bits", seed)


@pytest.mark.parametrize("draws", ["small", "draws", "near_minus_one",
                                   "bits"])
@pytest.mark.parametrize("jit", [False, True])
def test_log1p_bitwise(draws, jit):
    x = _log1p_draws(draws, 4)
    fn = jax.jit(jnp.log1p) if jit else jnp.log1p
    _bits_equal(xla_f32.log1p(torch.from_numpy(x)), fn(x))
    _bits_equal(xla_f32.log1p(torch.from_numpy(LOG1P_EDGES)),
                fn(LOG1P_EDGES))


@pytest.mark.parametrize("n", [1, 16, 17, 31, 32, 33, 100, 256, 257, 1024])
def test_cumsum_order_bitwise(n):
    """XLA's blocked order of a float32 prefix sum (blocks of 16), at the
    grid's arrival counts and around the block's edges."""
    rng = np.random.default_rng(n)
    x = (rng.exponential(size=(40, n))
         * rng.choice([1.0, 1e-3, 1e3], size=(40, n))).astype(np.float32)
    _bits_equal(xla_f32.cumsum(torch.from_numpy(x), 1),
                jax.jit(lambda v: jnp.cumsum(v, 1))(x))
    _bits_equal(xla_f32.cumsum(torch.from_numpy(x.T.copy()), 0),
                jax.jit(lambda v: jnp.cumsum(v, 0))(x.T.copy()))


def test_fma_rounds_once():
    """a·b + c with one rounding: equal to the exact rational value
    rounded to float32 (fractions), including near-ties of the float64
    sum, where rounding twice would go wrong."""
    from fractions import Fraction
    rng = np.random.default_rng(3)
    a = rng.uniform(-2, 2, 4000).astype(np.float32)
    b = rng.uniform(-2, 2, 4000).astype(np.float32)
    c = (rng.uniform(-1, 1, 4000) * 2.0 ** rng.integers(-40, 3, 4000)
         ).astype(np.float32)
    # a product on a float32 tie (1 + 2^-11 + 2^-24) plus an addend below
    # float64's precision: the float64 sum rounds onto the tie, and a
    # second rounding to even would go the wrong way
    a[:4] = [1 + 2 ** -12, -(1 + 2 ** -12), 1 + 2 ** -12, 1 + 2 ** -12]
    b[:4] = [1 + 2 ** -12, 1 + 2 ** -12, 1 + 2 ** -12, 1 + 2 ** -12]
    c[:4] = [2.0 ** -80, -(2.0 ** -80), -(2.0 ** -80), 2.0 ** -60]
    got = xla_f32.fma(torch.from_numpy(a), torch.from_numpy(b),
                      torch.from_numpy(c)).numpy()
    for i in range(len(a)):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) \
            + Fraction(float(c[i]))
        lo = np.float32(float(exact))          # within one float32 ulp
        cands = [lo, np.nextafter(lo, np.float32(np.inf)),
                 np.nextafter(lo, np.float32(-np.inf))]
        errs = [abs(Fraction(float(v)) - exact) for v in cands]
        best = min(errs)
        ties = [v for v, e in zip(cands, errs) if e == best]
        want = min(ties, key=lambda v: int(np.array(v).view(np.uint32)) & 1)
        assert got[i] == want, (i, a[i], b[i], c[i], got[i], want)


@pytest.mark.parametrize("n", [5, 32, 33, 53, 64, 100, 1025])
def test_sum_order_bitwise(n):
    """XLA's windowed order of a float32 row sum, at the estimator's 53
    and around the window's edges."""
    rng = np.random.default_rng(n)
    x = (rng.exponential(size=(300, n))
         * rng.choice([1.0, 1e-3, 1e3], size=(300, n))).astype(np.float32)
    _bits_equal(xla_f32.sum(torch.from_numpy(x), -1),
                jax.jit(lambda v: jnp.sum(v, -1))(x))
    _bits_equal(xla_f32.sum(torch.from_numpy(x[0]), 0), jnp.sum(x[0]))
    _bits_equal(xla_f32.sum(torch.from_numpy(x.T.copy()), 0, keepdim=True),
                jax.jit(lambda v: jnp.sum(v, 0, keepdims=True))(x.T.copy()))


def _log_p_rows(shape, seed: int) -> np.ndarray:
    """Estimator-like rows: exact ties, large gaps, a -inf lane."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape)
         * rng.choice([0.1, 3.0, 30.0], size=shape)).astype(np.float32)
    x[..., 3] = x[..., 5]
    x[..., 6] = -np.inf
    return x


@pytest.mark.parametrize("shape", [(53,), (4000, 53), (300, 7), (50, 200)])
@pytest.mark.parametrize("jit", [False, True])
def test_logsumexp_bitwise(shape, jit):
    x = _log_p_rows(shape, len(shape) + shape[-1])
    lse = lambda v: jax.nn.logsumexp(v, axis=-1)
    ren = lambda v: v - jax.nn.logsumexp(v, axis=-1, keepdims=True)
    if jit:
        lse, ren = jax.jit(lse), jax.jit(ren)
    t = torch.from_numpy(x)
    _bits_equal(xla_f32.logsumexp(t, -1), lse(x))
    _bits_equal(t - xla_f32.logsumexp(t, -1, keepdim=True), ren(x))
    # all -inf: the max is replaced by 0, as jax does
    ninf = np.full(shape, -np.inf, np.float32)
    _bits_equal(xla_f32.logsumexp(torch.from_numpy(ninf), -1), lse(ninf))

"""float32 ``exp``, ``log``, ``log1p``, ``sum`` and ``logsumexp`` with the
bits XLA's CPU backend gives (jax's ``jnp.exp``, ``jnp.log``,
``jnp.log1p``, ``jnp.sum`` and ``jax.nn.logsumexp`` on float32, eager and
under ``jit``).

The estimator (``core.asa``) keeps ``log_p`` through logsumexp
renormalisations, and its greedy reads are ``argmax log_p``: bins tied
exactly in the reference (equal cumulative loss) stay tied only if every
rounding is the reference's. So the port evaluates these four functions
as XLA does, with separate torch ops that give the same bits on the CPU
and on the card:

- ``exp`` is Cephes' ``expf``: the input clamped to [-87.8, 88.8],
  ``n = floor(x·log2(e) + 0.5)`` clamped to [-127, 127], the reduced
  argument in two steps of ln 2, a degree-5 polynomial and a scale by
  ``2^n`` (0 for n = -127);
- ``log`` is Cephes' ``logf``: the mantissa in [sqrt(1/2), sqrt(2)), a
  degree-8 polynomial in three interleaved Horner chains, the exponent's
  ln 2 added in two parts;
- ``log1p`` is Cephes' rational approximation below |x| = sqrt(2) - 1,
  ``x + fma(-0.5, x², (x·x²)·(P(x)/Q(x)))`` with P and Q of degree 6,
  and ``log`` of the float32 sum ``x + 1`` above (jax's ``exponential``
  and the ``erf_inv`` of its ``normal`` take it, ``core.prng``);
- every multiply-add of both is one rounding (XLA's CPU backend fuses
  them into FMAs), and subnormal inputs and outputs are flushed to zero
  (an input of ``exp`` needs no flush: a subnormal gives 1 either way);
- ``sum`` follows XLA's tree rewrite of a long reduction: a row longer
  than 32 is padded with zeros to a multiple of 32 (half the padding,
  rounded down, in front), each window of 32 is summed left to right,
  and the window sums are reduced the same way;
- ``cumsum`` follows XLA's rewrite of a cumulative reduce-window: a row
  longer than 16 is padded with zeros at its end to a multiple of 16,
  each block of 16 is summed left to right, the block totals are
  scanned the same way, and each block adds the scan of the blocks
  before it.

``fma`` is the one rounding of ``a·b + c``: the product is exact in
float64, the sum is rounded to odd there (53 bits, so the second
rounding to float32's 24 cannot meet a false tie) and then to float32.
Inside ``exp`` and ``log`` a multiply-add is one launch instead
(``_fma_f64``: the float64 sum rounded to nearest, then to float32), to
keep the estimator's launches down; ``log1p``'s multiply-adds are
``fma``'s. ``exp``, ``log`` and ``log1p`` as written here give jax's bits
(NaN for NaN) on every one of the 2^32 float32 inputs, checked
exhaustively against ``jax.jit(jnp.exp)``, ``jnp.log`` and ``jnp.log1p``
on the CPU (jax 0.9.0; ``scripts/xla_f32_exhaustive.py``). ``tests/test_torch_xla_f32.py``
holds them to jax on draws and edge cases.
"""

from __future__ import annotations

import numpy as np
import torch

F32_MIN_NORMAL = float(np.finfo(np.float32).tiny)   # 2^-126
WINDOW = 32
SCAN_BLOCK = 16

_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
          4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LN2_HI, _LN2_LO = 0.693359375, -2.12194440e-4   # Cephes' C1, -C2 (= q2, q1)
# every constant the polynomials read, kept in one float64 table a device
_TABLE = (1.44269504088896341, 0.5, -_LN2_HI, -_LN2_LO, -0.5, _LN2_HI) \
    + _EXP_P + _LOG_P
_LOG2E, _HALF, _NEG_LN2_HI, _NEG_LN2_LO, _NEG_HALF, _LN2_HI_I = range(6)
_EXP0 = 6
_LOG0 = _EXP0 + len(_EXP_P)


def _c(v: float, like: torch.Tensor) -> torch.Tensor:
    """The float32 constant ``v`` on ``like``'s device (a fill, no copy)."""
    return torch.full((), float(np.float32(v)), dtype=torch.float32,
                      device=like.device)


def fma(a: torch.Tensor | float, b: torch.Tensor | float,
        c: torch.Tensor | float) -> torch.Tensor:
    """float32 ``a·b + c`` rounded once. At least one argument is a
    tensor; numbers are float32 constants."""
    like = next(x for x in (a, b, c) if isinstance(x, torch.Tensor))

    def f64(x):
        x = x if isinstance(x, torch.Tensor) else _c(x, like)
        return x.to(torch.float64)

    p, c = f64(a) * f64(b), f64(c)       # the product is exact
    s = p + c
    bp = s - p                           # TwoSum: s + err == p + c exactly
    err = (p - (s - bp)) + (c - bp)
    bits = s.view(torch.int64)
    # round to odd: an inexact even s moves one ulp toward p + c
    step = torch.where((err > 0) == (s > 0), 1, -1)
    bits = torch.where(((bits & 1) == 0) & (err != 0), bits + step, bits)
    return bits.view(torch.float64).to(torch.float32)


# made once a device: a copy from host memory inside a step would
# synchronise the stream
_CONSTS: dict[torch.device, tuple[torch.Tensor, ...]] = {}


def _k(i: int, like: torch.Tensor) -> torch.Tensor:
    """Constant ``i`` of ``_TABLE`` as a float64 0-d tensor on ``like``'s
    device (a view of the device's table, made with it)."""
    views = _CONSTS.get(like.device)
    if views is None:
        views = torch.tensor([float(np.float32(v)) for v in _TABLE],
                             dtype=torch.float64,
                             device=like.device).unbind()
        _CONSTS[like.device] = views
    return views[i]


def _fma_f64(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
             ) -> torch.Tensor:
    """float32 ``a·b + c`` in one launch. One of the three is float64, so
    the launch runs in float64: the product of the float32 values is
    exact, the sum rounds there, then to float32."""
    out = torch.empty(torch.broadcast_shapes(a.shape, b.shape, c.shape),
                      dtype=torch.float32, device=a.device)
    return torch.addcmul(c, a, b, out=out)


def exp(x: torch.Tensor) -> torch.Tensor:
    """``jnp.exp`` on float32, bit for bit."""
    x = torch.clamp(x.to(torch.float32), -87.8, 88.8)
    n = torch.floor(_fma_f64(x, _k(_LOG2E, x), _k(_HALF, x)))
    n = torch.clamp_(n, -127.0, 127.0)
    r = _fma_f64(n, _k(_NEG_LN2_HI, x), x)
    r = _fma_f64(n, _k(_NEG_LN2_LO, x), r)
    y = _fma_f64(r, _k(_EXP0, x), _k(_EXP0 + 1, x))
    for i in range(_EXP0 + 2, _EXP0 + len(_EXP_P)):
        y = _fma_f64(y, r, _k(i, x))
    y = _fma_f64(y, (r * r).to(torch.float64), r) + 1.0
    pow2 = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    out = y * pow2                  # NaN stays NaN; 2^-127 scales to 0
    return torch.where(out < F32_MIN_NORMAL, 0.0, out)


def log(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log`` on float32, bit for bit (a subnormal is 0: -inf)."""
    x = x.to(torch.float32)
    bits = torch.clamp_min(x, F32_MIN_NORMAL).view(torch.int32)
    e = ((bits >> 23) - 126).to(torch.float32)
    m = ((bits & 0x807FFFFF) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    low = m < np.float32(0.707106781186547524)
    e = e - low.to(torch.float32)
    z = torch.where(low, m + m, m) - 1.0
    z2 = z * z
    z3 = (z2 * z).to(torch.float64)
    y = _fma_f64(z, _k(_LOG0, x), _k(_LOG0 + 1, x))
    y1 = _fma_f64(z, _k(_LOG0 + 3, x), _k(_LOG0 + 4, x))
    y2 = _fma_f64(z, _k(_LOG0 + 6, x), _k(_LOG0 + 7, x))
    y = _fma_f64(y, z, _k(_LOG0 + 2, x))
    y1 = _fma_f64(y1, z, _k(_LOG0 + 5, x))
    y2 = _fma_f64(y2, z, _k(_LOG0 + 8, x))
    y = _fma_f64(y, z3, y1)
    y = _fma_f64(y, z3, y2)
    y = _fma_f64(y, z3, e * np.float32(_LN2_LO))
    z = _fma_f64(z2, _k(_NEG_HALF, x), z) + y
    out = _fma_f64(e, _k(_LN2_HI_I, x), z)
    # 0 and subnormals give -inf, negatives NaN, +inf and NaN themselves
    special = torch.log(torch.where(x.abs() < F32_MIN_NORMAL, 0.0, x))
    return torch.where((x >= F32_MIN_NORMAL) & (x < torch.inf), out,
                       special)


# Cephes' log1p: P and Q highest degree first, x below sqrt(2) - 1
_LOG1P_P = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
            6.5787325942061044846969, 2.9911919328553073277375e1,
            6.0949667980987787057556e1, 5.7112963590585538103336e1,
            2.0039553499201281259648e1)
_LOG1P_Q = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
            2.2176239823732856465394e2, 3.0909872225312059774938e2,
            2.1642788614495947685003e2, 6.0118660497603843919306e1)
_LOG1P_SMALL = float(np.float32(0.41421356237309504880))


def _flush(x: torch.Tensor) -> torch.Tensor:
    """A subnormal float32 as a zero of its sign."""
    return torch.where(x.abs() < F32_MIN_NORMAL, x * 0.0, x)


def log1p(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log1p`` on float32, bit for bit (a subnormal is a zero of its
    sign)."""
    x = _flush(x.to(torch.float32))
    x2 = _flush(x * x)
    p = q = None
    for cp, cq in zip(_LOG1P_P, _LOG1P_Q):
        p = _c(cp, x) if p is None else fma(p, x, cp)
        q = _c(cq, x) if q is None else fma(q, x, cq)
    r = _flush(_flush(x * x2) * _flush(p / q))
    small = x + _flush(fma(-0.5, x2, r))
    large = log(x + 1.0)
    return torch.where(x.abs() < _LOG1P_SMALL, small, large)


def sum(x: torch.Tensor, dim: int = -1, keepdim: bool = False
        ) -> torch.Tensor:
    """``jnp.sum(x, dim)`` on float32 in XLA's CPU order."""
    x = x.to(torch.float32).movedim(dim, -1)
    while x.shape[-1] > WINDOW:
        n = x.shape[-1]
        nw = -(-n // WINDOW)
        lo = (nw * WINDOW - n) // 2
        x = torch.nn.functional.pad(x, (lo, nw * WINDOW - n - lo))
        x = _sum_in_order(x.unflatten(-1, (nw, WINDOW)))
    out = _sum_in_order(x)
    return out.unsqueeze(dim) if keepdim else out


def _sum_in_order(x: torch.Tensor) -> torch.Tensor:
    """Left to right over the last dim, from 0."""
    acc = torch.zeros(x.shape[:-1], dtype=torch.float32, device=x.device)
    for column in x.unbind(-1):
        acc.add_(column)
    return acc


def cumsum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jnp.cumsum(x, dim)`` on float32 in XLA's CPU order."""
    x = x.to(torch.float32).movedim(dim, -1)
    n = x.shape[-1]
    if n <= SCAN_BLOCK:
        return _cumsum_in_order(x).movedim(-1, dim)
    nb = -(-n // SCAN_BLOCK)
    blocks = _cumsum_in_order(torch.nn.functional.pad(
        x, (0, nb * SCAN_BLOCK - n)).unflatten(-1, (nb, SCAN_BLOCK)))
    before = torch.nn.functional.pad(cumsum(blocks[..., -1])[..., :-1],
                                     (1, 0))
    out = (blocks + before.unsqueeze(-1)).flatten(-2)[..., :n]
    return out.movedim(-1, dim)


def _cumsum_in_order(x: torch.Tensor) -> torch.Tensor:
    """Left to right over the last dim, each partial sum rounded to
    float32 (``torch.cumsum`` accumulates in float64 on the CPU and in
    another order on the card)."""
    acc, out = None, []
    for column in x.unbind(-1):
        acc = column if acc is None else acc + column
        out.append(acc)
    return torch.stack(out, -1)


def logsumexp(x: torch.Tensor, dim: int = -1, keepdim: bool = False
              ) -> torch.Tensor:
    """``jax.nn.logsumexp(x, dim)`` on float32, bit for bit."""
    amax = torch.amax(x, dim=dim, keepdim=True)
    amax = torch.where(torch.isfinite(amax), amax, torch.zeros_like(amax))
    s = sum(exp(x - amax), dim=dim, keepdim=True)
    out = log(s.abs()) + amax
    return out if keepdim else out.squeeze(dim)

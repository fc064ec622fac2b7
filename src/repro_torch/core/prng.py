"""Counter-based threefry2x32 PRNG with ``jax.random``'s stream.

The fleet engine's semantics rest on per-scenario keys that are split
call for call (Algorithm-1 draws at stage submissions, tuned updates at
stage starts), so the port carries the same explicit keys as the
reference and reproduces ``jax.random`` bit for bit under
``jax_threefry_partitionable=True`` (the default of jax 0.9.0):

* a key is a ``(..., 2)`` tensor of uint32 values, held as int64;
* ``split(key, n)[i]`` and ``fold_in(key, i)`` are both
  ``threefry2x32(key, (0, i))`` (the "fold-like" split);
* ``bits(key, shape)`` hashes the flat row-major index ``i`` of each
  element as the counter ``(i >> 32, i & 0xffffffff)`` and returns the
  XOR of the two output words.

``torch.Generator`` cannot stand in: its streams are neither splittable
per scenario nor equal to the reference's. The 32-bit arithmetic runs in
int64 masked to 32 bits, which every torch backend supports (torch's
uint32 support is partial). Leading key dimensions batch: a ``(B, 2)``
key gives ``(B, *shape)`` draws, one independent stream per row.

``uniform``, ``normal``, ``exponential`` and ``categorical`` are bitwise
equal to the reference for the same key, ``uniform`` and ``normal`` in
float32 and bfloat16: ``normal`` takes XLA's float32 ``erf_inv``
polynomial (``erfinv_f32``) and ``exponential`` XLA's float32 ``log1p``
(``core.xla_f32.log1p``), each multiply-add rounded once as XLA's CPU
backend rounds it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import xla_f32

M32 = 0xFFFFFFFF
_KS_PARITY = 0x1BD11BDA
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_F32_BITS = 0x3F800000  # bit pattern of float32 1.0


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) & M32) | (v >> (32 - r))


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 hash (20 rounds) on broadcastable int64 tensors
    holding uint32 values; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x0 = (x1 + ks[0]) & M32
    x1 = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def PRNGKey(seed: int, device: str | torch.device = "cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the key ``(seed >> 32, seed & M32)``."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & M32, seed & M32], dtype=torch.int64,
                        device=device)


def _hash_counters(key: torch.Tensor, idx: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """threefry2x32(key, (idx >> 32, idx & M32)) for non-negative int64
    indices ``idx``, with key ``(..., 2)`` broadcast against the trailing
    counter dims of ``idx``."""
    extra = idx.dim()
    k = key.reshape(key.shape[:-1] + (1,) * extra + (2,))
    return threefry2x32(k[..., 0], k[..., 1], idx >> 32, idx & M32)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``(..., 2)`` → ``(..., num, 2)``."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    b1, b2 = _hash_counters(key, i)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``; ``data`` is an int or an int tensor that
    broadcasts against the key's leading dims."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & M32
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([b1, b2], dim=-1)


def bits(key: torch.Tensor, shape: tuple[int, ...], offset: int = 0
         ) -> torch.Tensor:
    """``jax.random.bits`` (32-bit): uint32 values as int64, shape
    ``key.shape[:-1] + shape``. With ``offset``, the elements at flat
    indices ``offset ..`` of a larger draw from the same key (a block of
    rows of it). The flat index is 64-bit, as jax's; the port holds it
    in int64, so a draw may reach index 2**63 - 1."""
    shape = tuple(shape)
    n = math.prod(shape)
    if offset < 0 or offset + n > 2 ** 63:
        raise NotImplementedError(
            f"draws at flat indices {offset} .. {offset + n - 1}: the port's "
            f"counter is an int64 index, so it stops at 2**63 - 1 (jax's at "
            f"2**64 - 1)")
    idx = (torch.arange(n, dtype=torch.int64, device=key.device)
           + offset).reshape(shape)
    b1, b2 = _hash_counters(key, idx)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: tuple[int, ...] = (),
            minval: float = 0.0, maxval: float = 1.0, offset: int = 0,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.uniform`` in float32 or bfloat16, bit for bit.

    float32: 23 random mantissa bits under exponent 0 give [1, 2), then
    ``f·(hi − lo) + lo``. XLA contracts that multiply-add into one fused
    multiply-add, so it is evaluated here in float64 (the float32 product
    is exact there) and rounded once to float32. bfloat16: see
    ``_uniform_bf16``. ``offset`` as in ``bits``."""
    if dtype == torch.bfloat16:
        return _uniform_bf16(key, shape, minval, maxval, offset)
    if dtype != torch.float32:
        raise TypeError(f"uniform draws float32 or bfloat16, not {dtype}")
    b = bits(key, shape, offset)
    f = ((b >> 9) | _ONE_F32_BITS).to(torch.int32).view(torch.float32) - 1.0
    # fills, not copies from host memory, which would synchronise
    lo = torch.full((), minval, dtype=torch.float32, device=key.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=key.device)
    span = (hi - lo).double()
    u = (f.double() * span + lo.double()).float()
    return torch.maximum(lo, u)


_ONE_BF16_BITS = 0x3F80  # bit pattern of bfloat16 1.0


def _uniform_bf16(key: torch.Tensor, shape: tuple[int, ...], minval: float,
                  maxval: float, offset: int) -> torch.Tensor:
    """``jax.random.uniform`` in bfloat16. bfloat16 has 7 mantissa bits,
    fewer than 8, so jax draws 8-bit words: the low byte of each 32-bit
    word (``bits1 ^ bits2``), shifted right by one under bfloat16's
    exponent 0, gives f + 1 in [1, 2); then ``f·(hi − lo) + lo`` and the
    floor at ``lo``, each step rounded to bfloat16 (hi, lo themselves
    rounded to bfloat16 first)."""
    b = bits(key, shape, offset) & 0xFF
    one = torch.ones((), dtype=torch.bfloat16, device=key.device)
    f = ((b >> 1) | _ONE_BF16_BITS).to(torch.int16).view(torch.bfloat16) \
        - one
    lo = torch.full((), minval, dtype=torch.bfloat16, device=key.device)
    hi = torch.full((), maxval, dtype=torch.bfloat16, device=key.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


# XLA's float32 erf_inv: M. Giles' single-precision polynomials in
# w = -log((1 - x)(1 + x)), one for w < 5 (in w - 2.5) and one beyond (in
# sqrt(w) - 3)
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                  -0.00367342844, 0.00573950773, -0.0076224613,
                  0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """erfinv of a float32 tensor by XLA's algorithm, bit for bit
    ``jax.lax.erf_inv`` on every float32 input ``normal`` can give it
    (``torch.erfinv`` is up to 65 ULP away): ``w = -log1p(-x·x)`` by
    XLA's float32 ``log1p`` (``core.xla_f32.log1p``), the Horner steps
    fused multiply-adds as XLA contracts them (``xla_f32.fma``, one
    rounding), sqrt correctly rounded; the CPU and CUDA routes give the
    same bits."""
    w = -xla_f32.log1p(-(x * x))
    lt = w < 5.0
    z = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    c_lt = torch.tensor(_ERFINV_W_LT_5, dtype=torch.float32, device=x.device)
    c_ge = torch.tensor(_ERFINV_W_GE_5, dtype=torch.float32, device=x.device)
    p = torch.where(lt, c_lt[0], c_ge[0])
    for i in range(1, len(_ERFINV_W_LT_5)):
        p = xla_f32.fma(p, z, torch.where(lt, c_lt[i], c_ge[i]))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_NORMAL_LO_BF16 = -0.99609375   # nextafter(-1, 0) in bfloat16
_SQRT2 = float(np.float32(np.sqrt(2)))
_TINY = float(np.finfo(np.float32).tiny)


def normal(key: torch.Tensor, shape: tuple[int, ...] = (),
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.normal``: sqrt(2)·erfinv(u), u uniform on (-1, 1), in
    float32 or bfloat16. In bfloat16 u is bfloat16's uniform (128
    values), its erfinv is taken in float32 and rounded to bfloat16, and
    the product by sqrt(2) rounded to bfloat16 is rounded again: bitwise
    the reference's."""
    if dtype == torch.bfloat16:
        u = uniform(key, shape, _NORMAL_LO_BF16, 1.0, dtype=dtype)
        sqrt2 = torch.full((), _SQRT2, dtype=dtype, device=key.device)
        return sqrt2 * erfinv_f32(u.float()).to(dtype)
    if dtype != torch.float32:
        raise TypeError(f"normal draws float32 or bfloat16, not {dtype}")
    u = uniform(key, shape, _NORMAL_LO, 1.0)
    return _SQRT2 * erfinv_f32(u)


def normal_affine(key: torch.Tensor, shape: tuple[int, ...],
                  loc: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``loc + scale * jax.random.normal(key, shape)`` in float32 as XLA
    compiles it inside one jitted program: the two constant factors
    reassociated, ``(scale·sqrt(2))·erfinv(u)``, and the add fused into
    that product (one rounding). ``loc`` and ``scale`` broadcast against
    the draws."""
    u = uniform(key, shape, _NORMAL_LO, 1.0)
    return xla_f32.fma(scale * _SQRT2, erfinv_f32(u), loc)


def exponential(key: torch.Tensor, shape: tuple[int, ...] = ()
                ) -> torch.Tensor:
    """``jax.random.exponential``: -log1p(-u), by XLA's float32
    ``log1p``."""
    return -xla_f32.log1p(-uniform(key, shape))


def gumbel(key: torch.Tensor, shape: tuple[int, ...] = (), offset: int = 0
           ) -> torch.Tensor:
    """``jax.random.gumbel`` (the default low-range mode); ``offset`` as in
    ``bits``."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY, 1.0, offset)))


# elements of Gumbel noise drawn at once by ``categorical(shape=)``
_GUMBEL_BLOCK = 1 << 24


def categorical(key: torch.Tensor, logits: torch.Tensor,
                shape: tuple[int, ...] | None = None) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis (Gumbel-argmax; the
    first index wins a tie); returns int64 indices.

    Without ``shape``, ``key`` is ``(..., 2)`` with leading dims equal to
    ``logits.shape[:-1]``: one key a row. With ``shape``, ``key`` is one
    ``(2,)`` key and ``logits`` one ``(V,)`` row, and the draw is the
    reference's ``categorical(key, logits, shape=shape)``: one Gumbel array
    ``gumbel(key, shape + (V,))``, by flat index, made here a block of rows
    at a time (about 2**24 elements) so that the whole array is never held
    at once."""
    if shape is None:
        g = gumbel(key, (logits.shape[-1],))
        return torch.argmax(g + logits, dim=-1)
    shape = tuple(shape)
    n = math.prod(shape)
    rows = max(1, _GUMBEL_BLOCK // logits.shape[-1])
    out = torch.empty(n, dtype=torch.int64, device=logits.device)
    for r0 in range(0, n, rows):
        r1 = min(n, r0 + rows)
        out[r0:r1] = categorical_rows(key, logits, r0, r1)
    return out.reshape(shape)


def categorical_rows(key: torch.Tensor, logits: torch.Tensor, r0: int,
                     r1: int) -> torch.Tensor:
    """Rows ``r0 .. r1 - 1`` (by flat index) of ``categorical(key, logits,
    shape=)``: the Gumbel noise at flat indices ``r0 · V ..`` of the
    draw, added to the ``(V,)`` row ``logits``, argmax a row."""
    V = logits.shape[-1]
    g = gumbel(key, (r1 - r0, V), offset=r0 * V)
    return torch.argmax(g + logits, dim=-1)

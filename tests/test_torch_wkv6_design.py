"""The WKV6 kernel's two designs, without a card.

Which design runs is a pure function of type, head dim and chunk length
(``kernels.rwkv6_scan.ops.wkv6_design``): the tensor-core design ("mma")
for bfloat16 at K = 64 with any chunk of 1 to 128 steps, the CUDA-core
design ("simt") otherwise. On CPU tensors the wrapper runs the plain
version and counts no launch of either design.

``_mirror`` repeats the arithmetic of the "mma" design's output pass in
plain PyTorch (test-only; nothing on the main path uses it): sub-chunks
of 16 steps; the pair term against each earlier sub-chunk factored at
the sub-chunk's boundary B_i = cum_excl at its first step, r ⊙ exp(cum_excl
− B_i) times (k ⊙ exp(B_i − cum))ᵀ, both factors ≤ 1; the 16 × 16 diagonal
blocks in the pairwise form with the bonus on their diagonal; each
float32 operand of the tensor-core products split into two TF32 values
(big = tf32(x), small = tf32(x − big); three products, two for att · v,
since bfloat16 v is exact in TF32), with TF32 rounding emulated by a
mantissa mask. It is held against the plain chunked version within the
limits the card holds the kernel to, against the reference's Pallas
kernel in interpret mode, and at decays strong enough (w down to 1e-6,
chunk 128: cum falls far below -88) that the unfactored
exp(cum_excl)·exp(-cum) overflows. ``SPLIT_REL`` bounds the error of the operand splits before
the output is rounded to bfloat16: the output's rel_rms limit of 3e-4
allows about 1.6e-5 there (a relative error δ before one bfloat16
rounding shows as rel_rms ≈ sqrt(δ · 2^-7.5)), and one TF32 rounding of an
operand (2^-11) would not fit it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_scan.kernel import wkv6 as jkernel
from repro_torch.kernels.rwkv6_scan import ops, ref

jax.config.update("jax_threefry_partitionable", True)
torch.set_num_threads(1)   # small tensors: threads only contend

# the limits chip_smoke.py and tests/test_torch_cuda.py hold the kernel to
# against the plain version: (largest ||Δ|| / ||want|| over output rows,
# rms(Δ) / rms(want)), by the type of the output
WKV_REL = {torch.float32: (1e-5, 2e-6), torch.bfloat16: (8e-3, 3e-4)}
# the mirror's float32 output (before the bfloat16 rounding) against the
# plain version's on the same inputs: (worst row, rel_rms); the budget
# for rel_rms is about 1.6e-5
SPLIT_REL = (1e-4, 1.6e-5)
# the reference's kernel-test tolerances (tests/test_kernels.py)
OUT_ATOL = 2e-4
L = 16   # steps of a sub-chunk


@pytest.mark.parametrize("chunk", [1, 16, 96, 116, 128])
@pytest.mark.parametrize("K", [8, 16, 40, 64])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wkv6_design(dtype, K, chunk):
    want = "mma" if dtype == torch.bfloat16 and K == 64 else "simt"
    assert ops.wkv6_design(dtype, K, chunk) == want


def test_wkv6_design_refuses_longer_chunks():
    assert ops.wkv6_design(torch.bfloat16, 64, 129) == "simt"
    assert ops.wkv6_design(torch.bfloat16, 64, 0) == "simt"


def _inputs(shape, seed, *, w_lo=0.45, w_hi=0.95, state=True,
            dtype=torch.bfloat16):
    """r, k, v ~ N(0, 1) in ``dtype``; w = exp(-exp(z)), z uniform so that
    w spans (w_lo, w_hi); u ~ N(0, 0.5); state0 ~ N(0, 0.3) or None; all
    made with numpy from ``seed``."""
    B, S, H, K = shape
    rng = np.random.default_rng(seed)
    r, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
               .to(dtype) for _ in range(3))
    z = rng.uniform(np.log(-np.log(w_hi)), np.log(-np.log(w_lo)), shape)
    w = torch.from_numpy(np.exp(-np.exp(z)).astype(np.float32))
    u = torch.from_numpy((rng.standard_normal((H, K)) * 0.5)
                         .astype(np.float32))
    s0 = (torch.from_numpy((rng.standard_normal((B, H, K, K)) * 0.3)
                           .astype(np.float32)) if state else None)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("b,s,h,k,chunk", [
    (2, 256, 2, 64, 128), (1, 232, 3, 64, 116), (2, 40, 2, 40, 40),
    (1, 3, 2, 16, 1)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_tensors_launch_no_design(b, s, h, k, chunk, dtype):
    r, kk, v, w, u, s0 = _inputs((b, s, h, k), b + s + k, dtype=dtype)
    before = (dict(ops.KERNEL_LAUNCHES), dict(ops.DESIGN_LAUNCHES))
    got_o, got_s = ops.wkv6(r, kk, v, w, u, chunk=chunk, state0=s0)
    assert (ops.KERNEL_LAUNCHES, ops.DESIGN_LAUNCHES) == before
    want_o, want_s = ref.wkv_chunked_ref(r, kk, v, w, u, chunk=chunk,
                                         state0=s0)
    assert torch.equal(got_o, want_o) and torch.equal(got_s, want_s)
    assert got_o.dtype == dtype and got_o.shape == r.shape


# ------------------------------------------------------------ the mirror

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits, ties away from
    zero), as ``cvt.rna.tf32.f32``: add half of the dropped 13 bits to the
    magnitude, then clear them."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x: torch.Tensor):
    big = _tf32(x)
    return big, _tf32(x.float() - big)


def _mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the tensor cores take it with both float32 operands split:
    small·big + big·small + big·big, summed in float64 (the card sums in
    float32), returned in float32."""
    (ab, as_), (bb, bs) = _split(a), _split(b)
    d = lambda x, y: x.double() @ y.double()   # noqa: E731
    return (d(as_, bb) + d(ab, bs) + d(ab, bb)).float()


def _mm2(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """a @ v with a split and v exact in TF32 (bfloat16 values): two
    products."""
    ab, as_ = _split(a)
    return (as_.double() @ v.double() + ab.double() @ v.double()).float()


def _mirror(r, k, v, w, u, *, chunk: int, state0=None):
    """The "mma" design's arithmetic -> (out in r's type, out in float32
    before that rounding, final state). The state and the state before
    each chunk follow the plain version (the kernel's state pass is the
    CUDA-core design's arithmetic, bitwise)."""
    B, S, H, K = r.shape
    c = chunk
    n_sub = -(-c // L)
    rows = n_sub * L
    lw = torch.log(torch.clamp(w.float(), 1e-12, 1.0))
    state = (torch.zeros((B, H, K, K)) if state0 is None
             else state0.float().clone())
    outs = []
    for c0 in range(0, S, c):
        # (B, H, rows, K); rows past the chunk: r, k, v zero, log w zero
        def tile(a, fill=0.0):
            t = torch.full((B, rows, H, K), fill, dtype=torch.float32)
            t[:, :c] = a[:, c0:c0 + c].float()
            return t.permute(0, 2, 1, 3)
        rf, kf, vf, lwf = tile(r), tile(k), tile(v), tile(lw)
        cum = torch.cumsum(lwf, dim=2)
        X = cum - lwf                                  # cum_excl
        o = _mm3(rf * torch.exp(X), state)             # the readout
        mask = torch.tril(torch.ones(L, L, dtype=torch.bool), -1)
        eye = torch.eye(L, dtype=torch.bool)
        for i in range(n_sub):
            ti = slice(L * i, L * i + L)
            Bi = X[:, :, L * i:L * i + 1]              # (B, H, 1, K)
            rh = rf[:, :, ti] * torch.exp(X[:, :, ti] - Bi)
            atts = []
            for j in range(i):
                tj = slice(L * j, L * j + L)
                kd = kf[:, :, tj] * torch.exp(Bi - cum[:, :, tj])
                atts.append(_mm3(rh, kd.transpose(-1, -2)))
            dec = X[:, :, ti, None] - cum[:, :, None, ti]   # (B,H,t,s,K)
            pair = torch.einsum("bhtk,bhsk,bhtsk->bhts", rf[:, :, ti],
                                kf[:, :, ti],
                                torch.exp(torch.clamp(dec, max=0.0)))
            bonus = torch.einsum("bhtk,hk,bhtk->bht", rf[:, :, ti],
                                 u.float(), kf[:, :, ti])
            diag = torch.where(mask, pair, torch.zeros(()))
            diag = torch.where(eye, bonus[..., None], diag)
            atts.append(diag)
            o[:, :, ti] += _mm2(torch.cat(atts, dim=-1),
                                vf[:, :, :L * (i + 1)])
        outs.append(o[:, :, :c].permute(0, 2, 1, 3))
        # the state update, as the plain version (and the state pass)
        cum_c, k_c, v_c = cum[:, :, :c], kf[:, :, :c], vf[:, :, :c]
        cum_end = cum_c[:, :, -1:]
        state = (torch.exp(cum_end[:, :, 0])[..., None] * state
                 + torch.einsum("bhsk,bhsv->bhkv",
                                k_c * torch.exp(cum_end - cum_c), v_c))
    out32 = torch.cat(outs, dim=1)
    return out32.to(r.dtype), out32, state


def _rel_errs(got, want):
    d, w = got.float() - want.float(), want.float()
    row = d.norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)
    return (float(row.max()),
            float(d.pow(2).mean().sqrt() / w.pow(2).mean().sqrt()))


def _assert_within(errs, limits):
    assert errs[0] <= limits[0] and errs[1] <= limits[1], (errs, limits)


# rwkv6-3b's chunk (one and two chunks, a carried state), its ragged tail
# block, chunks that are not a multiple of 16, strong decay
MIRROR_CASES = [
    (1, 128, 3, 64, 128, (1e-4, 0.999), False),
    (2, 256, 2, 64, 128, (1e-4, 0.999), True),
    (1, 232, 2, 64, 116, (1e-4, 0.999), True),
    (2, 80, 2, 64, 40, (0.45, 0.95), True),
    (1, 21, 2, 64, 7, (0.45, 0.95), True),
    (2, 256, 2, 64, 128, (1e-6, 0.999), True),
]


@pytest.mark.parametrize("b,s,h,k,chunk,w_range,state", MIRROR_CASES)
def test_mirror_against_plain(b, s, h, k, chunk, w_range, state):
    """The mirror within the kernel's limits against the plain chunked
    version on bfloat16 inputs, and within ``SPLIT_REL`` before the
    output's rounding (the plain version in float32 on the same
    values)."""
    r, kk, v, w, u, s0 = _inputs((b, s, h, k), b + s + chunk,
                                 w_lo=w_range[0], w_hi=w_range[1],
                                 state=state)
    got, got32, got_s = _mirror(r, kk, v, w, u, chunk=chunk, state0=s0)
    want, want_s = ref.wkv_chunked_ref(r, kk, v, w, u, chunk=chunk,
                                       state0=s0)
    want32, _ = ref.wkv_chunked_ref(r.float(), kk.float(), v.float(), w, u,
                                    chunk=chunk, state0=s0)
    assert bool(torch.isfinite(got32).all() and torch.isfinite(got_s).all())
    _assert_within(_rel_errs(got, want), WKV_REL[torch.bfloat16])
    _assert_within(_rel_errs(got32, want32), SPLIT_REL)
    torch.testing.assert_close(got_s, want_s, rtol=0, atol=0)


@pytest.mark.parametrize("b,s,h,chunk", [(1, 256, 2, 64), (2, 128, 2, 128),
                                         (1, 96, 2, 32)])
def test_mirror_matches_reference_kernel(b, s, h, chunk):
    """The mirror against the reference's Pallas kernel in interpret mode
    (zero state), on float32 arrays that hold bfloat16 values (the
    tensor-core design's inputs), within the reference's kernel-test
    tolerance."""
    r, kk, v, w, u, _ = _inputs((b, s, h, 64), 3 * s + chunk, state=False)
    arrs = [a.float().numpy() for a in (r, kk, v, w, u)]
    _, got32, got_s = _mirror(r, kk, v, w, u, chunk=chunk)
    ker_o, ker_s = jkernel(*(jnp.asarray(a) for a in arrs), chunk=chunk,
                           interpret=True)
    np.testing.assert_allclose(got32.numpy(), np.asarray(ker_o, np.float32),
                               atol=OUT_ATOL, rtol=0)
    # the state (the plain version's) grows with K and the chunk: held
    # relative to its size
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ker_s, np.float32),
                               atol=2e-5, rtol=1e-5)


def test_mirror_finite_at_strong_decay():
    """w down to 1e-6 over 128-step chunks: cum falls far below -88, where
    exp(-cum) overflows float32; every factor of the mirror is ≤ 1."""
    r, kk, v, w, u, s0 = _inputs((1, 256, 2, 64), 5, w_lo=1e-6, w_hi=0.999)
    lw = torch.log(w.reshape(1, 2, 128, 2, 64)).cumsum(dim=2)
    assert float(lw.min()) < -200.0
    assert not bool(torch.isfinite(torch.exp(-lw)).all())
    got, got32, got_s = _mirror(r, kk, v, w, u, chunk=128, state0=s0)
    assert bool(torch.isfinite(got32).all() and torch.isfinite(got_s).all())
    want, _ = ref.wkv_chunked_ref(r, kk, v, w, u, chunk=128, state0=s0)
    _assert_within(_rel_errs(got, want), WKV_REL[torch.bfloat16])

"""The port's hand-written CUDA kernels against their plain versions, on
the card. They have no CPU or interpret mode, so every test here carries
the ``cuda`` marker and skips without a GPU. This file imports neither
``jax`` nor ``repro``, so it also runs where only the port is installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.kernels.moe_gmm import ref as gmm_ref
from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
from repro_torch.kernels.rwkv6_scan import ref as wkv_ref
from repro_torch.xsim import backfill

# the tolerances of the reference's own kernel tests (tests/test_kernels.py)
FLASH_ATOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
GMM_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-4),
           torch.bfloat16: dict(rtol=0, atol=3e-2)}
# ... and limits relative to the output, as chip_smoke.py holds them: an
# absolute tolerance holds only the rows whose outputs are near 1 (a
# causal row over n keys of unit-normal v has outputs of std about
# sqrt(e/n)). (largest ||Δ|| / ||want|| over output rows, rms(Δ) /
# rms(want)); in bfloat16 kernel and plain version differ by at most one
# rounding step (2^-8 to 2^-7 of |x|) where they differ at all. Each limit
# is about ten times the reading of the CUDA-core kernels on an H100 at
# the serve shapes (the bf16 row limits: about one rounding step); flash
# attention's tensor-core design, which keeps p to about 16 bits for p·v,
# reads rel_rms 8e-5 to 9e-5 there.
FLASH_REL = {torch.float32: (1e-5, 3e-6), torch.bfloat16: (8e-3, 4e-4)}
GMM_REL = {torch.float32: (1e-5, 2e-6), torch.bfloat16: (5e-3, 1e-3)}
# wkv6 against its plain chunked version, as chip_smoke.py holds its
# outputs: by the type of r (the state and float32 outputs differ in
# summation order only; in bfloat16 by at most one rounding step); the
# reference's kernel-test tolerances (out 2e-4, state 2e-5) where the
# inputs are drawn as there (unit scale, w in (0.45, 0.95))
WKV_REL = {torch.float32: (1e-5, 2e-6), torch.bfloat16: (8e-3, 3e-4)}
WKV_ATOL = (2e-4, 2e-5)


def _assert_rel_close(got, want, limits):
    d, w = got.float() - want.float(), want.float()
    row = float((d.norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)).max())
    rms = float(d.pow(2).mean().sqrt() / w.pow(2).mean().sqrt())
    lim_row, lim_rms = limits[want.dtype]
    assert row <= lim_row and rms <= lim_rms, (row, rms)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the hand-written CUDA kernels have "
                    "no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False   # full-f32 plain versions
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tables(b: int, n: int, seed: int, dev):
    """Forced end-time ties, a running/idle mix, one all-idle row, some
    +inf ends among running rows, integer core counts."""
    gen = torch.Generator().manual_seed(seed)
    ends = torch.rand(b, n, generator=gen) * 1e4
    ends[:, ::4] = 5000.0
    ends[:, 1::7] = float("inf")
    cores = torch.randint(1, 50, (b, n), generator=gen).float()
    running = torch.rand(b, n, generator=gen) < 0.5
    running[0] = False
    return ends.to(dev), cores.to(dev), running.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(1026, 53), (1026, 73), (1026, 153),
                                 (108, 2313), (4, 1), (3, 31), (3, 4096),
                                 (2, 5000), (2, 20000)])
def test_freed_scan_bitwise_against_plain(cuda_device, b, n):
    t = _tables(b, n, n, cuda_device)
    before = backfill.KERNEL_LAUNCHES["freed_scan"]
    got = backfill.freed_vector(*t, mode="kernel")
    torch.cuda.synchronize()
    assert backfill.KERNEL_LAUNCHES["freed_scan"] == before + 1
    assert torch.equal(got, backfill._freed_sorted(*t))


@pytest.mark.cuda
def test_freed_scan_refuses_bad_inputs(cuda_device):
    e, c, r = _tables(2, 8, 0, cuda_device)
    order = torch.zeros(2, 8, dtype=torch.int64, device=cuda_device)
    with pytest.raises(TypeError):
        backfill.freed_scan(e.double(), c, order)
    with pytest.raises(ValueError, match="contiguous"):
        backfill.freed_scan(e.t().contiguous().t(), c, order)
    with pytest.raises(ValueError, match="shapes"):
        backfill.freed_scan(e, c[:, :4].contiguous(), order)


def _randn(shape, seed, dev, dtype, scale=1.0):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=gen) * scale).to(dev, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hd,causal,window,dtype", [
    (2, 256, 4, 64, True, 0, torch.float32),
    (2, 256, 4, 64, False, 0, torch.float32),
    (1, 1000, 3, 128, True, 256, torch.float32),
    (2, 77, 2, 72, True, 0, torch.float32),
    (1, 130, 2, 256, True, 0, torch.float32),
    (1, 64, 1, 8, True, 16, torch.float32),
    (8, 2048, 14, 64, True, 0, torch.bfloat16),
    (4, 1024, 16, 128, True, 0, torch.bfloat16),
    (1, 300, 2, 256, True, 100, torch.bfloat16),
    # the tensor-core design (bf16, hd 64 and 128): one tile (S = 64, a
    # single kv tile, non-causal at hd 128 so no mask at all), S = 1, a
    # ragged S, S = 1000 with and without a window, non-causal, and B·H
    # above the card's 132 SMs
    (1, 64, 1, 64, True, 0, torch.bfloat16),
    (1, 64, 1, 128, False, 0, torch.bfloat16),
    (1, 64, 2, 128, True, 0, torch.bfloat16),
    (2, 1, 3, 64, True, 0, torch.bfloat16),
    (2, 1, 3, 128, True, 0, torch.bfloat16),
    (2, 77, 2, 64, True, 0, torch.bfloat16),
    (2, 77, 2, 128, True, 0, torch.bfloat16),
    (2, 1000, 4, 64, True, 0, torch.bfloat16),
    (1, 1000, 3, 128, True, 256, torch.bfloat16),
    (1, 1000, 3, 64, True, 100, torch.bfloat16),
    (2, 300, 2, 64, False, 0, torch.bfloat16),
    (2, 300, 2, 128, False, 0, torch.bfloat16),
    (12, 256, 12, 64, True, 0, torch.bfloat16),
    (4, 512, 40, 128, True, 0, torch.bfloat16),
])
def test_flash_attention_kernel_against_plain(cuda_device, b, s, h, hd,
                                              causal, window, dtype):
    q, k, v = (_randn((b, s, h, hd), i, cuda_device, dtype)
               for i in range(3))
    design = flash_ops.flash_design(dtype, hd)
    assert design == ("wgmma" if dtype == torch.bfloat16 and hd in (64, 128)
                      else "simt")
    before = flash_ops.KERNEL_LAUNCHES["flash_attention"]
    by_design = dict(flash_ops.DESIGN_LAUNCHES)
    got = flash_ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_ops.KERNEL_LAUNCHES["flash_attention"] == before + 1
    by_design[design] += 1
    assert flash_ops.DESIGN_LAUNCHES == by_design
    want = flash_ref.attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(),
                               atol=FLASH_ATOL[dtype], rtol=0)
    _assert_rel_close(got, want, FLASH_REL)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,hd,causal,dtype", [
    (300, 77, 64, False, torch.bfloat16), (77, 300, 128, False,
                                            torch.bfloat16),
    (200, 130, 64, True, torch.bfloat16), (130, 200, 128, True,
                                           torch.bfloat16),
    (200, 130, 72, True, torch.float32)])
def test_flash_attention_kernel_takes_other_key_lengths(cuda_device, sq, sk,
                                                        hd, causal, dtype):
    """q and k, v of other lengths (causal: kpos <= qpos, positions from 0
    on both), in both designs."""
    q = _randn((2, sq, 3, hd), 0, cuda_device, dtype)
    k, v = (_randn((2, sk, 3, hd), i, cuda_device, dtype) for i in (1, 2))
    design = flash_ops.flash_design(dtype, hd)
    by_design = dict(flash_ops.DESIGN_LAUNCHES)
    got = flash_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    by_design[design] += 1
    assert flash_ops.DESIGN_LAUNCHES == by_design
    want = flash_ref.attention_ref(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(),
                               atol=FLASH_ATOL[dtype], rtol=0)
    _assert_rel_close(got, want, FLASH_REL)


@pytest.mark.cuda
def test_flash_attention_kernel_refuses_bad_inputs(cuda_device):
    q = _randn((1, 16, 2, 64), 0, cuda_device, torch.float32)
    with pytest.raises(TypeError):
        flash_ops.flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(TypeError):
        flash_ops.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="contiguous"):
        flash_ops.flash_attention(q.transpose(1, 2).contiguous()
                                  .transpose(1, 2), q, q)
    with pytest.raises(ValueError, match="shapes"):
        flash_ops.flash_attention(q, q[:, :, :1].contiguous(), q)
    odd = _randn((1, 16, 2, 60), 0, cuda_device, torch.float32)
    with pytest.raises(ValueError, match="multiples of 8"):
        flash_ops.flash_attention(odd, odd, odd)
    with pytest.raises(ValueError, match="CUDA"):
        flash_ops.flash_attention(q, q.cpu(), q)
    shifted = torch.zeros(16 * 2 * 64 + 1, dtype=torch.bfloat16,
                          device=cuda_device)[1:].view(1, 16, 2, 64)
    with pytest.raises(ValueError, match="aligned"):
        flash_ops.flash_attention(shifted, q.bfloat16(), q.bfloat16())


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hd", [(8, 2048, 14, 64), (4, 1024, 16, 128),
                                      (2, 77, 2, 64)])
def test_flash_attention_simt_yardstick_against_plain(cuda_device, b, s, h,
                                                      hd):
    """The CUDA-core design, called by name at bfloat16 shapes that the
    tensor-core design serves, as chip_smoke.py times it."""
    q, k, v = (_randn((b, s, h, hd), i, cuda_device, torch.bfloat16)
               for i in range(3))
    before = flash_ops.DESIGN_LAUNCHES["simt"]
    got = flash_ops.flash_attention_simt(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_ops.DESIGN_LAUNCHES["simt"] == before + 1
    want = flash_ref.attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=FLASH_ATOL[torch.bfloat16], rtol=0)
    _assert_rel_close(got, want, FLASH_REL)


@pytest.mark.cuda
def test_flash_attention_design_matches_the_library(cuda_device):
    """``flash_design`` names the design the C launcher runs."""
    import ctypes

    from repro_torch import cuda_build

    fn = cuda_build.load("flash_attention").flash_attention_design
    fn.argtypes, fn.restype = [ctypes.c_int] * 2, ctypes.c_int
    for dtype in (torch.float32, torch.bfloat16):
        for hd in range(8, 257, 8):
            want = flash_ops.flash_design(dtype, hd) == "wgmma"
            assert fn(int(dtype == torch.bfloat16), hd) == want


@pytest.mark.cuda
@pytest.mark.parametrize("e,c,d,f,dtype", [
    (4, 128, 256, 512, torch.float32), (8, 128, 128, 1024, torch.float32),
    (3, 37, 100, 130, torch.float32), (2, 8, 176, 88, torch.float32),
    (5, 1, 33, 1, torch.float32),
    (64, 480, 2048, 1408, torch.bfloat16), (64, 480, 1408, 2048,
                                            torch.bfloat16),
    (64, 8, 2048, 1408, torch.bfloat16), (3, 17, 100, 130, torch.bfloat16),
    # the tensor-core design at its edges: ragged C (1, 37), D not a
    # multiple of 64, F not a multiple of the 128-wide tile, the decode
    # down projection, one expert; and bf16 with D or F not a multiple of
    # 8, which stays on the CUDA cores
    (4, 1, 256, 384, torch.bfloat16), (3, 37, 512, 640, torch.bfloat16),
    (2, 96, 136, 256, torch.bfloat16), (2, 160, 256, 200, torch.bfloat16),
    (64, 8, 1408, 2048, torch.bfloat16), (1, 300, 512, 384, torch.bfloat16),
    (2, 40, 132, 256, torch.bfloat16), (2, 40, 256, 132, torch.bfloat16),
])
def test_grouped_matmul_kernel_against_plain(cuda_device, e, c, d, f, dtype):
    x = _randn((e, c, d), 0, cuda_device, dtype,
               1.0 if dtype == torch.float32 else 0.5)
    w = _randn((e, d, f), 1, cuda_device, dtype,
               1.0 if dtype == torch.float32 else d ** -0.5)
    design = gmm_ops.gmm_design(dtype, d, f)
    before = gmm_ops.KERNEL_LAUNCHES["grouped_matmul"]
    by_design = dict(gmm_ops.DESIGN_LAUNCHES)
    got = gmm_ops.grouped_matmul(x, w)
    torch.cuda.synchronize()
    assert gmm_ops.KERNEL_LAUNCHES["grouped_matmul"] == before + 1
    by_design[design] += 1
    assert gmm_ops.DESIGN_LAUNCHES == by_design
    assert design == ("wgmma" if dtype == torch.bfloat16 and d % 8 == 0
                      and f % 8 == 0 else "simt")
    assert got.dtype == dtype and got.shape == (e, c, f)
    want = gmm_ref.grouped_matmul_ref(x, w)
    torch.testing.assert_close(got.float(), want.float(), **GMM_TOL[dtype])
    _assert_rel_close(got, want, GMM_REL)


@pytest.mark.cuda
@pytest.mark.parametrize("e,c,d,f", [(64, 480, 2048, 1408), (3, 37, 512, 640),
                                     (64, 8, 1408, 2048)])
def test_grouped_matmul_simt_yardstick_against_plain(cuda_device, e, c, d, f):
    """The CUDA-core design, called by name at bfloat16 shapes that the
    tensor-core design serves, as chip_smoke.py times it."""
    x = _randn((e, c, d), 0, cuda_device, torch.bfloat16, 0.5)
    w = _randn((e, d, f), 1, cuda_device, torch.bfloat16, d ** -0.5)
    before = gmm_ops.DESIGN_LAUNCHES["simt"]
    got = gmm_ops.grouped_matmul_simt(x, w)
    torch.cuda.synchronize()
    assert gmm_ops.DESIGN_LAUNCHES["simt"] == before + 1
    want = gmm_ref.grouped_matmul_ref(x, w)
    torch.testing.assert_close(got.float(), want.float(),
                               **GMM_TOL[torch.bfloat16])
    _assert_rel_close(got, want, GMM_REL)


@pytest.mark.cuda
def test_grouped_matmul_design_matches_the_library(cuda_device):
    """``gmm_design`` names the design the C launcher runs."""
    import ctypes

    from repro_torch import cuda_build

    fn = cuda_build.load("moe_gmm").grouped_matmul_design
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    for dtype in (torch.float32, torch.bfloat16):
        for d in (0, 1, 8, 100, 136, 1408, 2048):
            for f in (1, 8, 130, 200, 1408, 2048):
                want = gmm_ops.gmm_design(dtype, d, f) == "wgmma"
                assert fn(int(dtype == torch.bfloat16), d, f) == want


@pytest.mark.cuda
def test_grouped_matmul_kernel_refuses_bad_inputs(cuda_device):
    x = _randn((2, 8, 16), 0, cuda_device, torch.float32)
    w = _randn((2, 16, 24), 1, cuda_device, torch.float32)
    with pytest.raises(TypeError):
        gmm_ops.grouped_matmul(x, w.bfloat16())
    with pytest.raises(TypeError):
        gmm_ops.grouped_matmul(x.double(), w.double())
    with pytest.raises(ValueError, match="contiguous"):
        gmm_ops.grouped_matmul(x, w.transpose(1, 2).contiguous()
                               .transpose(1, 2))
    with pytest.raises(ValueError, match="E, D, F"):
        gmm_ops.grouped_matmul(x, w[:, :8].contiguous())
    with pytest.raises(ValueError, match="CUDA"):
        gmm_ops.grouped_matmul(x, w.cpu())
    shifted = torch.zeros(2 * 8 * 16 + 1, dtype=torch.bfloat16,
                          device=cuda_device)[1:].view(2, 8, 16)
    with pytest.raises(ValueError, match="aligned"):
        gmm_ops.grouped_matmul(shifted, w.bfloat16())


def _wkv_inputs(b, s, h, k, dtype, w_range, state, seed, dev):
    """r, k, v ~ N(0, 1) in ``dtype``; w = exp(-exp(z)), z uniform so
    that w spans ``w_range``; u ~ N(0, 0.5); state0 ~ N(0, 0.3) or None;
    all but r, k, v float32."""
    gen = torch.Generator().manual_seed(seed)
    r, kk, v = (torch.randn((b, s, h, k), generator=gen).to(dev, dtype)
                for _ in range(3))
    lo, hi = (torch.log(-torch.log(torch.tensor(x))) for x in w_range[::-1])
    z = lo + (hi - lo) * torch.rand((b, s, h, k), generator=gen)
    w = torch.exp(-torch.exp(z)).to(dev)
    u = (torch.randn((h, k), generator=gen) * 0.5).to(dev)
    s0 = ((torch.randn((b, h, k, k), generator=gen) * 0.3).to(dev)
          if state else None)
    return r, kk, v, w, u, s0


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,k,chunk,dtype,w_range,state", [
    (2, 128, 3, 16, 32, torch.float32, (0.45, 0.95), False),
    (1, 256, 2, 64, 64, torch.float32, (0.45, 0.95), False),
    (2, 64, 4, 8, 16, torch.float32, (0.45, 0.95), True),
    (2, 200, 3, 24, 40, torch.float32, (0.45, 0.95), True),
    (2, 3, 2, 16, 1, torch.float32, (0.45, 0.95), True),
    (1, 116, 5, 64, 116, torch.float32, (1e-4, 0.999), True),
    (2, 512, 4, 64, 128, torch.float32, (1e-6, 0.999), True),
    (8, 2048, 40, 64, 128, torch.bfloat16, (1e-4, 0.999), False),
    (8, 116, 40, 64, 116, torch.bfloat16, (1e-4, 0.999), True),
    (2, 96, 3, 40, 96, torch.bfloat16, (1e-6, 0.999), True),
    # the tensor-core design: strong decay (a 128-step chunk reaches
    # cum far below -88), two ragged 116-step chunks, chunks that are not a
    # multiple of the 16-step sub-chunk, one sub-chunk, a chunk of 1
    (2, 512, 4, 64, 128, torch.bfloat16, (1e-6, 0.999), True),
    (2, 232, 3, 64, 116, torch.bfloat16, (1e-4, 0.999), True),
    (2, 80, 3, 64, 40, torch.bfloat16, (0.45, 0.95), True),
    (2, 48, 2, 64, 16, torch.bfloat16, (0.45, 0.95), False),
    (1, 21, 2, 64, 7, torch.bfloat16, (0.45, 0.95), True),
    (3, 3, 2, 64, 1, torch.bfloat16, (0.45, 0.95), True),
])
def test_wkv6_kernel_against_plain(cuda_device, b, s, h, k, chunk, dtype,
                                   w_range, state):
    r, kk, v, w, u, s0 = _wkv_inputs(b, s, h, k, dtype, w_range, state,
                                     b + s + k, cuda_device)
    design = wkv_ops.wkv6_design(dtype, k, min(chunk, s))
    assert design == ("mma" if dtype == torch.bfloat16 and k == 64
                      else "simt")
    before = wkv_ops.KERNEL_LAUNCHES["wkv6"]
    by_design = dict(wkv_ops.DESIGN_LAUNCHES)
    got_o, got_s = wkv_ops.wkv6(r, kk, v, w, u, chunk=chunk, state0=s0)
    torch.cuda.synchronize()
    assert wkv_ops.KERNEL_LAUNCHES["wkv6"] == before + 1
    by_design[design] += 1
    assert wkv_ops.DESIGN_LAUNCHES == by_design
    want_o, want_s = wkv_ref.wkv_chunked_ref(r, kk, v, w, u, chunk=chunk,
                                             state0=s0)
    assert got_o.dtype == dtype and got_o.shape == r.shape
    assert got_s.dtype == torch.float32 and got_s.shape == (b, h, k, k)
    assert bool(torch.isfinite(got_o.float()).all()
                and torch.isfinite(got_s).all())
    if dtype == torch.float32 and w_range == (0.45, 0.95):
        torch.testing.assert_close(got_o, want_o, atol=WKV_ATOL[0], rtol=0)
        torch.testing.assert_close(got_s, want_s, atol=WKV_ATOL[1], rtol=0)
    _assert_rel_close(got_o, want_o, WKV_REL)
    _assert_rel_close(got_s, want_s, WKV_REL)
    if dtype == torch.bfloat16:
        # the state is what decode carries on: bitwise the CUDA-core
        # design's, whichever design ran
        simt_o, simt_s = wkv_ops.wkv6_simt(r, kk, v, w, u, chunk=chunk,
                                           state0=s0)
        torch.cuda.synchronize()
        assert torch.equal(got_s, simt_s)
        _assert_rel_close(simt_o, want_o, WKV_REL)


@pytest.mark.cuda
def test_wkv6_simt_yardstick_against_plain(cuda_device):
    """The CUDA-core design, called by name at the bfloat16 serve shape
    that the tensor-core design serves, as chip_smoke.py times it."""
    r, kk, v, w, u, _ = _wkv_inputs(8, 2048, 40, 64, torch.bfloat16,
                                    (1e-4, 0.999), False, 7, cuda_device)
    before = wkv_ops.DESIGN_LAUNCHES["simt"]
    got_o, got_s = wkv_ops.wkv6_simt(r, kk, v, w, u, chunk=128)
    torch.cuda.synchronize()
    assert wkv_ops.DESIGN_LAUNCHES["simt"] == before + 1
    want_o, want_s = wkv_ref.wkv_chunked_ref(r, kk, v, w, u, chunk=128)
    _assert_rel_close(got_o, want_o, WKV_REL)
    _assert_rel_close(got_s, want_s, WKV_REL)


@pytest.mark.cuda
def test_wkv6_design_matches_the_library(cuda_device):
    """``wkv6_design`` names the design the C launcher runs."""
    import ctypes

    from repro_torch import cuda_build

    fn = cuda_build.load("wkv6").wkv6_design
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    for dtype in (torch.float32, torch.bfloat16):
        for k in range(8, 65, 8):
            for chunk in (1, 7, 16, 40, 96, 116, 127, 128):
                want = wkv_ops.wkv6_design(dtype, k, chunk) == "mma"
                assert fn(int(dtype == torch.bfloat16), k, chunk) == want


@pytest.mark.cuda
def test_wkv6_kernel_refuses_bad_inputs(cuda_device):
    r, kk, v, w, u, s0 = _wkv_inputs(1, 32, 2, 16, torch.float32,
                                     (0.45, 0.95), True, 0, cuda_device)
    with pytest.raises(TypeError):
        wkv_ops.wkv6(r.double(), kk.double(), v.double(), w, u, chunk=16)
    with pytest.raises(TypeError):
        wkv_ops.wkv6(r, kk.bfloat16(), v, w, u, chunk=16)
    with pytest.raises(TypeError):
        wkv_ops.wkv6(r, kk, v, w.bfloat16(), u, chunk=16)
    with pytest.raises(ValueError, match="contiguous"):
        wkv_ops.wkv6(r.transpose(1, 2).contiguous().transpose(1, 2), kk, v,
                     w, u, chunk=16)
    with pytest.raises(ValueError, match="multiple of chunk"):
        wkv_ops.wkv6(r, kk, v, w, u, chunk=12)
    with pytest.raises(ValueError, match="u \\(H, K\\)"):
        wkv_ops.wkv6(r, kk, v, w, u[:1].contiguous(), chunk=16)
    with pytest.raises(ValueError, match="u \\(H, K\\)"):
        wkv_ops.wkv6(r, kk, v, w, u, chunk=16, state0=s0[:, :1].contiguous())
    odd = torch.zeros((1, 32, 2, 12), device=cuda_device)
    with pytest.raises(ValueError, match="multiples of 8"):
        wkv_ops.wkv6(odd, odd, odd, odd + 0.5,
                     torch.zeros((2, 12), device=cuda_device), chunk=16)
    long = torch.zeros((1, 256, 1, 8), device=cuda_device)
    with pytest.raises(ValueError, match="at most 128"):
        wkv_ops.wkv6(long, long, long, long + 0.5,
                     torch.zeros((1, 8), device=cuda_device), chunk=256)
    with pytest.raises(ValueError, match="CUDA"):
        wkv_ops.wkv6(r, kk, v, w, u.cpu(), chunk=16)
    # the tensor-core design reads r, k, v and w by TMA: 16-byte aligned
    r64, k64, v64, w64, u64, _ = _wkv_inputs(1, 32, 2, 64, torch.bfloat16,
                                             (0.45, 0.95), False, 0,
                                             cuda_device)
    shifted = torch.zeros(32 * 2 * 64 + 1, dtype=torch.bfloat16,
                          device=cuda_device)[1:].view(1, 32, 2, 64)
    with pytest.raises(ValueError, match="aligned"):
        wkv_ops.wkv6(shifted, k64, v64, w64, u64, chunk=16)

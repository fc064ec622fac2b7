"""Which design of the flash-attention kernel runs is a pure function of
type and head dim (``kernels.flash_attention.ops.flash_design``): the
tensor-core design ("wgmma") for bfloat16 at hd 64 and 128, the CUDA-core
design ("simt") for float32 and for other bfloat16 head dims. Runs
without a card; on CPU tensors the wrapper runs the plain version and
counts no launch of either design."""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops, ref

# qwen2-0.5b's and moonshot-v1-16b-a3b's head dims, gemma-2b's, and the
# other widths the kernel tests take
HEAD_DIMS = (8, 64, 72, 128, 256)


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_design(dtype, hd):
    want = ("wgmma" if dtype == torch.bfloat16 and hd in (64, 128)
            else "simt")
    assert ops.flash_design(dtype, hd) == want


@pytest.mark.parametrize("b,s,h,hd,causal,window", [
    (2, 77, 2, 64, True, 0), (1, 130, 3, 128, True, 32),
    (2, 40, 2, 72, False, 0), (1, 1, 2, 256, True, 0)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_tensors_launch_no_design(b, s, h, hd, causal, window, dtype):
    rng = np.random.default_rng(b + s + h + hd)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, hd),
                                                    np.float32)).to(dtype)
               for _ in range(3))
    before = (dict(ops.KERNEL_LAUNCHES), dict(ops.DESIGN_LAUNCHES))
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert (ops.KERNEL_LAUNCHES, ops.DESIGN_LAUNCHES) == before
    torch.testing.assert_close(got, ref.attention_ref(q, k, v, causal=causal,
                                                      window=window))
    assert got.dtype == dtype and got.shape == q.shape

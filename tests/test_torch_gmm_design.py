"""Which design of the grouped-matmul kernel runs is a pure function of
type and shape (``kernels.moe_gmm.ops.gmm_design``): the tensor-core
design ("wgmma") for bfloat16 whose D and F are multiples of 8, as TMA's
16-byte strides want, the CUDA-core design ("simt") for float32 and for
other bfloat16 shapes. Runs without a card; on CPU tensors the wrapper
runs the plain version and counts no launch of either design."""

import numpy as np
import pytest
import torch

from repro_torch.kernels.moe_gmm import ops, ref

# moonshot-v1-16b-a3b's d_model and d_ff_expert, and ragged widths
WIDTHS = (8, 64, 136, 1408, 2048, 1, 100, 130, 200, 4)


@pytest.mark.parametrize("f", WIDTHS)
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gmm_design(dtype, d, f):
    want = ("wgmma" if dtype == torch.bfloat16 and d % 8 == 0
            and f % 8 == 0 else "simt")
    assert ops.gmm_design(dtype, d, f) == want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gmm_design_of_an_empty_contraction(dtype):
    assert ops.gmm_design(dtype, 0, 64) == "simt"


@pytest.mark.parametrize("e,c,d,f", [(2, 8, 64, 136), (1, 37, 136, 200),
                                     (3, 5, 100, 130)])
def test_cpu_tensors_launch_no_design(e, c, d, f):
    rng = np.random.default_rng(e + c + d + f)
    x = torch.from_numpy(rng.standard_normal((e, c, d), np.float32))
    w = torch.from_numpy(rng.standard_normal((e, d, f), np.float32))
    before = (dict(ops.KERNEL_LAUNCHES), dict(ops.DESIGN_LAUNCHES))
    got = ops.grouped_matmul(x.bfloat16(), w.bfloat16())
    assert (ops.KERNEL_LAUNCHES, ops.DESIGN_LAUNCHES) == before
    torch.testing.assert_close(got, ref.grouped_matmul_ref(x.bfloat16(),
                                                           w.bfloat16()))
    assert got.dtype == torch.bfloat16 and got.shape == (e, c, f)

"""The port's hand-written CUDA kernels against their plain versions, on
the card. They have no CPU or interpret mode, so every test here carries
the ``cuda`` marker and skips without a GPU. This file imports neither
``jax`` nor ``repro``, so it also runs where only the port is installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from repro_torch.xsim import backfill


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the freed_scan kernel has no CPU "
                    "or interpret mode")
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

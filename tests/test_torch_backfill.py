"""The EASY reservation scan and the scheduling pass of the port against
the reference, on the CPU (the ``freed_scan`` kernel itself is held
against its plain version on the card by ``test_torch_cuda.py``).

Freed values are exact integer sums below 2**24, so every comparison
here is bitwise.
"""

import jax
import numpy as np
import pytest
import torch

from repro.xsim import backfill as jbackfill
from repro.xsim import events as jevents
from repro.xsim import grid as jgrid
from repro.xsim import policies as jpolicies
from repro_torch import convert
from repro_torch.xsim import backfill as tbackfill

jax.config.update("jax_threefry_partitionable", True)
torch.set_num_threads(1)   # small tensors: threads only contend


def _tables(b: int, n: int, seed: int):
    """Random (B, N) tables: forced end-time ties, a running/idle mix, one
    all-idle row, and some +inf ends among running rows."""
    rng = np.random.default_rng(seed)
    ends = rng.uniform(0, 1e4, (b, n)).astype(np.float32)
    ends[:, ::4] = 5000.0
    ends[:, 1::7] = np.inf
    cores = rng.integers(1, 50, (b, n)).astype(np.float32)
    running = rng.random((b, n)) < 0.5
    running[0] = False
    return ends, cores, running


@pytest.mark.parametrize("n", [1, 53, 73, 153, 2313])
def test_plain_versions_bitwise_against_reference(n):
    b = 3 if n < 2313 else 2
    ends, cores, running = _tables(b, n, seed=n)
    ref = np.asarray(jax.vmap(jbackfill._freed_sorted)(ends, cores, running))
    ref_n2 = np.asarray(jax.vmap(jbackfill._freed_math)(ends, cores, running))
    ref_kernel = np.asarray(jbackfill.freed_matrix(ends, cores, running,
                                                   interpret=True))
    np.testing.assert_array_equal(ref, ref_n2)
    np.testing.assert_array_equal(ref, ref_kernel)
    t = [torch.as_tensor(x) for x in (ends, cores, running)]
    np.testing.assert_array_equal(tbackfill._freed_sorted(*t).numpy(), ref)
    np.testing.assert_array_equal(tbackfill._freed_math(*t).numpy(), ref)
    # on CPU tensors the kernel wrapper takes its plain version
    np.testing.assert_array_equal(tbackfill.freed_matrix(*t).numpy(), ref)
    for mode in ("auto", "ref", "ref_n2"):
        np.testing.assert_array_equal(
            tbackfill.freed_vector(*t, mode=mode).numpy(), ref)


def test_kernel_modes_refuse_cpu_tensors():
    t = [torch.as_tensor(x) for x in _tables(2, 8, seed=0)]
    with pytest.raises(ValueError, match="CUDA"):
        tbackfill.freed_vector(*t, mode="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        tbackfill.freed_scan(t[0], t[1], torch.zeros(2, 8, dtype=torch.long))
    with pytest.raises(ValueError, match="freed mode"):
        tbackfill.freed_vector(*t, mode="tpu")
    with pytest.raises(TypeError, match="bool"):
        tbackfill.freed_matrix(t[0], t[1], t[2].float())


STEP_CHUNK = 6


@pytest.fixture(scope="module")
def reference_states():
    """A reference-built grid, and the same grid stepped 6 and 42 events
    by the reference: queues, running jobs and ties as a sweep sees
    them."""
    cfg = jgrid.XSimConfig(n_warm=16, n_backlog=12, n_arrivals=16,
                           max_stages=9, t0=1800.0)
    grid = jgrid.make_grid(cfg, n_seeds=1, shrink=1 / 64.0,
                           policy_ids=(0, 1, 2, 5))
    fleet = jpolicies.init_fleet(int(grid.geo_idx.max()) + 1)
    ests = jpolicies.scenario_estimators(fleet, grid.geo_idx, 1)
    states = {0: grid.build(ests)}
    st = states[0]
    for k in range(1, 8):
        st = jevents.sweep(st, n_steps=STEP_CHUNK, chunk_steps=0,
                           pred_mode="greedy", naive=False)
        states[k * STEP_CHUNK] = st
    return states


_ref_pass = jax.jit(jax.vmap(lambda s: jbackfill.schedule_pass(s)))


@pytest.mark.parametrize("n_steps", [0, 6, 42])
def test_schedule_pass_on_carried_states(reference_states, n_steps):
    """One scheduling pass of both packages from identical state (the
    reference's, carried across), at the grid's t=0 and mid-sweep: every
    field equal, bit for bit."""
    st = reference_states[n_steps]
    ref = _ref_pass(st)
    got = tbackfill.schedule_pass(
        convert.scenario_state(jax.tree.map(np.asarray, st)))
    want = convert.to_numpy(
        convert.scenario_state(jax.tree.map(np.asarray, ref)))
    got = convert.to_numpy(got)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_reservation_matches_reference():
    ends, cores, running = _tables(6, 73, seed=11)
    rng = np.random.default_rng(12)
    free = rng.integers(0, 40, 6).astype(np.float32)
    head = rng.integers(0, 200, 6).astype(np.float32)
    ref = jax.vmap(jbackfill.reservation)(ends, cores, running, free, head)
    got = tbackfill.reservation(*(torch.as_tensor(x) for x in
                                  (ends, cores, running, free, head)))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

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
    """``freed_matrix`` in the design its row length picks, and the
    "presorted" design by name at every shape, against the plain
    version."""
    t = _tables(b, n, n, cuda_device)
    design = backfill.freed_design(n)
    before = (backfill.KERNEL_LAUNCHES["freed_scan"],
              dict(backfill.DESIGN_LAUNCHES))
    got = backfill.freed_vector(*t, mode="kernel")
    torch.cuda.synchronize()
    assert backfill.KERNEL_LAUNCHES["freed_scan"] == before[0] + 1
    assert backfill.DESIGN_LAUNCHES[design] == before[1][design] + 1
    want = backfill._freed_sorted(*t)
    assert torch.equal(got, want)
    presorted = backfill.freed_presorted(*t)
    torch.cuda.synchronize()
    assert backfill.DESIGN_LAUNCHES["presorted"] == (
        before[1]["presorted"] + 1 + (design == "presorted"))
    assert torch.equal(presorted, want)


def _freed_edge(name: str, dev):
    """The edge cases of ``tests/test_torch_freed_design.py``'s mirror, as
    (ends, cores, running) on ``dev``."""
    gen = torch.Generator().manual_seed(len(name))
    if name == "n1":
        t = (torch.tensor([[3.0], [float("inf")], [7.0]]),
             torch.tensor([[4.0], [9.0], [2.0]]),
             torch.tensor([[True], [True], [False]]))
        return tuple(x.to(dev) for x in t)
    if name == "n_not_multiple_of_32":
        return _tables(3, 45, 1, dev)
    if name in ("r_power_of_two", "r_power_of_two_plus_one"):
        want = 128 + (name == "r_power_of_two_plus_one")
        e, c, _ = _tables(2, 300, 2, dev)
        r = torch.zeros(2, 300, dtype=torch.bool)
        for row in r:
            row[torch.randperm(300, generator=gen)[:want]] = True
        return e, c, r.to(dev)
    if name == "all_idle":
        e, c, r = _tables(2, 70, 3, dev)
        return e, c, torch.zeros_like(r)
    if name == "all_running":
        e, c, r = _tables(2, 300, 4, dev)
        return e, c, torch.ones_like(r)
    if name == "every_end_tied":
        e, c, r = _tables(3, 100, 5, dev)
        return torch.full_like(e, 42.0), c, r
    if name == "inf_ends_running":
        e, c, r = _tables(2, 257, 6, dev)
        e[:, ::3] = float("inf")
        return e, c, torch.ones_like(r)
    if name == "signed_zeros":
        e, c, r = _tables(2, 64, 7, dev)
        e[:, ::3] = 0.0
        e[:, 1::3] = -0.0
        return e, c, r
    if name == "fused_limit":
        return _tables(2, backfill.FUSED_MAX_N, 8, dev)
    raise KeyError(name)


FREED_EDGES = ["n1", "n_not_multiple_of_32", "r_power_of_two",
               "r_power_of_two_plus_one", "all_idle", "all_running",
               "every_end_tied", "inf_ends_running", "signed_zeros",
               "fused_limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", FREED_EDGES)
def test_freed_fused_bitwise_on_edge_cases(cuda_device, name):
    t = _freed_edge(name, cuda_device)
    before = backfill.DESIGN_LAUNCHES["fused"]
    got = backfill.freed_fused(*t)
    torch.cuda.synchronize()
    assert backfill.DESIGN_LAUNCHES["fused"] == before + 1
    assert torch.equal(got, backfill._freed_sorted(*t))
    if t[0].shape[1] <= 300:
        assert torch.equal(got, backfill._freed_math(*t))


@pytest.mark.cuda
@pytest.mark.parametrize("n,design", [(backfill.FUSED_MAX_N, "fused"),
                                      (backfill.FUSED_MAX_N + 1,
                                       "presorted")])
def test_freed_design_at_the_fused_limit(cuda_device, n, design):
    t = _tables(3, n, n, cuda_device)
    assert backfill.freed_design(n) == design
    before = dict(backfill.DESIGN_LAUNCHES)
    got = backfill.freed_matrix(*t)
    torch.cuda.synchronize()
    assert backfill.DESIGN_LAUNCHES == {
        d: before[d] + (d == design) for d in before}
    assert torch.equal(got, backfill._freed_sorted(*t))


@pytest.mark.cuda
def test_freed_design_matches_the_library(cuda_device):
    """``freed_design`` names the design the C launcher takes."""
    import ctypes

    from repro_torch import cuda_build

    fn = cuda_build.load("freed_scan").freed_design
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    for n in (0, 1, 2, 255, 256, 257, 2313, 16383, 16384, 16385, 29056):
        assert fn(n) == (backfill.freed_design(n) == "fused")


@pytest.mark.cuda
def test_freed_matrix_in_a_cuda_graph(cuda_device):
    """The "fused" launch captured in a CUDA graph and replayed on new
    table contents, bitwise; a replay counts no launch."""
    static = [x.clone() for x in _tables(108, 2313, 0, cuda_device)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # warm up (build, attributes) first
        backfill.freed_matrix(*static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = backfill.freed_matrix(*static)
    launches = backfill.DESIGN_LAUNCHES["fused"]
    for seed in (1, 2, 3):
        fresh = _tables(108, 2313, seed, cuda_device)
        for dst, src in zip(static, fresh):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, backfill._freed_sorted(*fresh))
    assert backfill.DESIGN_LAUNCHES["fused"] == launches


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


@pytest.mark.cuda
def test_freed_fused_refuses_bad_inputs(cuda_device):
    e, c, r = _tables(2, 8, 0, cuda_device)
    with pytest.raises(TypeError):
        backfill.freed_fused(e.double(), c, r)
    with pytest.raises(TypeError):
        backfill.freed_fused(e, c, r.float())
    with pytest.raises(ValueError, match="contiguous"):
        backfill.freed_fused(e.t().contiguous().t(), c, r)
    with pytest.raises(ValueError, match="shapes"):
        backfill.freed_fused(e, c[:, :4].contiguous(), r)
    with pytest.raises(ValueError, match="CUDA"):
        backfill.freed_fused(e, c, r.cpu())
    n = backfill.FUSED_MAX_N + 1
    long = torch.zeros(1, n, device=cuda_device)
    with pytest.raises(ValueError, match="at most"):
        backfill.freed_fused(long, long, long.bool())


# the port's xsim parity tests' grid size (tests/test_torch_xsim.py)
XSIM_CFG = dict(n_warm=16, n_backlog=12, n_arrivals=16, max_stages=9,
                t0=1800.0)


def _faulty_naive_grid(dev, traced: bool = False, **kw):
    from repro_torch.xsim import families
    from repro_torch.xsim import grid as grid_mod

    cfg = grid_mod.XSimConfig(**XSIM_CFG)
    return families.family_grid(cfg.with_trace() if traced else cfg,
                                "faulty", shrink=1 / 64.0, device=dev, **kw)


@pytest.mark.cuda
def test_naive_faulty_sweep_kernel_route_bitwise(cuda_device):
    """ASA-Naive beside every other ported policy on the ``faulty``
    family: the sweep through the kernel and through the plain scan give
    bitwise equal final states; only the kernel route launches."""
    from repro_torch import convert
    from repro_torch.xsim import grid as grid_mod

    grid = _faulty_naive_grid(cuda_device, n_seeds=2,
                              policy_ids=(0, 1, 2, 3, 5))
    before = backfill.KERNEL_LAUNCHES["freed_scan"]
    fused = backfill.DESIGN_LAUNCHES["fused"]
    fin_k, m = grid_mod.run_grid(grid, device=cuda_device)
    launched = backfill.KERNEL_LAUNCHES["freed_scan"] - before
    assert launched > 0
    assert backfill.DESIGN_LAUNCHES["fused"] - fused == launched
    fin_r, _ = grid_mod.run_grid(grid, freed_mode="ref", device=cuda_device)
    assert backfill.KERNEL_LAUNCHES["freed_scan"] - before == launched
    a, b = convert.to_numpy(fin_k), convert.to_numpy(fin_r)
    for k in a:
        assert torch.equal(torch.from_numpy(a[k]), torch.from_numpy(b[k])), k
    assert torch.equal(m["wf_done"], m["wf_total"])
    assert int(m["misses"].sum()) > 0 and int(m["restarts"].sum()) > 0
    assert torch.equal(fin_k.free, fin_k.total)
    assert bool((fin_k.fault_next == grid.fault_t.shape[1]).all())


def _rl_grid(dev, **kw):
    from repro_torch.xsim import grid as grid_mod

    return grid_mod.make_grid(grid_mod.XSimConfig(**XSIM_CFG),
                              shrink=1 / 64.0, device=dev, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("rl_mode", ["sample", "greedy"])
def test_rl_sweep_kernel_route_bitwise(cuda_device, rl_mode):
    """The learned policy beside ASA and ASA-Naive: the sweep through the
    kernel and through the plain scan give bitwise equal final states, the
    recorded observations and actions included; every launch ``fused``."""
    from repro_torch import convert
    from repro_torch.core import prng
    from repro_torch.rl import policy as rl_policy
    from repro_torch.xsim import grid as grid_mod

    grid = _rl_grid(cuda_device, n_seeds=2, policy_ids=(2, 3, 4))
    params = rl_policy.init_params(prng.PRNGKey(4), device=cuda_device)
    before = backfill.KERNEL_LAUNCHES["freed_scan"]
    fused = backfill.DESIGN_LAUNCHES["fused"]
    fin_k, m = grid_mod.run_grid(grid, params=params, rl_mode=rl_mode,
                                 device=cuda_device)
    launched = backfill.KERNEL_LAUNCHES["freed_scan"] - before
    assert launched > 0
    assert backfill.DESIGN_LAUNCHES["fused"] - fused == launched
    fin_r, _ = grid_mod.run_grid(grid, params=params, rl_mode=rl_mode,
                                 freed_mode="ref", device=cuda_device)
    assert backfill.KERNEL_LAUNCHES["freed_scan"] - before == launched
    a, b = convert.to_numpy(fin_k), convert.to_numpy(fin_r)
    for k in a:
        assert torch.equal(torch.from_numpy(a[k]), torch.from_numpy(b[k])), k
    assert torch.equal(m["wf_done"], m["wf_total"])
    rl = fin_k.policy == 4
    assert bool((fin_k.rl_act[rl] >= 0).any())
    assert bool((fin_k.rl_act[~rl] == -1).all())


@pytest.mark.cuda
def test_reinforce_step_on_the_card_against_the_cpu(cuda_device):
    """One REINFORCE update on a rollout's buffers on the card and on the
    CPU: new params within 1e-5 relative (of each leaf's largest entry),
    the entropy within 1e-5."""
    from repro_torch.core import prng
    from repro_torch.rl import policy as rl_policy
    from repro_torch.rl import rollout
    from repro_torch.rl import train as rl_train

    grid = _rl_grid(cuda_device, n_seeds=4, policy_ids=(4,))
    params = rl_policy.init_params(prng.PRNGKey(1), device=cuda_device)
    _, _, traj = rollout.collect(grid, params, device=cuda_device)
    new_g, ent_g = rl_train.reinforce_step(params, *traj, 0.3)
    cpu = rl_policy.PolicyParams(*(p.cpu() for p in params))
    new_c, ent_c = rl_train.reinforce_step(cpu, *(x.cpu() for x in traj),
                                           0.3)
    for g, c in zip(new_g, new_c):
        scale = float(c.abs().max())
        assert float((g.cpu() - c).abs().max()) <= 1e-5 * scale
    assert abs(float(ent_g) - float(ent_c)) <= 1e-5 * float(ent_c)


@pytest.mark.cuda
@pytest.mark.parametrize("rl_mode", ["sample", "greedy"])
def test_rl_steps_add_no_host_sync(cuda_device, rl_mode):
    """A chunk of the learned policy's steps (the drain cut as
    ``simulate``'s first try cuts it, then whole) with CUDA's sync debug
    mode set to raise on any synchronising call."""
    from repro_torch.core import prng
    from repro_torch.core.bins import make_bins
    from repro_torch.rl import policy as rl_policy
    from repro_torch.xsim import events, policies

    grid = _rl_grid(cuda_device, n_seeds=1, policy_ids=(2, 3, 4))
    fleet = policies.init_fleet(int(grid.geo_idx.max()) + 1,
                                device=cuda_device)
    s = grid.build(policies.scenario_estimators(
        fleet, torch.as_tensor(grid.geo_idx, device=cuda_device), 1))
    bins = torch.as_tensor(make_bins(53), dtype=torch.float32,
                           device=cuda_device)
    params = rl_policy.init_params(prng.PRNGKey(2), device=cuda_device)
    kw = dict(naive=True, pred_mode="greedy", params=params, rl_mode=rl_mode)
    s, _ = events.sim_step(s, bins, **kw)     # builds the kernel library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for pairs in (events.SPEC_HOOK_PAIRS,) * 4 + (None,) * 4:
            s, _ = events.sim_step(s, bins, hook_pairs=pairs, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert int(s.steps.max()) == 9
    assert bool((s.rl_act[s.policy == 4] >= 0).any())


@pytest.mark.cuda
def test_naive_and_fault_steps_add_no_host_sync(cuda_device):
    """A few steps of the naive-and-faults program, the capacity faults
    and the naive drain on their own too, with CUDA's sync debug mode set
    to raise on any synchronising call."""
    from repro_torch.core.bins import make_bins
    from repro_torch.xsim import events, policies

    grid = _faulty_naive_grid(cuda_device, n_seeds=1, policy_ids=(2, 3))
    fleet = policies.init_fleet(int(grid.geo_idx.max()) + 1,
                                device=cuda_device)
    s = grid.build(policies.scenario_estimators(
        fleet, torch.as_tensor(grid.geo_idx, device=cuda_device), 1))
    bins = torch.as_tensor(make_bins(53), dtype=torch.float32,
                           device=cuda_device)
    kw = dict(naive=True, faults=True, pred_mode="sample")
    s, _ = events.sim_step(s, bins, **kw)     # builds the kernel library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(4):
            events._apply_faults(s, s.t)
            events._drain_hooks(s, s.t, bins, False, True)
            s, _ = events.sim_step(s, bins, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert int(s.steps.max()) == 5


@pytest.mark.cuda
def test_traced_sweep_kernel_route_bitwise(cuda_device):
    """The traced naive ``faulty`` sweep through the kernel and through
    the plain scan: bitwise equal final states, event rings included;
    without its ring the state is the untraced run's, bit for bit, with
    the same launches; every event kind occurs and nothing overflowed."""
    from repro_torch import convert
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import trace as obs_trace
    from repro_torch.xsim import grid as grid_mod

    kw = dict(n_seeds=2, policy_ids=(0, 1, 2, 3))
    grid = _faulty_naive_grid(cuda_device, traced=True, **kw)
    before = backfill.KERNEL_LAUNCHES["freed_scan"]
    fin_k, m = grid_mod.run_grid(grid, device=cuda_device)
    launched = backfill.KERNEL_LAUNCHES["freed_scan"] - before
    assert launched > 0 and fin_k.trace.data.is_cuda
    fin_r, _ = grid_mod.run_grid(grid, freed_mode="ref", device=cuda_device)
    a, b = convert.to_numpy(fin_k), convert.to_numpy(fin_r)
    assert "trace.data" in a and "trace.head" in a
    for k in a:
        assert torch.equal(torch.from_numpy(a[k]), torch.from_numpy(b[k])), k
    before = backfill.KERNEL_LAUNCHES["freed_scan"]
    fin_u, _ = grid_mod.run_grid(_faulty_naive_grid(cuda_device, **kw),
                                 device=cuda_device)
    assert backfill.KERNEL_LAUNCHES["freed_scan"] - before == launched
    u = convert.to_numpy(fin_u)
    assert u.keys() == {k for k in a if not k.startswith("trace.")}
    for k in u:
        assert torch.equal(torch.from_numpy(u[k]), torch.from_numpy(a[k])), k
    assert not bool(obs_trace.overflowed(fin_k.trace).any())
    h = obs_metrics.to_host(obs_metrics.sweep_summary(
        fin_k, n_steps=grid.cfg.n_steps))
    assert all(h[f"ev_{n}"] > 0 for n in obs_trace.EVENT_NAMES.values()), h
    assert sum(h[f"ev_{n}"] for n in obs_trace.EVENT_NAMES.values()) \
        == h["trace_events"]


@pytest.mark.cuda
def test_trace_appends_add_no_host_sync(cuda_device):
    """A few traced steps of the naive-and-faults program, the kill,
    cancel and fused appends among them, and each append on its own,
    with CUDA's sync debug mode set to raise on any synchronising call."""
    from repro_torch.core.bins import make_bins
    from repro_torch.obs import trace as obs_trace
    from repro_torch.xsim import events, policies

    grid = _faulty_naive_grid(cuda_device, traced=True, n_seeds=1,
                              policy_ids=(2, 3))
    fleet = policies.init_fleet(int(grid.geo_idx.max()) + 1,
                                device=cuda_device)
    s = grid.build(policies.scenario_estimators(
        fleet, torch.as_tensor(grid.geo_idx, device=cuda_device), 1))
    bins = torch.as_tensor(make_bins(53), dtype=torch.float32,
                           device=cuda_device)
    kw = dict(naive=True, faults=True, pred_mode="sample")
    s, _ = events.sim_step(s, bins, **kw)     # builds the kernel library
    torch.cuda.synchronize()
    s0 = s
    b, n = s.status.shape
    running = s.status == 3
    lanes = dict(job=torch.zeros((b, n), dtype=torch.int32,
                                 device=cuda_device),
                 stage=events._job_stage(s), cores=s.cores)
    scen = dict(t=s.t, policy=s.policy, step=s.steps)
    torch.cuda.set_sync_debug_mode("error")
    try:
        tr = obs_trace.append_masked(s.trace, running,
                                     kind=obs_trace.EV_START, **lanes,
                                     **scen)
        tr = obs_trace.append_segments(
            tr, [(running, obs_trace.EV_FINISH, lanes["job"],
                  lanes["stage"], s.cores)] * 2, **scen)
        tr = obs_trace.append_if(tr, s.repass, kind=obs_trace.EV_CANCEL,
                                 job=s.steps, stage=s.steps,
                                 cores=s.free, **scen)
        for _ in range(4):
            events._apply_faults(s, s.t)
            events._drain_hooks(s, s.t, bins, False, True)
            s, _ = events.sim_step(s, bins, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert int(s.steps.max()) == 5 and int(s.trace.head.min()) > 0
    assert torch.equal(tr.head, s0.trace.head
                       + 3 * running.sum(dim=1, dtype=torch.int32)
                       + s0.repass.to(torch.int32))


@pytest.mark.cuda
def test_trace_init_and_traced_grid_on_the_card(cuda_device):
    """``trace.init`` and a traced ``make_grid`` place their rings on the
    card by default; the card's ``sweep_summary`` equals the same summary
    computed on the CPU from the card's final state."""
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import trace as obs_trace
    from repro_torch.xsim import grid as grid_mod

    tr = obs_trace.init(8, 3)
    assert tr.data.is_cuda and tr.data.shape == (3, 8, obs_trace.NF)
    cfg = grid_mod.XSimConfig(**XSIM_CFG).with_trace()
    grid = grid_mod.make_grid(cfg, n_seeds=1, policy_ids=(0, 1, 2))
    final, _ = grid_mod.run_grid(grid)
    assert final.trace.data.is_cuda and final.trace.head.is_cuda
    on_card = obs_metrics.to_host(obs_metrics.sweep_summary(
        final, n_steps=cfg.n_steps))
    cpu = type(final)(*(None if v is None else
                        type(v)(*(x.cpu() for x in v)) if isinstance(v, tuple)
                        else v.cpu() for v in final))
    on_cpu = obs_metrics.to_host(obs_metrics.sweep_summary(
        cpu, n_steps=cfg.n_steps))
    assert on_card.keys() == on_cpu.keys()
    for k in on_card:
        if isinstance(on_card[k], float):
            assert on_card[k] == pytest.approx(on_cpu[k], rel=1e-6), k
        else:
            assert on_card[k] == on_cpu[k], k
    assert on_card["trace_events"] == int(final.trace.head.sum()) > 0


# the QueueSim differentials of tests/test_torch_xsim_queue_sim.py: a
# warmed tiny center snapshotted into the fleet simulator, (kind,
# workflow name, seed) as the reference's cross-validation tests take them
_TINY_KW = dict(
    name="tiny", nodes=8, cores_per_node=4,
    bg_arrival_rate=1 / 200.0, bg_cores_mean=1.5, bg_cores_sigma=0.8,
    bg_duration_mean_s=7.0, bg_duration_sigma=0.8, bg_initial_backlog=12,
    bg_burst_mean=1.0, scales=(8,))
_QS_DEPS = ([("bigjob", w, s) for w in ("blast", "statistics")
             for s in (0, 1, 2)]
            + [("per_stage", w, s) for w in ("blast", "statistics", "montage")
               for s in (0, 1, 2)]
            + [("asa", w, s) for w in ("statistics", "montage")
               for s in (0, 2, 3)]
            + [("pilot", w, s) for w in ("blast", "statistics")
               for s in (0, 1, 2)])
_QS_NAIVE = [("asa_naive", w, s) for w in ("statistics", "montage")
             for s in (0, 2, 3)]


def _queue_sim_batch(cases, dev):
    """(batch on ``dev``, the port's QueueSim run of each case)."""
    from repro_torch.core import asa, prng
    from repro_torch.sched import strategies as S
    from repro_torch.sched.centers import CenterProfile
    from repro_torch.sched.queue_sim import QueueSim
    from repro_torch.sched.workflows import WORKFLOWS
    from repro_torch.xsim import compare, policies
    from repro_torch.xsim import state as X

    tiny = CenterProfile(**_TINY_KW)
    states, refs = [], []
    for kind, name, seed in cases:
        wf = WORKFLOWS[name]
        sim = QueueSim(tiny, seed=seed, bg_horizon=0.0)
        sim.run_until(600.0)
        table, row = compare.scenario_from_queue_sim(sim, max_jobs=64)
        free = compare.queue_sim_free_cores(sim)
        kw = {}
        if kind in ("asa", "asa_naive"):
            kw["est"] = asa.init(53, prng.PRNGKey(seed + 17, dev))
            refs.append(S.run_asa(sim, wf, 8, "tiny",
                                  S.ASAEstimator(seed=seed + 17, device=dev),
                                  use_dependencies=kind == "asa"))
        else:
            refs.append(getattr(S, f"run_{kind}")(sim, wf, 8, "tiny"))
        if kind == "pilot":
            kw["pilot_waste_cs"] = S.pilot_waste_cs(wf, 8)
        pol = X.POLICY_NAMES.index(kind)
        policies.add_workflow(table, row, wf, 8, pol, t0=600.0)
        states.append(X.freeze(table, total_cores=tiny.total_cores,
                               free_cores=free, now=600.0, policy=pol,
                               t0=600.0, device=dev, **kw))
    return X.concat(states), refs


@pytest.mark.cuda
@pytest.mark.parametrize("naive", [False, True])
def test_queue_sim_differentials_kernel_route_bitwise(cuda_device, naive):
    """The QueueSim differentials frozen on the card: the sweep through
    the kernel and through the plain scan give bitwise equal final
    states, every launch ``fused``; the metrics hold the QueueSim runs
    at the reference's tolerances."""
    from repro_torch import convert
    from repro_torch.xsim import compare, events

    batch, refs = _queue_sim_batch(_QS_NAIVE if naive else _QS_DEPS,
                                   cuda_device)
    before = backfill.KERNEL_LAUNCHES["freed_scan"]
    fused = backfill.DESIGN_LAUNCHES["fused"]
    fin_k = events.sweep(batch, n_steps=300, naive=naive, device=cuda_device)
    launched = backfill.KERNEL_LAUNCHES["freed_scan"] - before
    assert launched > 0
    assert backfill.DESIGN_LAUNCHES["fused"] - fused == launched
    fin_r = events.sweep(batch, n_steps=300, naive=naive, freed_mode="ref",
                         device=cuda_device)
    assert backfill.KERNEL_LAUNCHES["freed_scan"] - before == launched
    a, b = convert.to_numpy(fin_k), convert.to_numpy(fin_r)
    for k in a:
        assert torch.equal(torch.from_numpy(a[k]), torch.from_numpy(b[k])), k
    m = {k: v.cpu() for k, v in compare.metrics(fin_k).items()}
    for i, ref in enumerate(refs):
        for k in ("twt_s", "makespan_s"):
            assert float(m[k][i]) == pytest.approx(
                getattr(ref, k), rel=0.02, abs=5.0), (i, k)
        assert float(m["oh_hours"][i]) == pytest.approx(ref.oh_hours,
                                                        abs=1e-3)
        assert int(m["misses"][i]) == ref.misses
    if naive:
        assert int(m["misses"].sum()) > 0


@pytest.mark.cuda
def test_estimator_learn_adds_no_host_sync(cuda_device):
    """``ASAEstimator.learn`` on the card, with CUDA's sync debug mode set
    to raise on any synchronising call: its wait and γ are fills."""
    from repro_torch.sched.strategies import ASAEstimator

    est = ASAEstimator(seed=3, device=cuda_device)
    est.learn(1234.5)                   # first call: allocations, caches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for w in (0.5, 60.0, 4000.0, 2e5):
            est.learn(w)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert int(est.state.t) == 10 and est.state.log_p.is_cuda


@pytest.mark.cuda
def test_run_table1_on_cuda_equals_cpu(cuda_device):
    """A short Table-1 run with the estimators on the card gives the CPU
    run's metrics, run for run (within one process: the estimator seeds
    come from ``hash()``)."""
    import dataclasses

    from repro_torch.sched import runner

    kw = dict(seed=0, include_naive=True, include_pilot=True,
              workflows=("blast",), n_warmup=2)
    got = runner.run_table1(**kw, device=cuda_device)
    want = runner.run_table1(**kw, device="cpu")
    assert len(got.runs) == 6 * 5
    assert [dataclasses.asdict(r) for r in got.runs] == \
        [dataclasses.asdict(r) for r in want.runs]


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


# ----------------------------------------------- the ASA service on the card
def _serve_batches(n_slots: int, batch: int, n_batches: int, seed: int):
    """Host query batches (distinct observing slots, repeated decision
    slots, pad rows), made from a seed."""
    import numpy as np

    from repro_torch.parallel import fleet
    from repro_torch.serve import asa as serve_asa

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        live = int(rng.integers(1, batch + 1))
        slot = rng.integers(0, n_slots, live).astype(np.int32)
        has = rng.random(live) < 0.6
        _, first = np.unique(slot, return_index=True)
        has &= np.isin(np.arange(live), first)   # one observation a slot
        wait = np.exp(rng.uniform(np.log(5.0), np.log(9e4), live))
        q = serve_asa.QueryBatch(
            slot=torch.from_numpy(slot),
            observed_wait=torch.from_numpy(wait.astype(np.float32)),
            has_obs=torch.from_numpy(has))
        out.append((live,) + fleet.pad_batch(q, batch))
    return out


@pytest.mark.cuda
def test_serve_step_on_the_card_against_the_cpu_route(cuda_device):
    """The decision step on the card and on the CPU from the same table:
    keys, rounds and t bitwise, log_p within 1e-4 (the engine's), the
    decisions within the CPU parity tests' tolerances; a MAP bin may flip
    only at a near-tie of the CPU posterior (gap <= 2e-4)."""
    import numpy as np

    from repro_torch.core.bins import make_bins
    from repro_torch.serve import asa as serve_asa

    cpu = serve_asa.init_table(1536, device="cpu", seed=3)
    card = serve_asa.init_table(1536, device=cuda_device, seed=3)
    bins = make_bins(53).astype(np.float32)
    flips = reads = 0
    for live, q, mask in _serve_batches(1536, 256, 40, seed=5):
        cpu, dec_c = serve_asa.serve_step(cpu, q, mask)
        qd, md = serve_asa.query_to(q, mask, cuda_device)
        card, dec_g = serve_asa.serve_step(card, qd, md)
        for f in ("key", "rounds", "t"):
            assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f)), f
        assert float((card.log_p.cpu() - cpu.log_p).abs().max()) <= 1e-4
        lc, ec, hc = serve_asa.decisions_to_host(dec_c)
        lg, eg, hg = serve_asa.decisions_to_host(dec_g)
        np.testing.assert_allclose(eg[:live], ec[:live], rtol=1.5e-5)
        np.testing.assert_allclose(hg[:live], hc[:live], rtol=0, atol=1e-5)
        rows = cpu.log_p[q.slot.long()].numpy()
        for i in np.flatnonzero(lg[:live] != lc[:live]):
            got = int(np.flatnonzero(bins == lg[i])[0])
            assert rows[i].max() - rows[i, got] <= 2e-4
            flips += 1
        reads += live
    assert flips <= reads // 10, (flips, reads)


@pytest.mark.cuda
def test_serve_step_issues_no_host_sync(cuda_device):
    """``query_to`` and ``serve_step`` run under CUDA's sync debug mode
    set to raise: no device read, no blocking copy; the one read of a
    batch is ``decisions_to_host``."""
    from repro_torch.serve import asa as serve_asa

    table = serve_asa.init_table(1536, device=cuda_device)
    batches = _serve_batches(1536, 256, 4, seed=9)
    serve_asa.wait_bins(53, table.log_p.device)     # made once, outside
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _live, q, mask in batches:
            qd, md = serve_asa.query_to(q, mask, cuda_device)
            table, dec = serve_asa.serve_step(table, qd, md)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    lead, _, _ = serve_asa.decisions_to_host(dec)
    assert lead.shape == (256,)


@pytest.mark.cuda
def test_threaded_server_on_the_card_restarts_and_recovers_bitwise(
        cuda_device, tmp_path):
    """A threaded ``ASAServer`` on the card: a checkpoint restores into a
    server whose decide-only probes are bitwise the running one's, and a
    supervised crash restores from it bitwise too."""
    import time

    from repro_torch.serve import chaos as schaos
    from repro_torch.serve.loop import (ASAServer, ServeConfig,
                                        ServeSupervisor)

    cfg = ServeConfig(n_slots=64, batch_size=16,
                      checkpoint_dir=str(tmp_path / "ckpt"))
    server = ASAServer(cfg, device=cuda_device)
    server.start()
    try:
        futs = [server.submit(t % 40, observed_wait=30.0 * (1 + t % 7))
                for t in range(200)]
        for f in futs:
            f.result(timeout=60)
    finally:
        server.stop()
    server.save(step=5)
    restored = ASAServer.restore(cfg, step=5, device=cuda_device)

    def probe(srv):
        srv.start()
        try:
            fs = [srv.submit(t) for t in range(40)]
            return [(d.lead_s, d.expected_s, d.entropy)
                    for d in (f.result(timeout=60) for f in fs)]
        finally:
            srv.stop()
    want = probe(server)
    assert probe(restored) == want
    for a, b in zip(server._table, restored._table):
        assert torch.equal(a, b)

    inj = schaos.ChaosInjector(schaos.ChaosSchedule((schaos.crash(0),)))
    sup = ServeSupervisor(cfg, chaos=inj, device=cuda_device)
    sup.start()
    try:
        sup.submit(0).exception(timeout=60)     # trips the crash
        deadline = time.monotonic() + 60
        while sup.restarts == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert sup.restarts == 1
        fs = [sup.submit(t) for t in range(40)]
        got = [(d.lead_s, d.expected_s, d.entropy)
               for d in (f.result(timeout=60) for f in fs)]
    finally:
        sup.stop()
    assert got == want


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3])
def test_sharded_sweep_kernel_route_bitwise(cuda_device, k):
    """``run_grid`` of a faulty ASA-Naive grid (72 scenarios) over a
    ``scenarios`` mesh of k blocks on the card, through the kernel:
    bitwise the unsharded kernel run and the plain scan's run, metrics
    included; every block's launches ``fused``."""
    from repro_torch import convert
    from repro_torch.launch.mesh import ScenariosMesh
    from repro_torch.xsim import families
    from repro_torch.xsim import grid as grid_mod

    cfg = grid_mod.XSimConfig(**XSIM_CFG)
    grid = families.family_grid(cfg, "faulty", n_seeds=1, shrink=1 / 64.0,
                                policy_ids=(0, 1, 2, 3), device=cuda_device)
    want, m0 = grid_mod.run_grid(grid, pred_seed=7, device=cuda_device)
    plain, _ = grid_mod.run_grid(grid, pred_seed=7, freed_mode="ref",
                                 device=cuda_device)
    before = backfill.KERNEL_LAUNCHES["freed_scan"]
    fused = backfill.DESIGN_LAUNCHES["fused"]
    got, mk = grid_mod.run_grid(grid, pred_seed=7, device=cuda_device,
                                mesh=ScenariosMesh([cuda_device] * k))
    launched = backfill.KERNEL_LAUNCHES["freed_scan"] - before
    assert launched > 0
    assert backfill.DESIGN_LAUNCHES["fused"] - fused == launched
    g = convert.to_numpy(got)
    for other in (want, plain):
        o = convert.to_numpy(other)
        for f in g:
            assert torch.equal(torch.from_numpy(g[f]),
                               torch.from_numpy(o[f])), f
    for f in m0:
        assert torch.equal(m0[f], mk[f]), f


@pytest.mark.cuda
def test_sharded_serve_step_on_the_card_bitwise(cuda_device):
    """The decision step over 2 blocks on the card, 40 batches composed:
    the table (posteriors and keys) and the decisions bitwise the
    single-device step's."""
    from repro_torch.launch.mesh import ScenariosMesh
    from repro_torch.serve import asa as serve_asa

    mesh = ScenariosMesh([cuda_device] * 2)
    ref = sh = serve_asa.init_table(1536, device=cuda_device, seed=3)
    for _live, q, mask in _serve_batches(1536, 256, 40, seed=5):
        qd, md = serve_asa.query_to(q, mask, cuda_device)
        ref, dec_r = serve_asa.serve_step(ref, qd, md)
        sh, dec_s = serve_asa.serve_step(sh, qd, md, mesh=mesh)
        for a, b in zip(ref, serve_asa.first_replica(sh)):
            assert torch.equal(a, b)
        for a, b in zip(dec_r, dec_s):
            assert torch.equal(a, b)


# ------------------------------------------------------------- training


@pytest.mark.cuda
def test_kernels_refuse_autograd_on_the_card(cuda_device):
    """A kernel launched through ctypes has no backward: with grad mode on
    and an input that requires grad, each wrapper raises instead of
    returning an output autograd knows nothing of; under no_grad it
    launches."""
    g = torch.Generator(device=cuda_device).manual_seed(0)

    def rnd(*shape, dtype=torch.bfloat16, grad=False):
        x = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
        return x.requires_grad_(grad)

    q, k, v = (rnd(1, 128, 2, 64, grad=True) for _ in range(3))
    x, w = rnd(4, 16, 64), rnd(4, 64, 32, grad=True)
    r, kk, vv = (rnd(1, 64, 2, 64) for _ in range(3))
    decay = torch.rand((1, 64, 2, 64), generator=g, device=cuda_device)
    u = rnd(2, 64, dtype=torch.float32, grad=True)
    calls = (lambda: flash_ops.flash_attention(q, k, v),
             lambda: gmm_ops.grouped_matmul(x, w),
             lambda: gmm_ops.grouped_ffn(x, w, rnd(4, 64, 32),
                                         rnd(4, 32, 64)),
             lambda: wkv_ops.wkv6(r, kk, vv, 0.5 + 0.4 * decay, u,
                                  chunk=64))
    counts = (flash_ops.KERNEL_LAUNCHES, gmm_ops.KERNEL_LAUNCHES,
              gmm_ops.KERNEL_LAUNCHES, wkv_ops.KERNEL_LAUNCHES)
    for call, count in zip(calls, counts):
        before = sum(count.values())
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        assert sum(count.values()) == before
        with torch.no_grad():
            call()
        assert sum(count.values()) > before


def _reduced_f32(arch: str):
    import dataclasses

    from repro_torch.configs import ARCHS
    return dataclasses.replace(ARCHS[arch].reduced(), dtype="float32")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "moonshot-v1-16b-a3b",
                                  "rwkv6-3b", "zamba2-1.2b"])
def test_reduced_train_steps_on_the_card_match_the_cpu(cuda_device, arch):
    """Three float32 training steps on the card against the CPU route:
    losses within 1e-5 relative, parameters within 4e-5 (twice the sum of
    the first three learning rates, as tests/test_torch_train.py holds the
    CPU route against the reference)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import step as TS
    from repro_torch.train.data import make_batch_fn

    cfg = _reduced_f32(arch)
    base = OPT.tree_map(lambda p: p.float(),
                        TS.init_params(cfg, seed=2, device="cpu"))
    batch = make_batch_fn(cfg, ShapeSpec("t", 64, 4, "train"),
                          device="cpu")(0)
    runs = {}
    for dev in ("cpu", cuda_device):
        p = OPT.tree_map(lambda x: x.to(dev, copy=True), base)
        o = OPT.init(p)
        b = {k: x.to(dev) for k, x in batch.items()}
        step = TS.make_train_step(cfg, remat="none")
        losses = []
        for _ in range(3):
            p, o, m = step(p, o, b)
            losses.append(float(m["loss"]))
        runs[str(dev)] = (losses, OPT.leaves(p))
    (lc, pc), (lg, pg) = runs["cpu"], runs[str(cuda_device)]
    for a, b in zip(lg, lc):
        assert abs(a - b) <= 1e-5 * abs(b)
    for a, b in zip(pg, pc):
        assert float((a.cpu() - b).abs().max()) <= 4e-5


@pytest.mark.cuda
def test_train_step_through_the_kernels_raises_and_does_not_train(
        cuda_device):
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import step as TS
    from repro_torch.train.data import make_batch_fn

    cfg = ARCHS["qwen2-0.5b"].reduced()
    p = OPT.tree_map(lambda x: x.float(),
                     TS.init_params(cfg, seed=0, device=cuda_device))
    before = OPT.tree_map(lambda x: x.clone(), p)
    o = OPT.init(p)
    b = make_batch_fn(cfg, ShapeSpec("t", 64, 2, "train"),
                      device=cuda_device)(0)
    with pytest.raises(RuntimeError, match="no backward"):
        TS.make_train_step(cfg, use_flash=True, remat="none")(p, o, b)
    assert int(o.step) == 0
    assert all(torch.equal(x, y) for x, y in
               zip(OPT.leaves(p), OPT.leaves(before)))


@pytest.mark.cuda
def test_train_restart_on_the_card_is_exact(cuda_device, tmp_path):
    from repro_torch.launch.train import train

    run = dict(reduced=True, batch=2, seq=64, log_every=1,
               device=str(cuda_device))
    r1 = train("qwen2-0.5b", steps=6, **run)
    ck = str(tmp_path / "ck")
    train("qwen2-0.5b", steps=4, ckpt_dir=ck, ckpt_every=4, **run)
    r2 = train("qwen2-0.5b", steps=6, ckpt_dir=ck, ckpt_every=100, **run)
    assert r2["losses"] == r1["losses"][4:]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_prefill_through_flash_matches_its_twin_on_the_card(
        cuda_device, dtype):
    """The reduced model at 4 layers, a 48-token prompt: the block prefill
    through the flash kernel (one launch a shared-block invocation)
    against the same route with flash swapped for its plain version,
    logits and the state within the flash kernel's own limits (a few
    float32 or bfloat16 roundings), and the CPU route."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.models import zamba2 as TZ
    from repro_torch.train import optimizer as TO

    tcfg = dataclasses.replace(ARCHS["zamba2-1.2b"].reduced(), dtype=dtype,
                               n_layers=4)
    params = TZ.init_lm(tcfg, seed=0, device=cuda_device)
    toks = torch.randint(0, tcfg.vocab_size, (2, 48), device=cuda_device,
                         generator=torch.Generator(device=cuda_device)
                         .manual_seed(0))
    before = flash_ops.KERNEL_LAUNCHES["flash_attention"]
    got, gs = TZ.prefill(params, toks, tcfg, max_seq=60, use_kernels=True)
    assert flash_ops.KERNEL_LAUNCHES["flash_attention"] - before == 2
    kernel = flash_ops.flash_attention
    flash_ops.flash_attention = flash_ref.attention_ref
    try:
        want, ws = TZ.prefill(params, toks, tcfg, max_seq=60,
                              use_kernels=True)
    finally:
        flash_ops.flash_attention = kernel
    atol = 1e-4 if dtype == "float32" else 6e-2
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    for k in gs:
        torch.testing.assert_close(gs[k].float(), ws[k].float(),
                                   atol=atol * 10, rtol=0)
    cpu = TO.tree_map(lambda x: x.cpu(), params)
    on_cpu, _ = TZ.prefill(cpu, toks.cpu(), tcfg, max_seq=60)
    torch.testing.assert_close(got.float().cpu(), on_cpu.float(), atol=atol,
                               rtol=0)


@pytest.mark.cuda
def test_hybrid_train_step_through_flash_raises_on_the_card(cuda_device):
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.train import optimizer as TO
    from repro_torch.train import step as TS
    from repro_torch.train.data import make_batch_fn

    cfg = ARCHS["zamba2-1.2b"].reduced()
    p = TO.tree_map(lambda x: x.float(),
                    TS.init_params(cfg, seed=0, device=cuda_device))
    before = TO.tree_map(lambda x: x.clone(), p)
    o = TO.init(p)
    b = make_batch_fn(cfg, ShapeSpec("t", 32, 2, "train"),
                      device=cuda_device)(0)
    with pytest.raises(RuntimeError, match="no backward"):
        TS.make_train_step(cfg, use_flash=True, remat="none")(p, o, b)
    assert int(o.step) == 0
    assert all(torch.equal(x, y) for x, y in
               zip(TO.leaves(p), TO.leaves(before)))
    # under no_grad the same loss runs through the kernel
    with torch.no_grad():
        n0 = flash_ops.KERNEL_LAUNCHES["flash_attention"]
        loss = TS.model_loss(p, b, cfg, remat="none", use_flash=True)
        assert flash_ops.KERNEL_LAUNCHES["flash_attention"] - n0 == 1
        plain = TS.model_loss(p, b, cfg, remat="none")
    assert abs(float(loss) - float(plain)) <= 2 ** -9 * abs(float(plain))


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,causal", [(1500, 1500, False),
                                          (64, 64, True),
                                          (64, 1500, False)])
def test_flash_attention_kernel_at_whisper_shapes(cuda_device, sq, sk,
                                                  causal):
    """whisper-tiny's three prefill shapes at the served batch (16, 6
    heads of 64, bfloat16, the tensor-core design): the encoder's
    self-attention without a mask (1500 = 23 × 64 + 28: a ragged last key
    tile), the decoder's causal self-attention over a 64-token prompt,
    and its cross attention, 64 queries over 1500 keys."""
    q = _randn((16, sq, 6, 64), 0, cuda_device, torch.bfloat16)
    k, v = (_randn((16, sk, 6, 64), i, cuda_device, torch.bfloat16)
            for i in (1, 2))
    before = flash_ops.DESIGN_LAUNCHES["wgmma"]
    got = flash_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_ops.DESIGN_LAUNCHES["wgmma"] == before + 1
    want = flash_ref.attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=FLASH_ATOL[torch.bfloat16], rtol=0)
    _assert_rel_close(got, want, FLASH_REL)


def _whisper_cut(dtype: str, layers: int = 2):
    """whisper-tiny at its published width, both stacks cut to
    ``layers``."""
    import dataclasses

    from repro_torch.configs import ARCHS

    cfg = ARCHS["whisper-tiny"]
    return dataclasses.replace(
        cfg, dtype=dtype, n_layers=layers,
        encoder=dataclasses.replace(cfg.encoder, n_layers=layers))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_audio_prefill_through_flash_matches_its_twin_on_the_card(
        cuda_device, dtype):
    """whisper-tiny at published width, 2 + 2 layers, 1500 frames, a
    32-token prompt: the prefill through the flash kernel (one launch an
    attention: 2 in the encoder, 2 self and 2 cross in the decoder)
    against the same route with flash swapped for its plain version
    (logits and the cross K/V within the kernel's own limits, a few
    float32 or bfloat16 roundings), and the plain route on the CPU."""
    from repro_torch.models import encdec as TE
    from repro_torch.serve import step as tstep
    from repro_torch.train import optimizer as TO

    cfg = _whisper_cut(dtype)
    params = TE.init_lm(cfg, seed=0, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 32), device=cuda_device,
                         generator=gen)
    frames = torch.randn((2, cfg.encoder.n_frames, cfg.d_model),
                         device=cuda_device, generator=gen).to(
                             params["enc_pos"].dtype)
    prefill = tstep.make_prefill_step(cfg, use_kernels=True)
    before = flash_ops.KERNEL_LAUNCHES["flash_attention"]
    got, gk = prefill(params, toks, frames)
    assert flash_ops.KERNEL_LAUNCHES["flash_attention"] - before == 6
    kernel = flash_ops.flash_attention
    flash_ops.flash_attention = flash_ref.attention_ref
    try:
        want, wk = prefill(params, toks, frames)
    finally:
        flash_ops.flash_attention = kernel
    atol = 1e-4 if dtype == "float32" else 6e-2
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    for k in gk:
        torch.testing.assert_close(gk[k].float(), wk[k].float(),
                                   atol=atol * 10, rtol=0)
    cpu = TO.tree_map(lambda x: x.cpu(), params)
    on_cpu, _ = tstep.make_prefill_step(cfg)(cpu, toks.cpu(), frames.cpu())
    torch.testing.assert_close(got.float().cpu(), on_cpu.float(), atol=atol,
                               rtol=0)


@pytest.mark.cuda
def test_audio_train_step_through_flash_raises_on_the_card(cuda_device):
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.train import optimizer as TO
    from repro_torch.train import step as TS
    from repro_torch.train.data import make_batch_fn

    cfg = ARCHS["whisper-tiny"].reduced()
    p = TO.tree_map(lambda x: x.float(),
                    TS.init_params(cfg, seed=0, device=cuda_device))
    o = TO.init(p)
    b = make_batch_fn(cfg, ShapeSpec("t", 32, 2, "train"),
                      device=cuda_device)(0)
    assert b["frames"].is_cuda
    with pytest.raises(RuntimeError, match="no backward"):
        TS.make_train_step(cfg, use_flash=True, remat="none")(p, o, b)
    assert int(o.step) == 0
    with torch.no_grad():
        n0 = flash_ops.KERNEL_LAUNCHES["flash_attention"]
        loss = TS.model_loss(p, b, cfg, remat="none", use_flash=True)
        assert flash_ops.KERNEL_LAUNCHES["flash_attention"] - n0 == \
            cfg.encoder.n_layers + 2 * cfg.n_layers
        plain = TS.model_loss(p, b, cfg, remat="none")
    assert abs(float(loss) - float(plain)) <= 2 ** -9 * abs(float(plain))


@pytest.mark.cuda
def test_freed_kernel_mode_end_to_end_bitwise_plain(cuda_device):
    """The reference's ``test_pallas_freed_mode_end_to_end`` on the card:
    statistics at scale 28 under per-stage on a 100-core machine, 40
    steps through the ``freed_scan`` kernel (``freed_mode="kernel"``, the
    ``fused`` design) bitwise the plain sorted scan's run."""
    from repro_torch.sched.workflows import STATISTICS
    from repro_torch.xsim import events, policies
    from repro_torch.xsim import state as X

    t = X.empty_table(16)
    policies.add_workflow(t, 0, STATISTICS, 28, X.PER_STAGE, t0=0.0)
    st = X.freeze(t, policy=X.PER_STAGE, total_cores=100.0,
                  free_cores=100.0, device=cuda_device)
    before = dict(backfill.DESIGN_LAUNCHES)
    a = events.simulate(st, n_steps=40, freed_mode="ref")
    b = events.simulate(st, n_steps=40, freed_mode="kernel")
    assert backfill.DESIGN_LAUNCHES["fused"] > before["fused"]
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        elif x is not None:
            for xx, yy in zip(x, y):
                assert torch.equal(xx, yy)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_audio_frames_on_the_card_equal_the_cpu_route(cuda_device, dtype):
    """The ``audio`` batches' frames (``prng.normal`` in the activation
    type: XLA's erfinv polynomial, float64 log1p, sqrt and multiply-adds
    rounded once) drawn on the card bitwise the CPU route's, with the
    tokens and labels, at whisper-tiny's published frame shape."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.train.data import make_batch_fn

    cfg = dataclasses.replace(ARCHS["whisper-tiny"], dtype=dtype)
    shape = ShapeSpec("t", 64, 4, "train")
    got = make_batch_fn(cfg, shape, seed=3, device=cuda_device)(5)
    want = make_batch_fn(cfg, shape, seed=3, device="cpu")(5)
    assert got["frames"].shape == (4, 1500, 384)
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1032, 2048])
def test_flash_attention_kernel_at_pixtral_shapes(cuda_device, s):
    """pixtral-12b's prefill attention (bfloat16, 32 heads of 128, the KV
    heads expanded, causal, the tensor-core design) at the served route's
    8 patches and 1024 prompt tokens (1032 = 16 × 64 + 8: a ragged last
    tile) and at the config's 1024 patches and 1024 tokens."""
    q = _randn((4, s, 32, 128), 0, cuda_device, torch.bfloat16)
    k, v = (_randn((4, s, 32, 128), i, cuda_device, torch.bfloat16)
            for i in (1, 2))
    before = flash_ops.DESIGN_LAUNCHES["wgmma"]
    got = flash_ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_ops.DESIGN_LAUNCHES["wgmma"] == before + 1
    want = flash_ref.attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=FLASH_ATOL[torch.bfloat16], rtol=0)
    _assert_rel_close(got, want, FLASH_REL)


def _pixtral_cut(dtype: str, layers: int = 2):
    import dataclasses

    from repro_torch.configs import ARCHS

    return dataclasses.replace(ARCHS["pixtral-12b"], dtype=dtype,
                               n_layers=layers)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vlm_prefill_through_flash_matches_its_twin_on_the_card(
        cuda_device, dtype):
    """pixtral-12b at published width, 2 layers, 8 patches and a 56-token
    prompt: the prefill through the flash kernel (one launch a layer, over
    all 64 rows) against the same route with flash swapped for its plain
    version, and the plain route on the CPU."""
    from repro_torch.models import transformer as TT
    from repro_torch.models.lm import act_dtype
    from repro_torch.serve import step as tstep
    from repro_torch.train import optimizer as TO

    cfg = _pixtral_cut(dtype)
    params = TT.init_lm(cfg, seed=0, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 56), device=cuda_device,
                         generator=gen)
    patches = torch.randn((2, 8, cfg.d_model), device=cuda_device,
                          generator=gen).to(act_dtype(cfg))
    prefill = tstep.make_prefill_step(cfg, use_kernels=True)
    before = flash_ops.KERNEL_LAUNCHES["flash_attention"]
    got, _ = prefill(params, toks, patches)
    assert flash_ops.KERNEL_LAUNCHES["flash_attention"] - before == 2
    kernel = flash_ops.flash_attention
    flash_ops.flash_attention = flash_ref.attention_ref
    try:
        want, _ = prefill(params, toks, patches)
    finally:
        flash_ops.flash_attention = kernel
    atol = 1e-4 if dtype == "float32" else 6e-2
    scale = float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), atol=atol * scale,
                               rtol=0)
    cpu = TO.tree_map(lambda x: x.cpu(), params)
    on_cpu, _ = tstep.make_prefill_step(cfg)(cpu, toks.cpu(), patches.cpu())
    torch.testing.assert_close(got.float().cpu(), on_cpu.float(),
                               atol=atol * scale, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_vlm_patch_embeds_on_the_card_equal_the_cpu_route(cuda_device,
                                                          dtype):
    """The ``vlm`` batches' patch embeddings drawn on the card bitwise the
    CPU route's, with the tokens and labels, at pixtral-12b's 1024
    patches of width 5120."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.train.data import make_batch_fn

    cfg = _pixtral_cut(dtype)
    shape = ShapeSpec("t", 32, 2, "train")
    got = make_batch_fn(cfg, shape, seed=3, device=cuda_device)(5)
    want = make_batch_fn(cfg, shape, seed=3, device="cpu")(5)
    assert got["patch_embeds"].shape == (2, 1024, 5120)
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k


@pytest.mark.cuda
def test_xla_f32_on_the_card_equals_the_cpu(cuda_device):
    """``core.xla_f32``'s exp, log, sum and logsumexp on the card bit for
    bit the CPU's (which tests/test_torch_xla_f32.py holds to jax's), on
    the estimator's ranges, every 32-bit pattern's kind and edge cases."""
    from repro_torch.core import xla_f32

    gen = torch.Generator().manual_seed(0)
    n = 1 << 20
    draws = {
        "exp": torch.cat([torch.rand(n, generator=gen) * 88.0 - 87.0,
                          torch.rand(n, generator=gen) * 210.0 - 110.0]),
        "log": torch.exp(torch.rand(n, generator=gen) * 24.0 - 10.0),
        "bits": torch.randint(-2 ** 31, 2 ** 31, (n,), generator=gen,
                              dtype=torch.int64).to(torch.int32).view(
                                  torch.float32),
        "edges": torch.tensor([0.0, -0.0, 1e-40, -1e-40, 1.17549435e-38,
                               -87.8, -87.34, 88.72, 88.8, 1.0, 53.0,
                               float("inf"), float("-inf"), float("nan")]),
    }
    for name, x in draws.items():
        for fn in (xla_f32.exp, xla_f32.log):
            got, want = fn(x.to(cuda_device)).cpu(), fn(x)
            same = (got.view(torch.int32) == want.view(torch.int32)) | (
                torch.isnan(got) & torch.isnan(want))
            assert bool(same.all()), (name, fn.__name__)
    rows = torch.randn((4096, 53), generator=gen) * 10.0
    rows[:, 3] = rows[:, 5]
    for fn in (lambda t: xla_f32.sum(xla_f32.exp(t), -1),
               lambda t: xla_f32.logsumexp(t, -1, keepdim=True)):
        assert torch.equal(fn(rows.to(cuda_device)).cpu(), fn(rows))


@pytest.mark.cuda
def test_log1p_draws_and_grid_on_the_card_equal_the_cpu(cuda_device):
    """``xla_f32.log1p`` and ``cumsum``, ``prng.normal``,
    ``normal_affine`` and ``exponential``, and a grid's built tables on the
    card, bit for bit the CPU's (which tests/test_torch_xla_f32.py,
    tests/test_torch_prng.py and tests/test_torch_xsim.py hold to jax's)."""
    from repro_torch.core import prng, xla_f32
    from repro_torch.xsim import grid as grid_mod
    from repro_torch.xsim import policies

    gen = torch.Generator().manual_seed(1)
    n = 1 << 20
    x = torch.cat([
        torch.randint(-2 ** 31, 2 ** 31, (n,), generator=gen,
                      dtype=torch.int64).to(torch.int32).view(torch.float32),
        -torch.rand(n, generator=gen),
        (torch.rand(n, generator=gen) - 0.5) * 0.83,
        torch.tensor([0.0, -0.0, -1.0, 1e-40, -1e-40, 0.41421354,
                      0.41421357, -0.41421357, float("inf"),
                      float("-inf"), float("nan")])])
    got, want = xla_f32.log1p(x.to(cuda_device)).cpu(), xla_f32.log1p(x)
    same = (got.view(torch.int32) == want.view(torch.int32)) | (
        torch.isnan(got) & torch.isnan(want))
    assert bool(same.all())
    rows = torch.rand((64, 1024), generator=gen) * 100.0
    assert torch.equal(xla_f32.cumsum(rows.to(cuda_device), 1).cpu(),
                       xla_f32.cumsum(rows, 1))
    for draw in (prng.normal, prng.exponential):
        assert torch.equal(
            draw(prng.PRNGKey(3).to(cuda_device), (1 << 18,)).cpu(),
            draw(prng.PRNGKey(3), (1 << 18,))), draw.__name__
    loc, scale = torch.tensor([[5.1], [1.5]]), torch.tensor([[1.3], [2.9]])
    keys = torch.stack([prng.PRNGKey(1), prng.PRNGKey(2)])
    assert torch.equal(
        prng.normal_affine(keys.to(cuda_device), (4096,),
                           loc.to(cuda_device), scale.to(cuda_device)).cpu(),
        prng.normal_affine(keys, (4096,), loc, scale))
    cfg = grid_mod.XSimConfig(n_warm=16, n_backlog=12, n_arrivals=40,
                              max_stages=9, t0=1800.0)
    built = {}
    for dev in ("cpu", cuda_device):
        g = grid_mod.make_grid(cfg, n_seeds=1, shrink=1 / 64.0,
                               policy_ids=(0, 1, 2), device=dev)
        fleet = policies.init_fleet(int(g.geo_idx.max()) + 1, device=dev)
        built[str(dev)] = g.build(policies.scenario_estimators(
            fleet, torch.as_tensor(g.geo_idx, device=dev), 1))
    for f in ("submit", "cores", "duration", "end", "pilot_waste_cs"):
        assert torch.equal(getattr(built[str(cuda_device)], f).cpu(),
                           getattr(built["cpu"], f)), f


def _card_mesh(cuda_device, data: int, model: int):
    import numpy as np

    from repro_torch.launch.mesh import DeviceMesh

    grid = np.empty((data, model), dtype=object)
    grid.fill(torch.device(cuda_device.type, cuda_device.index or 0))
    return DeviceMesh(grid, ("data", "model"))


@pytest.mark.cuda
@pytest.mark.parametrize("data,model", [(2, 2), (1, 2), (4, 1)])
def test_split_train_step_on_the_card_is_the_accum_step(cuda_device, data,
                                                        model):
    """Two steps of the reduced qwen2-0.5b and moonshot over a (data,
    model) mesh of the one card against ``make_train_step(accum=data)``
    on the card from the same state: bitwise on (4, 1); where the mesh
    splits each layer's compute over ``model`` (which adds the positions'
    partial sums), in float32, the losses within 3 float32 steps and the
    parameters within 1.4e-7 (tests/test_torch_train_model_split.py's
    limits on the CPU)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.parallel.sharding import (ShardedTensor, ShardingRules,
                                               gather_tree, place)
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import step as TS
    from repro_torch.train.data import make_batch_fn

    mesh = _card_mesh(cuda_device, data, model)
    for arch in ("qwen2-0.5b", "moonshot-v1-16b-a3b"):
        cfg = ARCHS[arch].reduced()
        p0 = OPT.tree_map(lambda p: p.float(),
                          TS.init_params(cfg, seed=2, device=mesh.device))
        if model > 1:
            cfg = dataclasses.replace(cfg, dtype="float32")
        ref_p = OPT.tree_map(lambda p: p.clone(), p0)
        ref_o = OPT.init(ref_p)
        sp = place(OPT.tree_map(lambda p: p.clone(), p0),
                   ShardingRules(mesh).tree_shardings(p0))
        so = OPT.init(sp)
        assert any(isinstance(x, ShardedTensor) for x in OPT.leaves(sp))
        step = TS.make_train_step(cfg, accum=data, remat="none")
        sstep = TS.make_train_step(cfg, remat="none")
        batch_fn = make_batch_fn(cfg, ShapeSpec("t", 64, 4, "train"),
                                 device=mesh.device)
        for i in range(2):
            b = batch_fn(i)
            ref_p, ref_o, rm = step(ref_p, ref_o, b)
            sp, so, sm = sstep(sp, so, b)
            if model == 1:
                assert torch.equal(rm["loss"], sm["loss"]), arch
            else:
                ulps = abs(float(rm["loss"]) - float(sm["loss"])) / float(
                    np.spacing(np.float32(abs(float(rm["loss"])))))
                assert ulps <= 3, (arch, rm["loss"], sm["loss"])
        if model > 1:
            worst = max(float((a - b).abs().max()) for a, b in zip(
                OPT.leaves(gather_tree(sp)), OPT.leaves(ref_p)))
            assert worst <= 1.4e-7, (arch, worst)
            continue
        for got, want in ((sp, ref_p), (so.m, ref_o.m), (so.v, ref_o.v)):
            assert all(torch.equal(a, b) for a, b in zip(
                OPT.leaves(gather_tree(got)), OPT.leaves(want))), arch


@pytest.mark.cuda
def test_elastic_restart_and_resize_on_the_card(cuda_device, tmp_path):
    """``launch.train`` saved on a (2, 2) mesh of the card, resumed on
    (4, 1): bitwise the ``accum=4`` steps from the restored checkpoint;
    ``apply_resize`` (2, 2) → (4, 1) moves every shard bitwise."""
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.train import train
    from repro_torch.parallel.sharding import (ShardedTensor, ShardingRules,
                                               place)
    from repro_torch.runtime import checkpoint as CKPT
    from repro_torch.runtime.elastic import apply_resize
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import step as TS
    from repro_torch.train.data import make_batch_fn

    run = dict(reduced=True, batch=4, seq=64, log_every=1,
               device=str(cuda_device))
    ck = tmp_path / "ck"
    train("qwen2-0.5b", steps=2, ckpt_dir=str(ck), ckpt_every=2,
          mesh=_card_mesh(cuda_device, 2, 2), **run)
    got = train("qwen2-0.5b", steps=4, ckpt_dir=str(ck), ckpt_every=100,
                mesh=_card_mesh(cuda_device, 4, 1), **run)
    cfg = ARCHS["qwen2-0.5b"].reduced()
    p = OPT.tree_map(lambda x: x.float(),
                     TS.init_params(cfg, device=cuda_device))
    o = OPT.init(p)
    state = CKPT.restore({"params": p, "m": o.m, "v": o.v, "step": o.step},
                         ck, 2, device=cuda_device)
    p, o = state["params"], OPT.AdamWState(state["step"], state["m"],
                                           state["v"])
    step = TS.make_train_step(cfg, accum=4, remat="none")
    batch_fn = make_batch_fn(cfg, ShapeSpec("custom", 64, 4, "train"),
                             device=cuda_device)
    want = []
    for s in (2, 3):
        p, o, m = step(p, o, batch_fn(s))
        want.append((s, float(m["loss"])))
    assert got["losses"] == want
    old, new = _card_mesh(cuda_device, 2, 2), _card_mesh(cuda_device, 4, 1)
    placed = place(p, ShardingRules(old).tree_shardings(p))
    moved = apply_resize(placed, new, ShardingRules(new))
    for x, whole in zip(OPT.leaves(moved), OPT.leaves(p)):
        if isinstance(x, ShardedTensor):
            assert all(torch.equal(s, whole[i])
                       for i, s in zip(x.indices, x.shards))
        else:
            assert torch.equal(x, whole)

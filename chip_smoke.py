"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds every hand-written kernel of the port from the sources in the
checkout, holds each kernel against its plain PyTorch version on the
card, drives the port's main path (the fleet simulator's Table-1 sweep),
and checks the results. Phases:

1. the card (``nvidia-smi`` name and power limit) and the kernel build;
2. each kernel against its plain version at the shapes the sweep uses,
   bitwise, with its time, the plain version's time and its bound;
3. the Table-1 path at the repository's own benchmark setting
   (``benchmarks/run.py``'s xsim leg: 1/64-size centers, policies 0-2,
   warmed fleet), once through the kernel and once through the plain
   reservation scan: the final states must be bitwise identical;
4. the main path at full size: both centers at their real core counts,
   their three paper scales, three workflows, policies 0-2, two seeds
   (108 scenarios of 2313 job slots), through the user-facing entry
   points; the kernel's launches in this run are counted.

The second-to-last line is a JSON object with one entry per ported
kernel; the last line is ``{"ok": true, "device": {...}}``. Any failure
raises and ends the script with a non-zero exit code; without a CUDA
device it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12      # float32 outside the tensor cores

# the port's kernels: name -> source, the TPU kernel it replaces
KERNELS = {
    "freed_scan": dict(route="cuda",
                       source="src/repro_torch/csrc/freed_scan.cu",
                       replaces="src/repro/xsim/backfill.py:124"),
}

# phase 2 shapes: (B, N) of the repository's grids — the throughput grid
# (53 slots), the run.py Table-1 grid (73), the default config (153) and
# the full-size grid of phase 4 (2313)
CHECK_SHAPES = ((1026, 53), (1026, 73), (1026, 153), (108, 2313))

FULL_CUTS = (
    "background arrivals stop after 1024 slots (about 4.8 h of HPC2N "
    "traffic, about 26 h of UPPMAX traffic)",
    "two seeds per cell",
    "policies 0-2 only (bigjob, per_stage, asa)",
    "cold estimators (no warm_fleet rounds before the full-size sweep)",
)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def freed_bound_ms(b: int, n: int) -> tuple[float, str]:
    """Least time for ``freed_matrix`` on a (b, n) table: read ends and
    cores (f32) and the running mask (bool) once, write freed (f32) once;
    the sort and scan do about n·(log2 n + 3) float32 operations a row."""
    bytes_ms = b * n * (4 + 4 + 1 + 4) / H100_BYTES_PER_S * 1e3
    ops = b * n * (math.ceil(math.log2(max(n, 2))) + 3)
    ops_ms = ops / H100_F32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                          "operations")


def random_tables(b: int, n: int, gen: torch.Generator, dev):
    """Tables from a seed: forced end-time ties, a mix of running and
    non-running rows, one all-idle row, integer core counts."""
    ends = torch.rand(b, n, generator=gen) * 1e4
    ends[:, ::4] = 5000.0
    cores = torch.randint(1, 64, (b, n), generator=gen).float()
    running = torch.rand(b, n, generator=gen) < 0.6
    running[0] = False
    return ends.to(dev), cores.to(dev), running.to(dev)


def kernel_vs_plain(backfill, dev) -> dict:
    """Phase 2: freed_matrix (sort + freed_scan kernel) against the plain
    ``_freed_sorted`` at every shape; returns the per-shape results."""
    gen = torch.Generator().manual_seed(11)
    rows = {}
    for b, n in CHECK_SHAPES:
        e, c, r = random_tables(b, n, gen, dev)
        got = backfill.freed_vector(e, c, r, mode="kernel")
        want = backfill._freed_sorted(e, c, r)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.equal(got, want),
              f"freed_scan != _freed_sorted at {(b, n)} (max err {err})")
        ms = cuda_ms(lambda: backfill.freed_vector(e, c, r, mode="kernel"))
        plain_ms = cuda_ms(lambda: backfill._freed_sorted(e, c, r))
        bound, by = freed_bound_ms(b, n)
        # the kernel alone on pre-sorted rows: 20 B a slot (sorted ends and
        # cores, the int64 order, freed)
        em, cm = backfill._masked(e, c, r)
        e_s, order = torch.sort(em, dim=1, stable=True)
        c_s = torch.gather(cm, 1, order)
        scan_ms = cuda_ms(lambda: backfill.freed_scan(e_s, c_s, order))
        scan_bound = b * n * 20 / H100_BYTES_PER_S * 1e3
        rows[(b, n)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound, bound_by=by, scan_ms=scan_ms,
                            scan_bound_ms=scan_bound)
        print(f"kernel/freed_scan B={b} N={n}: bitwise=True "
              f"ms={ms:.6f} plain_ms={plain_ms:.6f} bound_ms={bound:.6f} "
              f"({by}) scan_only_ms={scan_ms:.6f} "
              f"scan_bound_ms={scan_bound:.6f}")
    return rows


def strategy_rows(grid, m: dict) -> None:
    by: dict[str, list[int]] = {}
    for i, lab in enumerate(grid.labels):
        by.setdefault(lab["strategy"], []).append(i)
    for strat, idx in sorted(by.items()):
        vals = {k: float(np.mean(m[k][idx])) for k in
                ("twt_s", "makespan_s", "core_hours", "oh_hours")}
        print(f"table1/{strat}: n={len(idx)} " + " ".join(
            f"{k}={v:.6f}" for k, v in vals.items()))
    frac = float(m["wf_done"].sum() / m["wf_total"].sum())
    print(f"table1/wf_done_frac={frac:.6f}")


def states_equal(a, b) -> bool:
    from repro_torch import convert

    x, y = convert.to_numpy(a), convert.to_numpy(b)
    return x.keys() == y.keys() and all(
        np.array_equal(x[k], y[k]) for k in x)


def table1_setting(grid_mod, policies, backfill, dev) -> None:
    """Phase 3: ``benchmarks/run.py``'s xsim leg on the port, kernel path
    and plain path, bitwise; the kernel path must launch the kernel and
    the plain path must not."""
    cfg = grid_mod.XSimConfig(n_warm=24, n_backlog=16, n_arrivals=24,
                              max_stages=9, t0=3600.0)
    grid = grid_mod.make_grid(cfg, n_seeds=4, shrink=1 / 64.0,
                              policy_ids=(0, 1, 2), device=dev)
    fleet = policies.init_fleet(int(grid.geo_idx.max()) + 1, device=dev)
    t0 = time.perf_counter()
    fleet = grid_mod.warm_fleet(fleet, grid, rounds=3, device=dev)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    backfill.KERNEL_LAUNCHES["freed_scan"] = 0
    t0 = time.perf_counter()
    fin_k, m_k = grid_mod.run_grid(grid, fleet, pred_seed=7, device=dev)
    torch.cuda.synchronize()
    kern_s = time.perf_counter() - t0
    kern_launches = backfill.KERNEL_LAUNCHES["freed_scan"]
    backfill.KERNEL_LAUNCHES["freed_scan"] = 0
    t0 = time.perf_counter()
    fin_r, _ = grid_mod.run_grid(grid, fleet, pred_seed=7, freed_mode="ref",
                                 device=dev)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    check(kern_launches > 0 and backfill.KERNEL_LAUNCHES["freed_scan"] == 0,
          f"Table-1 launches: kernel path {kern_launches}, plain path "
          f"{backfill.KERNEL_LAUNCHES['freed_scan']}")
    check(states_equal(fin_k, fin_r),
          "Table-1 sweep: kernel path and plain path differ")
    m = {k: v.cpu().numpy() for k, v in m_k.items()}
    for k in ("twt_s", "makespan_s", "core_hours"):
        check(m[k].shape == (grid.n,) and bool(np.all(np.isfinite(m[k]))),
              f"Table-1 metric {k} not finite of shape ({grid.n},)")
    print(f"table1: B={grid.n} N={cfg.max_jobs} n_steps={cfg.n_steps} "
          f"warm_fleet_s={warm_s:.3f} kernel_path_s={kern_s:.3f} "
          f"plain_path_s={ref_s:.3f} bitwise_equal=True "
          f"freed_scan_launches={kern_launches}")
    strategy_rows(grid, m)


def full_size(grid_mod, policies, backfill, dev, RUNNING) -> dict:
    """Phase 4: the main path at full size; returns its numbers and the
    kernel launch counts of its first run."""
    cfg = grid_mod.XSimConfig(n_warm=512, n_backlog=768, n_arrivals=1024,
                              max_stages=9)
    grid = grid_mod.make_grid(cfg, shrink=1.0, policy_ids=(0, 1, 2),
                              n_seeds=2, device=dev)
    check(grid.n == 108 and cfg.max_jobs == 2313,
          f"full-size grid is {grid.n} x {cfg.max_jobs}")
    fleet = policies.init_fleet(int(grid.geo_idx.max()) + 1, device=dev)
    # the kernel's inputs at the sweep's first scheduling pass
    s0 = grid.build(policies.scenario_estimators(
        fleet, torch.as_tensor(grid.geo_idx, device=dev), 1))
    first_inputs = (s0.end, s0.cores, s0.status == RUNNING)

    torch.cuda.reset_peak_memory_stats()
    for k in backfill.KERNEL_LAUNCHES:
        backfill.KERNEL_LAUNCHES[k] = 0
    t0 = time.perf_counter()
    final, m = grid_mod.run_grid(grid, fleet, device=dev)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(backfill.KERNEL_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    t0 = time.perf_counter()
    final2, _ = grid_mod.run_grid(grid, fleet, device=dev)
    torch.cuda.synchronize()
    steady_s = time.perf_counter() - t0
    check(states_equal(final, final2), "full-size sweep is not repeatable")

    m = {k: v.cpu().numpy() for k, v in m.items()}
    steps = final.steps.cpu().numpy()
    frac = float(m["wf_done"].sum() / m["wf_total"].sum())
    for k in ("twt_s", "makespan_s", "core_hours"):
        fin = np.isfinite(m[k])
        check(m[k].shape == (grid.n,), f"full-size metric {k} shape")
        check(bool(np.all(fin | (m["wf_done"] < m["wf_total"]))),
              f"full-size metric {k} not finite for a finished scenario")
    total_cores = sorted({float(x) for x in
                          grid.centers.total_cores.cpu().numpy()})
    print(f"full: B={grid.n} N={cfg.max_jobs} centers_cores={total_cores} "
          f"n_steps_budget={cfg.n_steps} steps_max={int(steps.max())} "
          f"steps_mean={float(steps.mean()):.3f} "
          f"first_run_s={first_s:.6f} steady_s={steady_s:.6f} "
          f"scenarios_per_s={grid.n / steady_s:.6f} "
          f"wf_done_frac={frac:.6f} "
          f"freed_scan_launches={launches['freed_scan']} "
          f"peak_mem_bytes={peak}")
    for cut in FULL_CUTS:
        print(f"full/cut: {cut}")
    strategy_rows(grid, m)
    check(launches["freed_scan"] > 0,
          "the main path never launched freed_scan")
    return dict(launches=launches, inputs=first_inputs, state=s0)


def profile_window(events_mod, state, n_steps: int = 16) -> None:
    """Device busy and idle share over a short window of full-size event
    steps, and the kernels that took the device's time (torch.profiler;
    prints "not measured" if the trace holds no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run():
        return events_mod.simulate(state, n_steps=n_steps, chunk_steps=0,
                                   pred_mode="greedy")

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only (kernels, copies): the CPU-side aten rows
    # carry their kernels' time too and would count it twice
    rows = [(ev.self_device_time_total, ev.key, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    busy_us = sum(r[0] for r in rows)
    if busy_us <= 0:
        print(f"profile: {n_steps} steps wall_us={wall_us:.3f} device "
              f"time not measured (the trace holds no device events)")
        return
    launches = sum(r[2] for r in rows)
    print(f"profile: {n_steps} full-size steps wall_us={wall_us:.3f} "
          f"device_busy_us={busy_us:.3f} "
          f"idle_share={1.0 - busy_us / wall_us:.6f} "
          f"device_launches={launches} "
          f"launches_per_step={launches / n_steps:.1f}")
    for dev, key, count in sorted(rows, reverse=True)[:8]:
        print(f"profile/top: {dev:.3f} us x{count} {key[:90]}")
    scan = [r for r in rows if "freed_scan" in r[1]]
    scan_us = sum(r[0] for r in scan)
    print(f"profile/freed_scan: {scan_us:.3f} us x{sum(r[2] for r in scan)} "
          f"= {scan_us / busy_us:.6f} of device busy time")


def main() -> None:
    if not (SRC / "repro_torch").is_dir():
        fail(f"no port package under {SRC}: run from a checkout")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a GPU")
    sys.path.insert(0, str(SRC))
    from repro_torch import cuda_build
    from repro_torch.xsim import backfill, policies
    from repro_torch.xsim import grid as grid_mod
    from repro_torch.xsim.state import RUNNING

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # phase 1: build every kernel, one nvcc per source, in parallel
    t0 = time.perf_counter()
    cuda_build.build(list(KERNELS))
    print(f"build: {sorted(KERNELS)} in {time.perf_counter() - t0:.3f} s")
    for name in KERNELS:
        for line in cuda_build.BUILD_INFO[name]["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"build/{name}: {line.strip()}")

    # phase 2: kernels against their plain versions
    checks = kernel_vs_plain(backfill, dev)

    # phase 3: the repository's Table-1 setting, kernel vs plain path
    table1_setting(grid_mod, policies, backfill, dev)

    # phase 4: the main path at full size (counts reset just before it)
    full = full_size(grid_mod, policies, backfill, dev, RUNNING)

    # where a full-size step's time goes (a short profiled window)
    from repro_torch.xsim import events as events_mod
    profile_window(events_mod, full["state"])

    # the kernel at the main path's own inputs (its first pass)
    e, c, r = full["inputs"]
    got = backfill.freed_vector(e, c, r, mode="kernel")
    want = backfill._freed_sorted(e, c, r)
    check(torch.equal(got, want), "freed_scan differs on the sweep's input")
    b, n = e.shape
    ms = cuda_ms(lambda: backfill.freed_vector(e, c, r, mode="kernel"))
    plain_ms = cuda_ms(lambda: backfill._freed_sorted(e, c, r))
    bound, by = freed_bound_ms(b, n)
    err = max([float((got - want).abs().max())]
              + [v["max_abs_err"] for v in checks.values()])
    print(f"kernel/freed_scan main-path input B={b} N={n} "
          f"running={int(r.sum())}: ms={ms:.6f} plain_ms={plain_ms:.6f} "
          f"bound_ms={bound:.6f} ({by})")
    entry = dict(name="freed_scan", **KERNELS["freed_scan"],
                 launches=full["launches"]["freed_scan"], max_abs_err=err,
                 ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                 library_ms=None, max_abs_diff_vs_plain=err, kernel_ms=ms,
                 shapes={f"{bb}x{nn}": v for (bb, nn), v in checks.items()})
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

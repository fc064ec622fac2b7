"""Compare source trees of the port on the fleet sweep, where the
reservation scan (``freed_matrix``) runs once a scheduling pass.

Each tree (a directory holding ``repro_torch``) runs in its own process,
in the order given, so that two commits are compared on one card in
turns (parent, change, change, parent):

    python scripts/freed_sweep_ab.py _archive/parent/src src src \\
        _archive/parent/src

For each tree it prints one line:

- the full-size grid's first 16 event steps (108 scenarios of 2313 job
  slots, as ``chip_smoke.py`` phase 4 builds it, from t = 0): wall ms a
  step without the profiler (the median of five runs after a warm-up),
  and under ``torch.profiler`` the device launches a step, device busy
  ms a step and wall ms a step;
- the whole full-size sweep (``run_grid``, once): wall s, scenarios/s
  and the scan's launches;
- the Table-1 setting's wall s (``chip_smoke.py`` phase 3: 216
  scenarios of 73 slots after three warm-fleet rounds; ``run_grid``
  through the kernel, the median of three runs);
- ``freed_matrix`` on the full-size grid's first scheduling input: the
  CUDA-event mean a call, and the device us and launches a call by the
  profiler.

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time

STEPS = 16


def one(tree: str) -> None:
    sys.path.insert(0, tree)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.xsim import backfill, events, policies
    from repro_torch.xsim import grid as grid_mod
    from repro_torch.xsim.state import RUNNING

    dev = torch.device("cuda")

    def profiled(fn, calls: int = 1):
        """(device busy us, launches, wall us) over ``calls`` calls."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e6
        rows = [(ev.self_device_time_total, ev.count)
                for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA
                and ev.self_device_time_total > 0]
        return (sum(r[0] for r in rows), sum(r[1] for r in rows), wall)

    def wall_s(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    # the full-size grid, as chip_smoke.py phase 4 builds it
    cfg = grid_mod.XSimConfig(n_warm=512, n_backlog=768, n_arrivals=1024,
                              max_stages=9)
    grid = grid_mod.make_grid(cfg, shrink=1.0, policy_ids=(0, 1, 2),
                              n_seeds=2, device=dev)
    fleet = policies.init_fleet(int(grid.geo_idx.max()) + 1, device=dev)
    s0 = grid.build(policies.scenario_estimators(
        fleet, torch.as_tensor(grid.geo_idx, device=dev), 1))
    window = lambda: events.simulate(  # noqa: E731
        s0, n_steps=STEPS, chunk_steps=0, pred_mode="greedy")
    window()
    walls = [wall_s(window) * 1e3 / STEPS for _ in range(5)]
    busy, launches, pwall = profiled(window)
    before = backfill.KERNEL_LAUNCHES["freed_scan"]
    sweep_s = wall_s(lambda: grid_mod.run_grid(grid, fleet, device=dev))
    sweep_launches = backfill.KERNEL_LAUNCHES["freed_scan"] - before

    # the reservation scan on the grid's first scheduling input; the trace
    # can lose some launches of a window, so one that kept no whole number
    # of launches a call is taken again (up to four times) and the last is
    # scaled to the nearest whole number
    e, c, r = s0.end, s0.cores, s0.status == RUNNING
    scan = lambda: backfill.freed_vector(e, c, r, mode="kernel")  # noqa
    for _ in range(4):
        scan_busy, scan_launches, _ = profiled(scan, calls=20)
        if scan_launches and scan_launches % 20 == 0:
            break
    if scan_launches:
        whole = max(1, round(scan_launches / 20)) * 20
        scan_busy, scan_launches = (scan_busy * whole / scan_launches,
                                    whole)
    for _ in range(5):
        scan()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(200):
        scan()
    stop.record()
    torch.cuda.synchronize()
    scan_ms = start.elapsed_time(stop) / 200

    # the Table-1 setting, as chip_smoke.py phase 3 runs it
    cfg1 = grid_mod.XSimConfig(n_warm=24, n_backlog=16, n_arrivals=24,
                               max_stages=9, t0=3600.0)
    grid1 = grid_mod.make_grid(cfg1, n_seeds=4, shrink=1 / 64.0,
                               policy_ids=(0, 1, 2), device=dev)
    fleet1 = policies.init_fleet(int(grid1.geo_idx.max()) + 1, device=dev)
    fleet1 = grid_mod.warm_fleet(fleet1, grid1, rounds=3, device=dev)
    run1 = lambda: grid_mod.run_grid(grid1, fleet1,  # noqa: E731
                                     pred_seed=7, device=dev)
    run1()
    table1 = [wall_s(run1) for _ in range(3)]

    print(f"tree={tree} full-size B={grid.n} N={cfg.max_jobs} "
          f"steps={STEPS}: wall_ms_per_step="
          f"{statistics.median(walls):.3f} (runs "
          f"{', '.join(f'{w:.3f}' for w in walls)}) "
          f"profiled: launches_per_step={launches / STEPS:.1f} "
          f"device_busy_ms_per_step={busy / STEPS / 1e3:.6f} "
          f"wall_ms_per_step={pwall / STEPS / 1e3:.3f} | sweep wall_s="
          f"{sweep_s:.6f} scenarios_per_s={grid.n / sweep_s:.6f} "
          f"freed_launches={sweep_launches} | "
          f"table1 B={grid1.n} N={cfg1.max_jobs} wall_s="
          f"{statistics.median(table1):.6f} (runs "
          f"{', '.join(f'{w:.6f}' for w in table1)}) | freed_matrix "
          f"running={int(r.sum())} event_ms={scan_ms:.6f} device_us="
          f"{scan_busy / 20:.3f} launches_per_call={scan_launches / 20:g}",
          flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        one(args.trees[0])
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for tree in args.trees:
        subprocess.run([sys.executable, __file__, "--one", tree],
                       check=True)


if __name__ == "__main__":
    main()

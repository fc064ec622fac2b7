"""What the event rings (``repro_torch.obs.trace``) cost on the full-size
fleet sweep: untraced and traced runs in turns, in one process on one
card.

    python scripts/trace_overhead_ab.py [--pairs 2]

The grid is ``chip_smoke.py`` phase 4's (both centers at their real core
counts, three scales and workflows, policies 0-2, two seeds: 108
scenarios of 2313 job slots, cold estimators); the traced grid is the
same with ``XSimConfig.with_trace()`` (9252 slots a ring). Runs go
untraced, traced, traced, untraced for each pair, so that drift of the
host's speed falls on both sides. For each run it prints the wall s of
``run_grid`` (ending in a synchronise), ms a step and the scan's
launches; at the end the medians and their ratio, beside the card's
name and power limit. It checks that every traced run's state without
its ring equals the untraced run's, bit for bit.

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=2,
                    help="(untraced, traced, traced, untraced) rounds")
    args = ap.parse_args()
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch

    from repro_torch import convert
    from repro_torch.xsim import backfill, policies
    from repro_torch.xsim import grid as grid_mod

    if not torch.cuda.is_available():
        sys.exit("trace_overhead_ab: needs a CUDA card")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cfg = grid_mod.XSimConfig(n_warm=512, n_backlog=768, n_arrivals=1024,
                              max_stages=9)
    grids = {"untraced": grid_mod.make_grid(cfg, shrink=1.0,
                                            policy_ids=(0, 1, 2), n_seeds=2,
                                            device=dev),
             "traced": grid_mod.make_grid(cfg.with_trace(), shrink=1.0,
                                          policy_ids=(0, 1, 2), n_seeds=2,
                                          device=dev)}
    fleet = policies.init_fleet(int(grids["untraced"].geo_idx.max()) + 1,
                                device=dev)
    walls: dict[str, list[float]] = {"untraced": [], "traced": []}
    want = None
    order = ["untraced", "traced", "traced", "untraced"] * args.pairs
    for what in order:
        backfill.KERNEL_LAUNCHES["freed_scan"] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, _ = grid_mod.run_grid(grids[what], fleet, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        walls[what].append(wall)
        steps = int(final.steps.max())
        got = convert.to_numpy(final._replace(trace=None))
        if want is None:
            want = got
        if got.keys() != want.keys() or not all(
                np.array_equal(got[k], want[k]) for k in got):
            sys.exit(f"trace_overhead_ab: the {what} run's state differs")
        print(f"{what}: wall_s={wall:.6f} ms_per_step="
              f"{wall * 1e3 / steps:.3f} steps_max={steps} "
              f"freed_scan_launches={backfill.KERNEL_LAUNCHES['freed_scan']}",
              flush=True)
    med = {k: statistics.median(v) for k, v in walls.items()}
    print(f"{card}: median untraced_s={med['untraced']:.6f} traced_s="
          f"{med['traced']:.6f} traced_over_untraced="
          f"{med['traced'] / med['untraced']:.6f} runs={len(order)} "
          f"states_equal=True")


if __name__ == "__main__":
    main()

"""Run ``chip_smoke.py``'s phase 16 (the sharded paths, the campaign and
one process a block) alone, then time the naive-and-faults program's
16-step profiled window at full size, which the smoke's phase 11 does
not run.

    python3 scripts/sharded_phase.py

Builds ``csrc/freed_scan.cu`` and starts phase 16's workers as the smoke
starts them: the plain and one-card sharded runs (``side_runs``) and
16(e)'s ``FLEET_RANKS`` ranks on ``cuda:0``. Meanwhile it makes phase
16's inputs as the smoke makes them: phase 4's full-size grid (B=108,
N=2313), phase 10's runs under every family (the ``faulty`` one, B=288,
N=73, is the one phase 16 shards), phase 14(a)'s request stream and
phase 15(a)'s rollout (B=144, N=73). It runs phase 16 with its checks
(each part's seconds printed), then 16 full-size faulty steps (B=72,
N=2313) under the profiler, and prints the seconds of each. About 5
minutes on an H100; a failed check exits non-zero. Needs a CUDA card.
"""

from __future__ import annotations

import atexit
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this script needs a "
                "GPU")
    from repro_torch import cuda_build
    from repro_torch.xsim import backfill, families, policies
    from repro_torch.xsim import events as events_mod
    from repro_torch.xsim import grid as grid_mod
    from repro_torch.xsim.state import RUNNING

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line())
    t_all = time.perf_counter()
    cuda_build.build(["freed_scan"])
    plain = cs.Worker(cs.side_runs)
    atexit.register(plain.close)
    ranks = cs.FleetRanks()
    atexit.register(ranks.close)

    full = cs.full_size(grid_mod, policies, backfill, dev, RUNNING)
    _, faulty, _ = cs.table1_families(grid_mod, families, policies,
                                      backfill, dev)
    events = cs.build_traffic(grid_mod, families, policies, backfill,
                              dev)["events"]
    grid, fleet, params = cs.rl_setting(dev)
    final, _, traj = cs.rl_rollout(grid, params, fleet, dev)
    rl_run = dict(grid=grid, fleet=fleet, params=params, final=final,
                  traj=traj)
    torch.cuda.synchronize()
    print(f"sharded_phase/inputs_s={time.perf_counter() - t_all:.3f}")

    t0 = time.perf_counter()
    paths = cs.sharded_and_campaign(faulty, rl_run, events, backfill, plain,
                                    dev, full, ranks)
    print(f"sharded_phase/phase16_s={time.perf_counter() - t0:.3f} "
          f"launches_by_path={paths}")

    # the full-size faulty window phase 11 does not profile
    fcfg = grid_mod.XSimConfig(n_warm=512, n_backlog=768, n_arrivals=1024,
                               max_stages=9)
    fgrid = families.family_grid(fcfg, "faulty", shrink=1.0,
                                 policy_ids=(2, 3), n_seeds=cs.FAULTY_SEEDS,
                                 device=dev)
    ffleet = policies.init_fleet(int(fgrid.geo_idx.max()) + 1, device=dev)
    s0 = fgrid.build(policies.scenario_estimators(
        ffleet, torch.as_tensor(fgrid.geo_idx, device=dev), 1))
    t0 = time.perf_counter()
    cs.device_profile("profile_faulty", lambda: events_mod.simulate(
        s0, n_steps=16, pred_mode="greedy", naive=True, faults=True), 16,
        "full-size faulty steps", ("freed_scan",))
    print(f"sharded_phase/phase11_window_s={time.perf_counter() - t0:.3f}")


if __name__ == "__main__":
    main()

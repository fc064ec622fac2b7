"""Run ``chip_smoke.py``'s phase 16 (the sharded paths and the campaign)
alone, then time the naive-and-faults program's 16-step profiled window
at full size, which the smoke's phase 11 no longer runs.

    python3 scripts/sharded_phase.py

Builds ``csrc/freed_scan.cu``, then makes phase 16's inputs as the smoke
makes them: phase 10's ``faulty`` Table-1 setting with ASA-Naive (B=288,
N=73; three warm-fleet rounds, one kernel run at ``pred_seed=7``), phase
14(a)'s request stream (the load generator's traced sweep of 1026
tenants) and phase 15(a)'s rollout (``rl.train.TrainConfig()``'s
geometry, B=144, N=73). It runs phase 16 with its checks (each part's
seconds printed), then the 16 full-size faulty steps (B=72, N=2313)
under the profiler as phase 11 used to, and prints the seconds of each.
About 3 minutes on an H100; a failed check exits non-zero. Needs a CUDA
card.
"""

from __future__ import annotations

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
    from repro_torch.core import prng
    from repro_torch.rl import policy as rl_policy
    from repro_torch.rl import rollout
    from repro_torch.rl import train as rl_train
    from repro_torch.xsim import backfill, families, policies
    from repro_torch.xsim import events as events_mod
    from repro_torch.xsim import grid as grid_mod
    from repro_torch.xsim.state import RL

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    print(cs.card_line())
    t_all = time.perf_counter()
    cuda_build.build(["freed_scan"])

    # phase 10's faulty run
    cfg = grid_mod.XSimConfig(n_warm=24, n_backlog=16, n_arrivals=24,
                              max_stages=9, t0=3600.0)
    grid = families.family_grid(cfg, "faulty", n_seeds=4, shrink=1 / 64.0,
                                policy_ids=(0, 1, 2, 3), device=dev)
    fleet = policies.init_fleet(int(grid.geo_idx.max()) + 1, device=dev)
    fleet = grid_mod.warm_fleet(fleet, grid, rounds=3, device=dev)
    fin, m = grid_mod.run_grid(grid, fleet, pred_seed=7, device=dev)
    faulty = dict(grid=grid, fleet=fleet, final=fin, metrics=m,
                  pred_seed=7)
    # phase 14(a)'s request stream
    traffic = cs.build_traffic(grid_mod, families, policies, backfill, dev)
    # phase 15(a)'s rollout
    rcfg = rl_train.TrainConfig()
    rfleet = rl_train.warmed_fleet(rcfg, grid_seed=rcfg.seed, device=dev)
    params = rl_policy.init_params(prng.PRNGKey(rcfg.seed, dev),
                                   hidden=rcfg.hidden, device=dev)
    rgrid = families.family_grid(
        rcfg.sim, rcfg.family, center_names=rcfg.center_names,
        workflows=rcfg.workflows, policy_ids=(RL,), n_seeds=rcfg.n_seeds,
        shrink=rcfg.shrink, seed=rcfg.seed * 10_000 + 1, device=dev)
    rfin, _, traj = rollout.collect(rgrid, params, rfleet, pred_seed=1,
                                    rl_mode="sample",
                                    oh_weight=rcfg.oh_weight, device=dev)
    rl_run = dict(grid=rgrid, fleet=rfleet, params=params, final=rfin,
                  traj=traj, oh_weight=rcfg.oh_weight)
    torch.cuda.synchronize()
    print(f"sharded_phase/inputs_s={time.perf_counter() - t_all:.3f}")

    t0 = time.perf_counter()
    paths = cs.sharded_and_campaign(faulty, rl_run, traffic["events"],
                                    backfill, dev)
    print(f"sharded_phase/phase16_s={time.perf_counter() - t0:.3f} "
          f"launches_by_path={paths}")

    # the full-size faulty window phase 11 no longer profiles
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

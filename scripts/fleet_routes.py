"""Time the fleet's sharded paths three ways on one card: ``n_shards=1``,
one process over ``RANKS`` blocks (``ScenariosMesh([cuda:0] * RANKS)``)
and ``RANKS`` processes, one a block (``parallel.dist``, every rank on
``cuda:0``, ``gloo`` through pinned host buffers); ``RANKS`` is the
smoke's ``SERVE_SHARD_BLOCKS``, 4.

    python3 scripts/fleet_routes.py

Two settings of ``chip_smoke.py``: phase 10's ``faulty`` run (the
Table-1 setting with ASA-Naive, B=288, N=73, one warm round through
``n_shards=1``, ``pred_seed=7``) and phase 4's full-size grid (both
centers at real core counts, B=108, N=2313, cold estimators). Each of
``ROUNDS`` rounds runs the three routes in turn, the order reversed
every other round (so ``n_shards=1`` opens one round and closes the
next); each run's final state and metrics are held bitwise to the first
``n_shards=1`` run's (the ranks' by digest, every rank's). Then each
route's first ``WINDOW_STEPS`` event steps from the built state run
under the profiler: launches a step and the card's idle share (the
ranks: each rank's own share of its window, all windows at once).
Prints the walls, scenarios/s and the card's name and power limit.
Needs a CUDA card and nothing else on it; about 25 minutes on an H100.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import sys
import tempfile
import time
import traceback
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SETTINGS = ("faulty", "full")
ROUNDS = 2
RANKS = cs.SERVE_SHARD_BLOCKS
WINDOW_STEPS = 4
DEADLINE_S = 1200


def setting(name: str, dev, fleet=None):
    """(grid, fleet, run_grid keywords, simulate keywords) of a setting;
    ``fleet`` replaces the faulty setting's warm-up (the ranks load it)."""
    from repro_torch.xsim import families, policies
    from repro_torch.xsim import grid as grid_mod

    if name == "faulty":
        cfg = grid_mod.XSimConfig(**cs.NAIVE_CFG)
        grid = families.family_grid(cfg, "faulty", **cs.NAIVE_GRID,
                                    device=dev)
        if fleet is None:
            fleet = grid_mod.warm_fleet(
                policies.init_fleet(int(grid.geo_idx.max()) + 1,
                                    device=dev), grid,
                rounds=cs.WARM_ROUNDS, device=dev)
        return grid, fleet, dict(pred_seed=7), dict(naive=True, faults=True)
    cfg = grid_mod.XSimConfig(n_warm=512, n_backlog=768, n_arrivals=1024,
                              max_stages=9)
    grid = grid_mod.make_grid(cfg, shrink=1.0, policy_ids=(0, 1, 2),
                              n_seeds=2, device=dev)
    fleet = policies.init_fleet(int(grid.geo_idx.max()) + 1, device=dev)
    return grid, fleet, dict(pred_seed=1), dict(naive=False, faults=False)


def first_state(grid, fleet, seed: int):
    """The state a sweep starts from (``run_grid`` builds it so)."""
    from repro_torch.xsim import policies

    dev = grid.keys.device
    return grid.build(policies.scenario_estimators(
        fleet, torch.as_tensor(grid.geo_idx, device=dev), seed))


def digests(final, m) -> list[str]:
    from repro_torch import convert

    return ([cs._digest(v) for v in convert.to_numpy(final).values()]
            + [cs._digest(v) for v in m.values()])


def timed(grid, fleet, kw: dict, dev, **route) -> tuple:
    """One ``run_grid`` -> (digests, seconds, scan launches)."""
    from repro_torch.xsim import backfill
    from repro_torch.xsim import grid as grid_mod

    cs.reset_scan_counts(backfill)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, m = grid_mod.run_grid(grid, fleet, device=dev, **kw, **route)
    torch.cuda.synchronize()
    return (digests(final, m), time.perf_counter() - t0,
            backfill.KERNEL_LAUNCHES["freed_scan"])


def window(states, sim_kw: dict) -> dict:
    """``WINDOW_STEPS`` steps of each state in turn, after one warm-up,
    under the profiler: launches, device busy and wall microseconds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.xsim import events

    def run():
        for s in states:
            events.simulate(s, n_steps=WINDOW_STEPS, chunk_steps=0,
                            pred_mode="greedy", **sim_kw)
        torch.cuda.synchronize()

    run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall = (time.perf_counter() - t0) * 1e6
    rows = [(ev.self_device_time_total, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    return dict(launches=sum(r[1] for r in rows),
                busy_us=sum(r[0] for r in rows), wall_us=wall)


def blocks_of(state, mesh) -> list:
    from repro_torch.parallel import fleet as pfleet

    padded, _ = pfleet.pad_batch(state, mesh.shape["scenarios"])
    return pfleet.split(padded, mesh)


def rank_main(rank: int, world: int, work: str) -> None:
    """One rank: each setting swept over the ranks' mesh after a barrier,
    then its own block's profiled window (all ranks' at once). Writes
    ``work/rank<rank>.json``; a failure's traceback to
    ``work/err<rank>.txt``."""
    work = Path(work)
    try:
        from repro_torch.core.asa import ASAState
        from repro_torch.launch.mesh import make_scenarios_mesh
        from repro_torch.parallel import dist

        t_spawn = float((work / "spawned").read_text())
        dist.init(rank, world, init_method=f"file://{work / 'init'}",
                  timeout_s=DEADLINE_S)
        dev = dist.local_device("cuda")
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        mesh = make_scenarios_mesh(device="cuda")
        rec = {"startup_s": time.time() - t_spawn}
        warmed = ASAState(*(x.to(dev) for x in torch.load(
            work / "fleet.pt", weights_only=False)))
        for name in SETTINGS:
            grid, fleet, kw, sim_kw = setting(name, dev, warmed)
            torch.distributed.barrier()
            dist.reset_counts()
            d, secs, launches = timed(grid, fleet, kw, dev, mesh=mesh)
            rec[name] = dict(digests=d, seconds=secs, launches=launches,
                             collectives=json.loads(json.dumps(dist.COUNTS)))
            own = blocks_of(first_state(grid, fleet, kw["pred_seed"]), mesh)
            torch.distributed.barrier()
            rec[name]["window"] = window(own, sim_kw)
        (work / f"rank{rank}.json").write_text(json.dumps(rec))
        dist.destroy()
    except BaseException:
        (work / f"err{rank}.txt").write_text(traceback.format_exc())
        os._exit(1)


def run_ranks(world: int, fleet) -> list[dict]:
    """The ranks, spawned together; each one's record."""
    import shutil

    work = Path(tempfile.mkdtemp(prefix="fleet_routes_"))
    try:
        torch.save(tuple(x.cpu() for x in fleet), work / "fleet.pt")
        (work / "spawned").write_text(repr(time.time()))
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=rank_main, args=(r, world, str(work)))
                 for r in range(world)]
        for p in procs:
            p.start()
        end = time.monotonic() + DEADLINE_S
        for p in procs:
            p.join(max(0.0, end - time.monotonic()))
        codes = []
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
            codes.append(p.exitcode)
        errs = "".join(f.read_text()[-2000:]
                       for f in sorted(work.glob("err*.txt")))
        cs.check(codes == [0] * world, f"ranks ended with {codes} {errs}")
        return [json.loads((work / f"rank{r}.json").read_text())
                for r in range(world)]
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main() -> None:
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this script needs a "
                "GPU")
    from repro_torch import cuda_build
    from repro_torch.launch.mesh import ScenariosMesh

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line())
    cuda_build.build(["freed_scan"])
    k = RANKS
    blocks = ScenariosMesh([dev] * k)
    inputs = {name: setting(name, dev) for name in SETTINGS}
    want = {}
    walls: dict = {(n, r): [] for n in SETTINGS
                   for r in ("n_shards=1", f"blocks={k}", f"ranks={k}")}
    routes = ["n_shards=1", f"blocks={k}", f"ranks={k}"]
    for rnd in range(ROUNDS):
        for route in (routes if rnd % 2 == 0 else routes[::-1]):
            if route.startswith("ranks"):
                t0 = time.perf_counter()
                recs = run_ranks(k, inputs["faulty"][1])
                print(f"fleet_routes/round{rnd}/{route}: spawn_to_end_s="
                      f"{time.perf_counter() - t0:.3f} startup_s="
                      f"{[round(r['startup_s'], 3) for r in recs]}")
                for name in SETTINGS:
                    for r, rec in enumerate(recs):
                        cs.check(rec[name]["digests"] == want[name],
                                 f"{name}/{route}: rank {r} differs")
                    walls[name, route].append(
                        [rec[name]["seconds"] for rec in recs])
                    print(f"fleet_routes/round{rnd}/{name}/{route}: wall_s="
                          f"{[round(x, 6) for x in walls[name, route][-1]]}"
                          " launches="
                          f"{[rec[name]['launches'] for rec in recs]}"
                          f" collectives_rank0="
                          f"{json.dumps(recs[0][name]['collectives'])}")
                    if rnd == ROUNDS - 1:
                        for r, rec in enumerate(recs):
                            w = rec[name]["window"]
                            print(f"fleet_routes/window/{name}/{route}/"
                                  f"rank{r}: {WINDOW_STEPS} steps of its "
                                  f"block launches={w['launches']} "
                                  f"launches_per_step="
                                  f"{w['launches'] / WINDOW_STEPS:.1f} "
                                  f"busy_us={w['busy_us']:.3f} wall_us="
                                  f"{w['wall_us']:.3f} idle_share="
                                  f"{1 - w['busy_us'] / w['wall_us']:.6f}")
                continue
            for name in SETTINGS:
                grid, fleet, kw, _ = inputs[name]
                route_kw = (dict(n_shards=1) if route == "n_shards=1"
                            else dict(mesh=blocks))
                d, secs, launches = timed(grid, fleet, kw, dev, **route_kw)
                want.setdefault(name, d)
                cs.check(d == want[name], f"{name}/{route}: differs")
                walls[name, route].append(secs)
                print(f"fleet_routes/round{rnd}/{name}/{route}: wall_s="
                      f"{secs:.6f} launches={launches}")
    for name in SETTINGS:
        grid, fleet, kw, sim_kw = inputs[name]
        s0 = first_state(grid, fleet, kw["pred_seed"])
        for route, states in (("n_shards=1", [s0]),
                              (f"blocks={k}", blocks_of(s0, blocks))):
            w = window(states, sim_kw)
            print(f"fleet_routes/window/{name}/{route}: {WINDOW_STEPS} "
                  f"steps of {len(states)} block(s) launches="
                  f"{w['launches']} launches_per_step="
                  f"{w['launches'] / WINDOW_STEPS:.1f} busy_us="
                  f"{w['busy_us']:.3f} wall_us={w['wall_us']:.3f} "
                  f"idle_share={1 - w['busy_us'] / w['wall_us']:.6f}")
        for route in routes:
            ws = walls[name, route]
            best = [max(w) if isinstance(w, list) else w for w in ws]
            print(f"fleet_routes/{name}/{route}: B={grid.n} "
                  f"N={grid.cfg.max_jobs} walls_s={ws} scenarios_per_s="
                  f"{[round(grid.n / w, 3) for w in best]} bitwise=True")
    print(cs.card_line())


if __name__ == "__main__":
    main()

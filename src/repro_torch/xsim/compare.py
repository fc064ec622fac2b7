"""Metrics extraction + the QueueSim cross-validation bridge (port of
``repro.xsim.compare``).

``metrics`` reduces a finished batch of scenarios to the quantities
``sched.runner``'s RunMetrics carries (twt_s, makespan_s, core_hours,
oh_hours, utilization, …), one ``(B,)`` tensor each.
``sharded_batched_metrics`` computes them block by block over a
``scenarios`` mesh. ``scenario_from_queue_sim`` snapshots a live
event-driven QueueSim into a host-side job table, so both engines run
from the identical machine state and the numbers can be compared.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.parallel import fleet as pfleet
from repro_torch.xsim.state import (ASA, ASA_NAIVE, DONE, PILOT, QUEUED, RL,
                                    RUNNING, ScenarioState, empty_table)

_INF = float("inf")


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, 1, idx.long().unsqueeze(1)).squeeze(1)


def metrics(s: ScenarioState) -> dict[str, torch.Tensor]:
    """Per-scenario scalars of a batched final state.

    twt_s is policy-aware: BigJob = the single job's wait, Per-Stage =
    Σ stage waits, ASA-like = perceived waits along the stage chain
    (stage 0's full wait, then the part of each stage's wait not hidden
    behind its predecessor's logical end). Pilot counts like BigJob.
    oh_hours carries the naive over-allocation, the pilot's packing waste
    once the pilot starts, and the core-seconds lost to fault kills."""
    n = s.status.shape[1]
    wf = s.is_wf
    wait = torch.where(wf, s.start - s.submit, 0.0)
    wait_sum = torch.where(wf, wait, 0.0).sum(dim=1)

    # ASA perceived waits + logical makespan along the stage chain:
    # le_y = max(start_y + hold_y, le_{y−1}) + t_y
    rows = s.wf_rows.clamp(0, n - 1)
    le = torch.full_like(s.t, -_INF)
    chain_twt = torch.zeros_like(s.t)
    for y in range(s.wf_rows.shape[1]):
        row = rows[:, y]
        start = _take(s.start, row)
        ok = (s.wf_rows[:, y] >= 0) & torch.isfinite(start)
        start_l = start + s.hold[:, y]
        if y == 0:
            pwt = start - _take(s.submit, row)
            new_le = start_l + _take(s.duration, row)
        else:
            pwt = torch.where(torch.isneginf(le), 0.0,
                              torch.clamp_min(start - le, 0.0))
            new_le = torch.maximum(start_l, le) + _take(s.duration, row)
        le = torch.where(ok, new_le, le)
        chain_twt = chain_twt + torch.where(ok, pwt, 0.0)

    asa_like = (s.policy == ASA) | (s.policy == ASA_NAIVE) | (s.policy == RL)
    twt = torch.where(asa_like, chain_twt, wait_sum)

    wf_end = torch.where(wf, s.end, -_INF).amax(dim=1)
    makespan = torch.where(asa_like, le, wf_end) - s.t0
    core_seconds = torch.where(wf, s.cores * s.duration, 0.0).sum(dim=1)
    restart_hours = s.restart_cs / 3600.0
    is_pilot = s.policy == PILOT
    started_any = (wf & torch.isfinite(s.start)).any(dim=1)
    pilot_oh = torch.where(started_any, s.pilot_waste_cs, 0.0) / 3600.0
    oh_hours = torch.where(is_pilot, pilot_oh, s.oh_cs / 3600.0) \
        + restart_hours
    core_hours = core_seconds / 3600.0 + torch.where(is_pilot, restart_hours,
                                                     oh_hours)
    done = (wf & (s.status == DONE)).sum(dim=1, dtype=torch.int32)
    total_wf = wf.sum(dim=1, dtype=torch.int32)
    util = s.busy_cs / torch.clamp_min(s.total * s.t, 1e-9)
    return {
        "twt_s": twt,
        "makespan_s": makespan,
        "core_hours": core_hours,
        "oh_hours": oh_hours,
        "misses": s.misses,
        "utilization": util,
        "wf_done": done,
        "wf_total": total_wf,
        "restarts": s.restarts,
        "restart_hours": restart_hours,
        "policy": s.policy,
    }


def batched_metrics(final: ScenarioState) -> dict[str, torch.Tensor]:
    """``metrics`` of a batched final state (the port's states are always
    batched, so this is ``metrics`` itself)."""
    return metrics(final)


def sharded_batched_metrics(final: ScenarioState, mesh
                            ) -> dict[str, torch.Tensor]:
    """``batched_metrics`` over a ``scenarios`` mesh
    (``launch.mesh.ScenariosMesh``): each device reduces its own block of
    final states (padded as ``events.sharded_sweep`` pads them) to the
    per-scenario columns, and only the ``(B,)`` columns are gathered.
    Equal to ``batched_metrics`` up to reduction order on the summed
    columns, which is why ``run_grid``, whose contract is bitwise,
    computes its metrics on the gathered states instead. On a process
    group's mesh each rank reduces its own block and the columns are
    all-gathered: every rank holds them all."""
    b = pfleet.batch_size(final)
    padded, _mask = pfleet.pad_batch(final,
                                     mesh.shape[pfleet.SCENARIO_AXIS])
    blocks = pfleet.split(padded, mesh)
    return pfleet.unpad(pfleet.gather([metrics(x) for x in blocks],
                                      final.status.device, mesh), b)


def wf_rows(s: ScenarioState, lane: int = 0) -> dict[str, np.ndarray]:
    """Host-side view of one lane's workflow rows (stage-ordered)."""
    mask = s.is_wf[lane].cpu().numpy()
    return {name: getattr(s, name)[lane].cpu().numpy()[mask]
            for name in ("submit", "start", "end", "cores", "duration",
                         "status")}


def scenario_from_queue_sim(sim, max_jobs: int) -> tuple[dict, int]:
    """Snapshot a live QueueSim into a host-side job table.

    Returns (table, next_free_row). Running jobs keep their residual end
    times, in the order ``(end, id)``; queued jobs follow with their
    submit times in FCFS order (the engine's stable sort keeps it for
    equal submit times). Workflow rows are appended by the caller via
    ``policies.add_workflow`` starting at next_free_row.
    """
    table = empty_table(max_jobs)
    row = 0
    for _, jid in sorted(sim.running):
        j = sim.jobs[jid]
        if jid in sim.finished or j.canceled:
            continue
        table["submit"][row] = j.submit_time
        table["cores"][row] = j.cores
        table["duration"][row] = j.duration
        table["start"][row] = j.start_time
        table["end"][row] = j.end_time
        table["status"][row] = RUNNING
        row += 1
    for jid in sim.queue:
        j = sim.jobs[jid]
        table["submit"][row] = j.submit_time
        table["cores"][row] = j.cores
        table["duration"][row] = j.duration
        table["status"][row] = QUEUED
        row += 1
    return table, row


def queue_sim_free_cores(sim) -> float:
    return float(sim.free_cores)

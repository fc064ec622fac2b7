"""Metrics extraction (port of ``repro.xsim.compare.metrics``).

``metrics`` reduces a finished batch of scenarios to the quantities
``sched.runner``'s RunMetrics carries (twt_s, makespan_s, core_hours,
oh_hours, utilization, …), one ``(B,)`` tensor each.
"""

from __future__ import annotations

import torch

from repro_torch.xsim.state import (ASA, ASA_NAIVE, DONE, PILOT, RL,
                                    ScenarioState)

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

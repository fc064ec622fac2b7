"""Robustness scenario families: named fault/elasticity regimes as data
(port of ``repro.xsim.families``).

A *family* is a recipe that turns a grid label into a
``runtime.fault.FaultSchedule`` — the whole robustness axis of the
benchmark is data in the fixed-slot job table, not new engine code:

* ``clean``    — no capacity events; the plain grid (``cfg.n_faults ==
  0`` elides the fault machinery).
* ``faulty``   — a node failure mid-run: ``FAIL_FRAC`` of the machine
  dies (running jobs killed and requeued, lost core-seconds charged as
  restart overhead), recovering two hours later.
* ``elastic``  — a malleable-capacity center: graceful drain/grow
  cycles (nodes leave as their running work completes — no kills).
* ``preempt``  — the same resize plan taken preemptively: shrinks kill
  the youngest running jobs immediately (spot/preemptible semantics).

Fault times are anchored after the workflow submission epoch ``t0`` and
offset per seed, so sibling seeds of one cell stress different phases
of the workflow instead of replaying one global incident.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import DEFAULT_DEVICE
from repro_torch.runtime import fault
from repro_torch.runtime.elastic import resize_schedule
from repro_torch.xsim.grid import ScenarioGrid, XSimConfig, make_grid

FAMILIES = ("clean", "faulty", "elastic", "preempt")

# fixed fault-slot count per family (XSimConfig.n_faults)
N_FAULT_SLOTS = {"clean": 0, "faulty": 2, "elastic": 4, "preempt": 4}

FAIL_FRAC = 0.25      # faulty: fraction of the machine that dies
RESIZE_FRAC = 0.30    # elastic/preempt: first shrink/grow amplitude
RECOVER_S = 7200.0    # faulty: failed nodes rejoin after two hours


def family_schedule(family: str, label: dict,
                    t0: float) -> fault.FaultSchedule | None:
    """The family's FaultSchedule for one grid cell label (or None)."""
    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r}; expected one of "
                         f"{FAMILIES}")
    if family == "clean":
        return None
    seed = int(label.get("seed", 0))
    if family == "faulty":
        # failure lands 30/60/90 min after the workflow submits
        t_fail = t0 + 1800.0 * (1 + seed % 3)
        return fault.FaultSchedule((
            fault.fail(t_fail, FAIL_FRAC),
            fault.grow(t_fail + RECOVER_S, FAIL_FRAC),
        ))
    # elastic / preempt: two shrink/grow cycles, phase-shifted per seed
    t_a = t0 + 1200.0 * (1 + seed % 2)
    return resize_schedule(
        [(t_a, -RESIZE_FRAC),
         (t_a + 3600.0, +RESIZE_FRAC),
         (t_a + 5400.0, -RESIZE_FRAC / 2),
         (t_a + 9000.0, +RESIZE_FRAC / 2)],
        preempt=(family == "preempt"))


def family_grid(cfg: XSimConfig, family: str = "clean", *,
                device: str | torch.device = DEFAULT_DEVICE,
                **make_grid_kw) -> ScenarioGrid:
    """``make_grid`` on ``device`` with the family's fault schedules
    folded in.

    Sets ``cfg.n_faults`` to the family's slot count (``clean`` keeps 0 —
    the fault machinery is statically absent) and wires the per-label
    schedule recipe through ``make_grid(fault_sched=...)``. All other
    ``make_grid`` keywords pass through unchanged.
    """
    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r}; expected one of "
                         f"{FAMILIES}")
    cfg = dataclasses.replace(cfg, n_faults=N_FAULT_SLOTS[family])
    if family == "clean":
        return make_grid(cfg, device=device, **make_grid_kw)
    return make_grid(
        cfg, fault_sched=lambda lab: family_schedule(family, lab, cfg.t0),
        device=device, **make_grid_kw)

"""Live capacity plans as fault schedules (own copy of
``repro.runtime.elastic.resize_schedule``).

A center's malleable capacity (the malleable-job model of Dynamic
Fractional Resource Scheduling, arXiv 1106.4985) is a sequence of live
capacity changes, expressed as a ``runtime.fault.FaultSchedule`` that
``repro_torch.xsim`` folds into its event steps: graceful shrinks drain,
preemptive shrinks kill and requeue.
"""

from __future__ import annotations

from typing import Sequence

from repro_torch.runtime import fault as _fault


def resize_schedule(steps: Sequence[tuple[float, float]], *,
                    preempt: bool = False) -> _fault.FaultSchedule:
    """Live capacity plan → ``runtime.fault.FaultSchedule``.

    ``steps`` is ``[(t, delta_frac), ...]``: at absolute simulation time
    ``t`` the center's capacity changes by ``delta_frac`` of its original
    total cores. Positive deltas grow (nodes join); negative deltas
    shrink — gracefully by default (a DRAIN: nodes leave as their running
    work completes), or preemptively with ``preempt=True`` (a FAIL: the
    most recently started jobs on the lost nodes are killed and requeued,
    the xsim engine charges their lost core-seconds as restart overhead).
    """
    events = []
    for t, delta in steps:
        if delta == 0.0:
            raise ValueError(f"zero-delta resize step at t={t}")
        if delta > 0.0:
            events.append(_fault.grow(t, delta))
        elif preempt:
            events.append(_fault.fail(t, -delta))
        else:
            events.append(_fault.drain(t, -delta))
    return _fault.FaultSchedule(tuple(events))

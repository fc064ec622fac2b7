"""Failure detection, straggler mitigation + capacity-fault schedules.

Heartbeat tracking per worker (pod slice); a missed-deadline policy drives
both failure handling (restart from the last checkpoint on a shrunken mesh
— runtime.elastic) and straggler re-execution (the paper's own
re-submission-on-miss logic from §4.8, applied to tasks instead of jobs):
a task is re-issued when its runtime exceeds the q-quantile of completed
durations by a configurable factor.

``FaultSchedule`` is the data form of the same failure model: a sorted
list of capacity events (node failures, graceful drains, recoveries /
grows) that the fleet engine (``repro_torch.xsim``) folds into its
event steps as per-scenario arrays — the robustness scenario families
(faulty, elastic, preempt) are built from these schedules (see
``xsim.families``; ``runtime.elastic.resize_schedule`` turns a live
capacity plan into one).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np

# --- capacity-event kinds (xsim mirrors these in its fault arrays) ---------
FAULT_FAIL = 1   # nodes die NOW: running jobs are killed to cover the loss
FAULT_DRAIN = 2  # nodes drain: leave as their work completes (no kills)
FAULT_GROW = 3   # nodes join: recovery or elastic grow


@dataclass(frozen=True)
class CapacityEvent:
    """One capacity change: at time ``t`` (absolute simulation seconds),
    ``frac`` of the machine's *original* total cores fail/drain/join.

    ``frac`` is a fraction so one schedule applies across center
    geometries; it is converted to (rounded, integer-exact in f32) core
    counts against a concrete machine by ``FaultSchedule.as_arrays``.
    Shrinks larger than the machine present at the event are clamped by
    the engine — you can never lose more cores than exist.
    """

    t: float
    frac: float
    kind: int

    def __post_init__(self) -> None:
        if not (np.isfinite(self.t) and self.t >= 0.0):
            raise ValueError(f"event time must be finite >= 0, got {self.t}")
        if not (0.0 < self.frac):
            raise ValueError(f"capacity fraction must be > 0, got "
                             f"{self.frac}")
        if self.kind not in (FAULT_FAIL, FAULT_DRAIN, FAULT_GROW):
            raise ValueError(f"unknown fault kind {self.kind}")
        if self.kind != FAULT_GROW and self.frac > 1.0:
            raise ValueError(
                f"fail/drain fraction must be <= 1, got {self.frac}")


def fail(t: float, frac: float) -> CapacityEvent:
    """Nodes die at ``t``: their running jobs are killed and requeued."""
    return CapacityEvent(t, frac, FAULT_FAIL)


def drain(t: float, frac: float) -> CapacityEvent:
    """Nodes drain from ``t``: capacity leaves as running work completes."""
    return CapacityEvent(t, frac, FAULT_DRAIN)


def grow(t: float, frac: float) -> CapacityEvent:
    """Nodes join at ``t`` (recovery after a failure, or elastic grow)."""
    return CapacityEvent(t, frac, FAULT_GROW)


@dataclass(frozen=True)
class FaultSchedule:
    """An immutable, time-sorted list of capacity events.

    The empty schedule is the no-fault case: ``as_arrays`` pads with
    ``+inf`` times, which the xsim engine treats as "no event" — a
    dynamically empty schedule is bit-identical to the fault-free
    program (pinned by tests/test_xsim_faults.py).
    """

    events: tuple[CapacityEvent, ...] = ()

    def __post_init__(self) -> None:
        evs = tuple(sorted(self.events, key=lambda e: e.t))
        object.__setattr__(self, "events", evs)

    def __len__(self) -> int:
        return len(self.events)

    def as_arrays(self, max_events: int, total_cores: float
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(times, core deltas, kinds) padded to ``max_events`` slots.

        Times are f32 sorted ascending (+inf padding); deltas are
        ``round(frac · total_cores)`` f32 cores (integer-exact below
        2^24, like every core count in the engine); kinds are i32.
        """
        if len(self.events) > max_events:
            raise ValueError(
                f"{len(self.events)} fault events > {max_events} slots "
                "(raise XSimConfig.n_faults)")
        t = np.full(max_events, np.inf, np.float32)
        c = np.zeros(max_events, np.float32)
        k = np.zeros(max_events, np.int32)
        for i, e in enumerate(self.events):
            t[i] = e.t
            c[i] = np.round(e.frac * total_cores)
            k[i] = e.kind
        return t, c, k


@dataclass
class WorkerState:
    id: int
    last_heartbeat: float
    healthy: bool = True


class HeartbeatTracker:
    def __init__(self, timeout_s: float = 60.0):
        self.timeout_s = timeout_s
        self.workers: dict[int, WorkerState] = {}
        self.on_failure: list[Callable[[int], None]] = []

    def register(self, worker_id: int, now: float) -> None:
        self.workers[worker_id] = WorkerState(worker_id, now)

    def beat(self, worker_id: int, now: float) -> None:
        w = self.workers.get(worker_id)
        if w is not None:
            w.last_heartbeat = now
            w.healthy = True

    def sweep(self, now: float) -> list[int]:
        """Mark/report newly failed workers."""
        failed = []
        for w in self.workers.values():
            if w.healthy and now - w.last_heartbeat > self.timeout_s:
                w.healthy = False
                failed.append(w.id)
                for cb in self.on_failure:
                    cb(w.id)
        return failed

    def healthy_count(self) -> int:
        return sum(1 for w in self.workers.values() if w.healthy)


@dataclass
class StragglerPolicy:
    """Deadline = quantile(completed) × factor (+ floor)."""
    quantile: float = 0.9
    factor: float = 2.0
    min_samples: int = 5
    floor_s: float = 1.0

    def deadline(self, completed_durations: list[float]) -> Optional[float]:
        if len(completed_durations) < self.min_samples:
            return None
        q = float(np.quantile(np.asarray(completed_durations),
                              self.quantile))
        return max(q * self.factor, self.floor_s)


@dataclass
class TaskAttempt:
    task_id: int
    started_at: float
    finished_at: Optional[float] = None


class StragglerMitigator:
    """Tracks per-task attempts; tells the runner which to re-issue."""

    def __init__(self, policy: StragglerPolicy | None = None):
        self.policy = policy or StragglerPolicy()
        self.attempts: dict[int, list[TaskAttempt]] = {}
        self.durations: list[float] = []

    def start(self, task_id: int, now: float) -> None:
        self.attempts.setdefault(task_id, []).append(TaskAttempt(task_id, now))

    def finish(self, task_id: int, now: float) -> None:
        for a in self.attempts.get(task_id, []):
            if a.finished_at is None:
                a.finished_at = now
                self.durations.append(now - a.started_at)
                break

    def stragglers(self, now: float) -> list[int]:
        d = self.policy.deadline(self.durations)
        if d is None:
            return []
        out = []
        for tid, atts in self.attempts.items():
            running = [a for a in atts if a.finished_at is None]
            if running and all(now - a.started_at > d for a in running):
                out.append(tid)
        return out

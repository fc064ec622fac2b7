"""Deterministic seeded fault injection for the ASA serving loop (the
port's own copy of ``repro.serve.chaos``, line for line below this
docstring; stdlib only).

A :class:`ChaosSchedule` is a frozen, validated, batch-sorted tuple of
:class:`ChaosEvent` rows; a :class:`ChaosInjector` consumes it against a
live ``serve.loop.ASAServer`` through hooks the loop calls at three
seams:

* **batch boundary** (``on_batch_boundary``, top of ``step_once``):
  ``queue_burst`` submits a seeded burst of synthetic-tenant requests
  through the public ``submit`` path, and ``crash_kill_between_batches``
  raises :class:`InjectedCrash`, which kills the loop thread (the
  supervisor's restart path);
* **before the device step** (``before_device_step``, inside the
  containment region): ``step_exception`` raises
  :class:`InjectedStepFault` (wrapped into ``serve.asa.ServeStepError``
  and failed into that batch's futures) and ``slow_device_step`` sleeps
  ``magnitude`` seconds;
* **checkpoint cadence** (``on_checkpoint``): ``checkpoint_write_error``
  raises ``OSError`` at the save site.

An event fires at the first hook call where the server's dispatched-batch
count reaches ``event.batch``, and never again. A server built without an
injector pays one ``is not None`` check per batch.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Optional

CHAOS_KINDS = ("step_exception", "slow_device_step",
               "checkpoint_write_error", "crash_kill_between_batches",
               "queue_burst")


class InjectedStepFault(RuntimeError):
    """Raised inside the device-step containment region: the loop wraps
    it into ``serve.asa.ServeStepError`` and fails that batch only."""


class InjectedCrash(RuntimeError):
    """Raised at a batch boundary: escapes ``step_once``, kills the loop
    thread, and exercises the supervisor's restore-and-restart path."""


@dataclass(frozen=True)
class ChaosEvent:
    """One scheduled fault.

    ``batch`` — dispatched-batch index the event arms at (at-or-after);
    ``kind`` — one of :data:`CHAOS_KINDS`;
    ``magnitude`` — sleep seconds for ``slow_device_step``, request
    count for ``queue_burst``, unused (0) otherwise.
    """

    batch: int
    kind: str
    magnitude: float = 0.0

    def __post_init__(self) -> None:
        if self.kind not in CHAOS_KINDS:
            raise ValueError(f"unknown chaos kind {self.kind!r} "
                             f"(valid: {CHAOS_KINDS})")
        if self.batch < 0:
            raise ValueError(f"{self.kind}: batch must be >= 0, "
                             f"got {self.batch}")
        if self.magnitude < 0:
            raise ValueError(f"{self.kind}: magnitude must be >= 0, "
                             f"got {self.magnitude}")
        if self.kind == "slow_device_step" and self.magnitude <= 0:
            raise ValueError("slow_device_step needs magnitude > 0 "
                             "(the stall seconds)")
        if self.kind == "queue_burst" and self.magnitude < 1:
            raise ValueError("queue_burst needs magnitude >= 1 "
                             "(the burst request count)")


@dataclass(frozen=True)
class ChaosSchedule:
    """A validated, batch-sorted fault schedule (the ``FaultSchedule``
    idiom: frozen data, sorted in ``__post_init__``, duplicates of the
    same (batch, kind) rejected so firing order is total)."""

    events: tuple[ChaosEvent, ...] = ()

    def __post_init__(self) -> None:
        evs = tuple(sorted(self.events,
                           key=lambda e: (e.batch, CHAOS_KINDS.index(e.kind))))
        seen: set[tuple[int, str]] = set()
        for e in evs:
            k = (e.batch, e.kind)
            if k in seen:
                raise ValueError(f"duplicate chaos event {e.kind!r} at "
                                 f"batch {e.batch}")
            seen.add(k)
        object.__setattr__(self, "events", evs)

    def __len__(self) -> int:
        return len(self.events)


def step_exception(batch: int) -> ChaosEvent:
    return ChaosEvent(batch, "step_exception")


def slow_step(batch: int, seconds: float) -> ChaosEvent:
    return ChaosEvent(batch, "slow_device_step", seconds)


def checkpoint_error(batch: int) -> ChaosEvent:
    return ChaosEvent(batch, "checkpoint_write_error")


def crash(batch: int) -> ChaosEvent:
    return ChaosEvent(batch, "crash_kill_between_batches")


def queue_burst(batch: int, n: int) -> ChaosEvent:
    return ChaosEvent(batch, "queue_burst", float(n))


# synthetic burst tenants start here: far above any loadgen tenant id
# but well inside int32 (the tenant-id array the checkpoint round-trips)
BURST_TENANT_BASE = 1 << 20


@dataclass
class ChaosInjector:
    """Consumes one :class:`ChaosSchedule` against a live server.

    Carries across supervisor restarts on purpose: events not yet fired
    before a crash fire against the restarted server (the schedule
    describes the *process lifetime*, not one loop incarnation).
    ``fired`` records ``(batch, event, wall_s)`` for every event as it
    fires — the soak derives per-fault recovery times from it — and
    ``burst_futures`` collects every future the injector itself
    submitted, so harnesses can assert the zero-hung-futures invariant
    over injected traffic too.
    """

    schedule: ChaosSchedule
    seed: int = 0
    fired: list = field(default_factory=list)
    burst_futures: list = field(default_factory=list)

    def __post_init__(self) -> None:
        self._rng = random.Random(self.seed)
        self._armed = list(self.schedule.events)

    def _take(self, batches: int, kinds: tuple[str, ...]) -> list[ChaosEvent]:
        hit = [e for e in self._armed
               if e.batch <= batches and e.kind in kinds]
        for e in hit:
            self._armed.remove(e)
        return hit

    def record(self, ev: ChaosEvent, wall_s: float) -> None:
        self.fired.append((ev.batch, ev, wall_s))

    # ------------------------------------------------------------- hooks
    def on_batch_boundary(self, server) -> None:
        """Top of ``step_once``: bursts first (they land in the queue the
        crash cleanup drains), then the crash."""
        import time
        batches = server._batches
        for ev in self._take(batches, ("queue_burst",)):
            self.record(ev, time.monotonic())
            for _ in range(int(ev.magnitude)):
                tenant = BURST_TENANT_BASE + self._rng.randrange(1 << 16)
                wait = self._rng.uniform(10.0, 4000.0)
                self.burst_futures.append(server.submit(tenant, wait))
        for ev in self._take(batches, ("crash_kill_between_batches",)):
            self.record(ev, time.monotonic())
            raise InjectedCrash(
                f"chaos: crash_kill_between_batches at batch {batches}")

    def before_device_step(self, batches: int) -> None:
        """Inside the containment region, just before dispatch."""
        import time
        for ev in self._take(batches, ("slow_device_step",)):
            self.record(ev, time.monotonic())
            time.sleep(ev.magnitude)
        for ev in self._take(batches, ("step_exception",)):
            self.record(ev, time.monotonic())
            raise InjectedStepFault(
                f"chaos: step_exception at batch {batches}")

    def on_checkpoint(self, batches: int) -> None:
        """At the cadenced save site, before ``save_async``."""
        import time
        for ev in self._take(batches, ("checkpoint_write_error",)):
            self.record(ev, time.monotonic())
            raise OSError(
                f"chaos: checkpoint_write_error at batch {batches}")

    # ----------------------------------------------------------- derived
    @property
    def pending(self) -> tuple[ChaosEvent, ...]:
        """Events not yet fired (a finished soak asserts this is empty)."""
        return tuple(self._armed)

    def counts(self) -> dict[str, int]:
        out = {k: 0 for k in CHAOS_KINDS}
        for _b, ev, _t in self.fired:
            out[ev.kind] += 1
        return out


def mix_schedule(n_batches: int, seed: int = 0, *,
                 step_exceptions: int = 3, slow_steps: int = 1,
                 checkpoint_errors: int = 2, crashes: int = 1,
                 bursts: int = 2, burst_size: int = 64,
                 slow_s: float = 0.05) -> ChaosSchedule:
    """The soak's standard fault mix, spread deterministically over
    ``n_batches`` dispatched batches (seeded, collision-free)."""
    rng = random.Random(seed)
    events: list[ChaosEvent] = []
    used: set[tuple[int, str]] = set()

    def place(kind: str, count: int, make) -> None:
        for _ in range(count):
            for _try in range(64):
                b = rng.randrange(1, max(2, n_batches))
                if (b, kind) not in used:
                    used.add((b, kind))
                    events.append(make(b))
                    break

    place("step_exception", step_exceptions, step_exception)
    place("slow_device_step", slow_steps, lambda b: slow_step(b, slow_s))
    place("checkpoint_write_error", checkpoint_errors, checkpoint_error)
    place("crash_kill_between_batches", crashes, crash)
    place("queue_burst", bursts, lambda b: queue_burst(b, burst_size))
    return ChaosSchedule(tuple(events))

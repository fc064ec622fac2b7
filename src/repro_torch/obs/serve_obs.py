"""Request-lifecycle tracing and live metrics for the ASA serving loop
(the port's own copy of ``repro.obs.serve_obs``, line for line below its
docstring and imports; stdlib only, on the port's ``obs.registry``).

``obs.trace`` watches the device (per-scenario event rings appended in
the event loop); this module watches the *server*: every request through
``serve.loop.ASAServer`` leaves a lifecycle trail

    enqueue → (dedup/defer)* → batch-form → pad → device step →
    scatter-read → future-resolve

recorded as host-side span events, plus batch-level annotations. One
:class:`ServeObs` holds:

* a ``Registry`` of always-on counters, gauges and histograms (the data
  behind ``ASAServer.stats`` and the ``/metrics`` scrape endpoint);
* an optional span recorder (``spans=True``): wall-clock span events in a
  bounded deque, exported by ``chrome_events()`` onto the reserved
  ``serve`` pid rows that ``obs.export.merged_chrome_trace`` interleaves
  with the device event rings. ``spans=False`` (the default) records
  nothing and takes no timestamps; decisions are bit-identical either
  way.

Conservation contract: every request that enters ``submit()`` produces
exactly one ``enqueue`` event and exactly one ``request`` resolve span,
and ``requests_total`` equals ``resolved_total + failed_total +
in-flight``.

Time base: spans are wall-clock (``time.perf_counter`` relative to the
``ServeObs`` epoch); device rings are *simulated* seconds. The merged
trace shows the two clocks as separate pid rows; it does not align them.
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from typing import Any, Optional

from repro_torch.obs.registry import (FRACTION_BUCKETS, LATENCY_BUCKETS_S,
                                      Registry)

# chrome pid rows for the serve-side timelines: far above any scenario
# pid (device rings use pid = scenario index; fleets are ≤ table slots,
# a few thousand), asserted against collisions at merge time
SERVE_PID = 1_000_000          # loop phases + admission/eviction lane
SERVE_REQUEST_PID = 1_000_001  # per-request lifecycle lane (tid = tenant)

TID_LOOP = 0        # sequential batch-phase spans
TID_ADMISSION = 1   # admit/evict/table_full instants

_US = 1_000_000.0

# the batch-phase span names, in hot-path order (docs + tests key on it)
PHASES = ("batch_form", "pad", "device_step", "scatter_read",
          "future_resolve", "checkpoint_stall")


def serve_registry() -> Registry:
    """The serving loop's metric set, pre-registered so scrapes expose
    every series from the first request (Prometheus dislikes series that
    appear mid-flight)."""
    r = Registry()
    c, g, h = r.counter, r.gauge, r.histogram
    c("asa_serve_requests_total", "requests entering submit()")
    c("asa_serve_resolved_total", "futures resolved with a Decision")
    c("asa_serve_failed_total", "futures resolved with an error")
    c("asa_serve_observations_total", "requests carrying an observed wait")
    c("asa_serve_deferrals_total",
      "requests held to a later batch by the dedup batcher")
    c("asa_serve_batches_total", "jitted decision steps dispatched")
    c("asa_serve_decisions_total", "decisions answered (live batch rows)")
    c("asa_serve_padded_rows_total",
      "pad rows dispatched (batch_size - live rows, summed)")
    c("asa_serve_admissions_total", "tenant slot admissions")
    c("asa_serve_evictions_total", "tenant evictions")
    c("asa_serve_evicted_requests_total",
      "lifetime request totals of evicted tenants, snapshotted at evict")
    c("asa_serve_table_full_total", "admissions refused: table full")
    c("asa_serve_checkpoints_total", "cadenced async snapshots started")
    c("asa_serve_checkpoint_stall_seconds_total",
      "serve-loop seconds spent collecting previous checkpoint handles")
    c("asa_serve_checkpoint_failures_total",
      "cadenced checkpoint saves that failed (contained; serving continues)")
    c("asa_serve_step_errors_total",
      "jitted decision steps that failed (batch futures got ServeStepError)")
    c("asa_serve_shed_total", "requests shed before dispatch (any reason)")
    c("asa_serve_shed_expired_total",
      "requests shed at batch-form: deadline already passed")
    c("asa_serve_shed_queue_full_total",
      "requests shed at submit: bounded ingress queue full")
    c("asa_serve_lease_evictions_total",
      "idle tenants evicted by pool-lease LRU under table pressure")
    c("asa_serve_crashes_total", "serve-loop crashes (loop thread died)")
    c("asa_serve_restarts_total",
      "supervised restarts from the latest verified checkpoint")
    c("asa_serve_stop_drained_total",
      "queued/deferred requests failed with ServerStopped at stop()")
    g("asa_serve_loop_healthy",
      "1 while the serve loop thread is running, 0 after crash/stop")
    g("asa_serve_last_batch_age_seconds",
      "seconds since the loop last dispatched a batch (watchdog)")
    g("asa_serve_tenants", "admitted tenants (occupied slots)")
    g("asa_serve_free_slots", "unoccupied tenant slots")
    g("asa_serve_deferred", "requests parked in the deferred deque")
    g("asa_serve_inflight", "submitted but not yet resolved requests")
    h("asa_serve_request_latency_seconds", LATENCY_BUCKETS_S,
      "submit() to future resolution")
    h("asa_serve_device_step_seconds", LATENCY_BUCKETS_S,
      "jitted serve_step dispatch (async — excludes host-blocked wait)")
    h("asa_serve_scatter_read_seconds", LATENCY_BUCKETS_S,
      "host-blocked device->host decision read")
    h("asa_serve_batch_fill", FRACTION_BUCKETS,
      "live rows / batch_size per dispatched batch")
    return r


class ServeObs:
    """Registry + (optional) span recorder for one :class:`ASAServer`."""

    def __init__(self, registry: Optional[Registry] = None, *,
                 spans: bool = True, span_capacity: int = 1 << 18):
        self.registry = registry if registry is not None else \
            serve_registry()
        self.spans = bool(spans)
        self.epoch = time.perf_counter()
        self.events: deque[dict] = deque(maxlen=span_capacity)
        self._appended = 0
        self._rid = itertools.count()
        # hot-path handles (attribute loads beat dict lookups per call)
        g = self.registry
        self.c_requests = g.counter("asa_serve_requests_total")
        self.c_resolved = g.counter("asa_serve_resolved_total")
        self.c_failed = g.counter("asa_serve_failed_total")
        self.c_observations = g.counter("asa_serve_observations_total")
        self.c_deferrals = g.counter("asa_serve_deferrals_total")
        self.c_batches = g.counter("asa_serve_batches_total")
        self.c_decisions = g.counter("asa_serve_decisions_total")
        self.c_padded = g.counter("asa_serve_padded_rows_total")
        self.c_admissions = g.counter("asa_serve_admissions_total")
        self.c_evictions = g.counter("asa_serve_evictions_total")
        self.c_evicted_requests = g.counter(
            "asa_serve_evicted_requests_total")
        self.c_table_full = g.counter("asa_serve_table_full_total")
        self.c_checkpoints = g.counter("asa_serve_checkpoints_total")
        self.c_ckpt_stall_s = g.counter(
            "asa_serve_checkpoint_stall_seconds_total")
        self.c_ckpt_failures = g.counter(
            "asa_serve_checkpoint_failures_total")
        self.c_step_errors = g.counter("asa_serve_step_errors_total")
        self.c_shed = g.counter("asa_serve_shed_total")
        self.c_shed_expired = g.counter("asa_serve_shed_expired_total")
        self.c_shed_queue_full = g.counter(
            "asa_serve_shed_queue_full_total")
        self.c_lease_evictions = g.counter(
            "asa_serve_lease_evictions_total")
        self.c_crashes = g.counter("asa_serve_crashes_total")
        self.c_restarts = g.counter("asa_serve_restarts_total")
        self.c_stop_drained = g.counter("asa_serve_stop_drained_total")
        self.g_loop_healthy = g.gauge("asa_serve_loop_healthy")
        self.g_last_batch_age = g.gauge(
            "asa_serve_last_batch_age_seconds")
        self.g_tenants = g.gauge("asa_serve_tenants")
        self.g_free_slots = g.gauge("asa_serve_free_slots")
        self.g_deferred = g.gauge("asa_serve_deferred")
        self.g_inflight = g.gauge("asa_serve_inflight")
        self.h_latency = g.histogram("asa_serve_request_latency_seconds")
        self.h_device_step = g.histogram("asa_serve_device_step_seconds")
        self.h_scatter_read = g.histogram(
            "asa_serve_scatter_read_seconds")
        self.h_batch_fill = g.histogram("asa_serve_batch_fill")

    # ------------------------------------------------------------ recording
    # Buffered events are plain tuples, NOT dicts — the recorder sits on
    # the per-request hot path, where a dict (and its args sub-dict)
    # per event measurably moves the bench's serve_obs_overhead_frac;
    # the dict form is built once, at export time.  Tuple layout:
    #   (ph, name, pid, tid, t, dur, rid, aux)
    # with rid None for loop-lane events and aux either an error string
    # (request lane) or an args dict (loop lane, a few per batch).

    def now(self) -> float:
        """Wall-clock mark; 0.0 when spans are off (no syscall paid)."""
        return time.perf_counter() if self.spans else 0.0

    def next_rid(self) -> int:
        """Monotone request id (itertools.count: GIL-atomic)."""
        return next(self._rid)

    def _push(self, ev: tuple) -> None:
        self._appended += 1
        self.events.append(ev)

    @property
    def events_dropped(self) -> int:
        return self._appended - len(self.events)

    def enqueue(self, rid: int, tenant: int, t: float) -> None:
        # hottest record site (once per request, producer thread):
        # _push is inlined on purpose
        if self.spans:
            self._appended += 1
            self.events.append(("i", "enqueue", SERVE_REQUEST_PID,
                                tenant, t, 0.0, rid, None))

    def defer(self, rid: int, tenant: int, t: float) -> None:
        self.c_deferrals.inc()
        if self.spans:
            self._appended += 1
            self.events.append(("i", "defer", SERVE_REQUEST_PID,
                                tenant, t, 0.0, rid, None))

    def resolve(self, rid: int, tenant: int, t_enqueue: float, t: float,
                error: Optional[str] = None) -> None:
        """One request left the system (Decision or error) — the span
        closes here whatever path it took."""
        if error is None:
            self.c_resolved.inc()
        else:
            self.c_failed.inc()
        self.g_inflight.dec()
        if self.spans:
            dur = max(t - t_enqueue, 0.0)
            self.h_latency.observe(dur)
            self._push(("X", "request", SERVE_REQUEST_PID, tenant,
                        t_enqueue, dur, rid, error))

    def resolve_many(self, reqs, t: float) -> None:
        """Bulk success-resolve for one dispatched batch: identical
        accounting to per-request :meth:`resolve`, but one counter/lock
        round-trip per *batch* and a C-loop event extend — the
        per-request form is measurable in the bench's overhead budget.
        ``reqs`` is an iterable of objects with ``rid``/``tenant``/
        ``t_enqueue`` (the serve loop's ``Request``)."""
        reqs = list(reqs)
        n = len(reqs)
        self.c_resolved.inc(n)
        self.g_inflight.dec(n)
        if self.spans:
            evs = [("X", "request", SERVE_REQUEST_PID, r.tenant,
                    r.t_enqueue,
                    t - r.t_enqueue if t > r.t_enqueue else 0.0,
                    r.rid, None) for r in reqs]
            self.h_latency.observe_many([e[5] for e in evs])
            self._appended += n
            self.events.extend(evs)

    def span(self, name: str, t0: float, t1: float,
             args: Optional[dict] = None, tid: int = TID_LOOP) -> None:
        if self.spans:
            self._push(("X", name, SERVE_PID, tid, t0,
                        max(t1 - t0, 0.0), None, args))

    def instant(self, name: str, t: float, args: Optional[dict] = None,
                tid: int = TID_ADMISSION) -> None:
        if self.spans:
            self._push(("i", name, SERVE_PID, tid, t, 0.0, None, args))

    # -------------------------------------------------------------- derived
    def rates(self, since: Optional[dict[str, Any]] = None
              ) -> dict[str, float]:
        """Pad-fraction / defer-rate over the registry's lifetime, or
        over the delta since a prior ``registry.snapshot()``."""
        def delta(name: str) -> float:
            v = float(self.registry.counter(name).value)
            if since is not None:
                v -= float(since.get(name, 0))
            return v

        decisions = delta("asa_serve_decisions_total")
        padded = delta("asa_serve_padded_rows_total")
        requests = delta("asa_serve_requests_total")
        deferrals = delta("asa_serve_deferrals_total")
        dispatched = decisions + padded
        return {
            "pad_fraction": padded / dispatched if dispatched else 0.0,
            "defer_rate": deferrals / requests if requests else 0.0,
        }

    # ------------------------------------------------------------- export
    def chrome_events(self) -> list[dict]:
        """The serve timeline as chrome traceEvents: pid ``SERVE_PID``
        carries the loop-phase spans (tid 0) and admission instants
        (tid 1); pid ``SERVE_REQUEST_PID`` carries one lane per tenant
        with the request lifecycle spans.  Timestamps are µs since the
        ``ServeObs`` epoch."""
        out: list[dict] = [
            {"ph": "M", "pid": SERVE_PID, "name": "process_name",
             "args": {"name": "serve"}},
            {"ph": "M", "pid": SERVE_REQUEST_PID, "name": "process_name",
             "args": {"name": "serve/requests"}},
            {"ph": "M", "pid": SERVE_PID, "name": "serve_obs_meta",
             "args": {"events_kept": len(self.events),
                      "events_dropped": self.events_dropped,
                      "clock": "wall (perf_counter since epoch)"}},
        ]
        for ph, name, pid, tid, t, dur, rid, aux in self.events:
            if rid is not None:  # request lane: aux is an error (or None)
                args: dict = {"rid": rid, "tenant": tid}
                if aux is not None:
                    args["error"] = aux
            else:                # loop lane: aux is the args dict
                args = aux or {}
            ce = {"ph": ph, "pid": pid, "tid": tid, "name": name,
                  "cat": "serve", "ts": (t - self.epoch) * _US,
                  "args": args}
            if ph == "X":
                ce["dur"] = dur * _US
            else:
                ce["s"] = "t"
            out.append(ce)
        return out

"""Host-side live-metrics registry: counters, gauges, fixed-bucket
histograms (the port's own copy of ``repro.obs.registry``, line for line
below this docstring).

``obs.metrics`` reduces *device-side* state after a sweep finishes; this
module is its host-side dual for long-running processes (the serving loop
above all): metrics mutated on the hot path and scraped while the process
runs.

1. **Low overhead.** One uncontended ``threading.Lock`` acquire per
   mutation; scrapes snapshot metric by metric, so a slow scraper cannot
   stall the serve loop.
2. **Stdlib only**, like ``obs.telemetry``: importing this module pulls
   neither ``torch`` nor any other module of the port.
3. **Fixed buckets.** Histograms use a geometric bucket ladder fixed at
   construction (53 bins by default, the paper's m = 53 wait
   alternatives), so snapshots from different processes merge bucket for
   bucket.

Exposition: ``Registry.prometheus_text()`` (the Prometheus text format
0.0.4, served by ``serve.loop.ASAServer`` under ``GET /metrics``) and
``Registry.snapshot()`` (a flat JSON-safe dict, served under
``GET /metrics.json``). Counters are monotone (``inc`` rejects negative
deltas).
"""

from __future__ import annotations

import bisect
import json
import math
import threading
from typing import Any, Optional

# mirror of core.bins.M_DEFAULT, kept here so the module stays stdlib-only
M_BUCKETS_DEFAULT = 53


def geometric_buckets(lo: float, hi: float,
                      n: int = M_BUCKETS_DEFAULT) -> tuple[float, ...]:
    """``n`` log-uniform bucket upper bounds spanning [lo, hi] — the same
    ladder shape as ``core.bins.make_bins`` builds for the §4.5 wait
    alternatives (geometric from the smallest to the largest bucket)."""
    if not (0.0 < lo < hi):
        raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
    if n < 2:
        raise ValueError(f"need n >= 2 buckets, got {n}")
    r = math.log(hi / lo) / (n - 1)
    return tuple(lo * math.exp(r * i) for i in range(n))


# default latency ladder: 100 µs .. 100 s, 53 geometric buckets — wide
# enough for a jitted decision batch (ms) and a cold compile (tens of s)
LATENCY_BUCKETS_S = geometric_buckets(1e-4, 100.0)

# default fraction ladder for pad-fraction/fill-style observations
FRACTION_BUCKETS = tuple((i + 1) / 20.0 for i in range(20))


class _Metric:
    """Shared bookkeeping: name, help text, one cheap lock."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self._lock = threading.Lock()


class Counter(_Metric):
    """Monotone event count (float deltas allowed, never negative)."""

    kind = "counter"

    def __init__(self, name: str, help: str = "") -> None:
        super().__init__(name, help)
        self._value = 0

    def inc(self, n: int | float = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative inc {n}")
        with self._lock:
            self._value += n

    @property
    def value(self) -> int | float:
        return self._value

    def snapshot(self) -> int | float:
        return self._value


class Gauge(_Metric):
    """A value that goes both ways (queue depth, tenants, free slots).

    A gauge can instead be **fn-backed** (``set_fn``): the value is
    computed by a callback at snapshot/scrape time rather than pushed by
    the hot path — right for derived freshness signals like
    last-batch-age, where the interesting value keeps changing while the
    loop is *not* running.  The callback must be cheap and must never
    raise; a raising callback reads as 0.0 rather than killing a scrape.
    """

    kind = "gauge"

    def __init__(self, name: str, help: str = "") -> None:
        super().__init__(name, help)
        self._value = 0.0
        self._fn = None

    def set(self, v: float) -> None:
        with self._lock:
            self._fn = None
            self._value = v

    def set_fn(self, fn) -> None:
        """Back the gauge with ``fn() -> float``, evaluated per snapshot
        (``set`` reverts to a plain pushed gauge)."""
        with self._lock:
            self._fn = fn

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self) -> float:
        return self.snapshot()

    def snapshot(self) -> float:
        fn = self._fn
        if fn is not None:
            try:
                return float(fn())
            except Exception:
                return 0.0
        return self._value


class Histogram(_Metric):
    """Fixed-bucket histogram (bucket uppers set at construction).

    ``observe`` bisects the (sorted) upper-bound ladder; values above
    the last bound land in the implicit +Inf overflow bucket.  The
    stored counts are per-bucket (not cumulative); the Prometheus
    exposition cumulates on the way out, as the format requires.
    """

    kind = "histogram"

    def __init__(self, name: str, buckets: tuple[float, ...],
                 help: str = "") -> None:
        super().__init__(name, help)
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError(f"histogram {name}: buckets must be a "
                             f"non-empty ascending sequence")
        self.buckets = tuple(float(b) for b in buckets)
        self._counts = [0] * (len(self.buckets) + 1)  # +1: +Inf overflow
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def observe_many(self, values) -> None:
        """Bulk observe under ONE lock acquisition — the serving loop
        resolves a whole batch at once, and a lock round-trip per
        request is measurable at full decision rate."""
        b = self.buckets
        with self._lock:
            n = 0
            for v in values:
                self._counts[bisect.bisect_left(b, v)] += 1
                self._sum += v
                n += 1
            self._count += n

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            counts = list(self._counts)
            s, c = self._sum, self._count
        return {"buckets": list(self.buckets), "counts": counts,
                "sum": s, "count": c}


class Registry:
    """A named collection of metrics with one-call exposition.

    ``counter``/``gauge``/``histogram`` are get-or-create (idempotent by
    name, TypeError on a kind clash), so instrumentation sites never
    need registration order.  All names should share a prefix
    (``asa_serve_`` for the serving loop) so scrapes from different
    subsystems can be federated.
    """

    def __init__(self) -> None:
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help: str, *args) -> Any:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, *args, help=help) if args else \
                    cls(name, help=help)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{m.kind}, not {cls.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str,
                  buckets: tuple[float, ...] = LATENCY_BUCKETS_S,
                  help: str = "") -> Histogram:
        return self._get(Histogram, name, help, buckets)

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    # ---------------------------------------------------------- exposition
    def snapshot(self) -> dict[str, Any]:
        """Flat JSON-safe view: one key per metric (histograms nest)."""
        out: dict[str, Any] = {}
        for name in sorted(self._metrics):
            out[name] = self._metrics[name].snapshot()
        return out

    def json_line(self, **extra: Any) -> str:
        """One JSONL snapshot line (``extra`` merges in, e.g. a ts)."""
        return json.dumps({**extra, **self.snapshot()},
                          separators=(",", ":"))

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines: list[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            if isinstance(m, Histogram):
                snap = m.snapshot()
                cum = 0
                for ub, c in zip(snap["buckets"], snap["counts"]):
                    cum += c
                    lines.append(f'{name}_bucket{{le="{ub:.6g}"}} {cum}')
                cum += snap["counts"][-1]
                lines.append(f'{name}_bucket{{le="+Inf"}} {cum}')
                lines.append(f"{name}_sum {snap['sum']:.9g}")
                lines.append(f"{name}_count {snap['count']}")
            else:
                v = m.snapshot()
                lines.append(f"{name} {v:.9g}" if isinstance(v, float)
                             else f"{name} {v}")
        return "\n".join(lines) + "\n"

"""The unified telemetry schema (the port's own copy of
``repro.obs.telemetry``, line for line below its docstring).

One JSON object per run leg. The module is **stdlib-only**: importing it
pulls neither ``torch`` nor any other module of the port, so a record can
be checked from a bare checkout (``python -m repro_torch.obs.export
--validate f.json`` reads records through it).

Schema v1 (a "record"):

    {
      "telemetry_version": 1,
      "kind": "xsim_throughput" | "xsim_strategies" | "rl_train"
              | "serve_latency" | "serve_metrics" | "serve_chaos",
      "run": {...},        # runner identity: label/config/flags
      "profile": {...},    # timing: compile_s, steady_s, scenarios_per_sec,
                           #         us_per_scenario, (trace_overhead_frac)
      "metrics": {...},    # obs.metrics fleet summary (counters/histograms)
      "trace": {...}|null, # trace meta: capacity/events/dropped/path
    }

``kind`` determines which sections are required (REQUIRED_SECTIONS).
Unknown extra keys are allowed — the version only bumps when an existing
field changes meaning or a required one disappears.  An unknown ``kind``
is a *warn-level* validation entry, not a hard failure (forward
compatibility: a newer runner's record still merges; see
``is_warning``/``hard_errors``).
"""

from __future__ import annotations

from typing import Any

TELEMETRY_VERSION = 1

KINDS = ("xsim_throughput", "xsim_strategies", "rl_train",
         "serve_latency", "serve_metrics", "serve_chaos")

# sections a record of each kind must carry ("trace" may be None but the
# key itself must exist — it says "tracing was off", not "schema unknown")
_SECTIONS = ("run", "profile", "metrics", "trace")
REQUIRED_SECTIONS: dict[str, tuple[str, ...]] = {
    "xsim_throughput": _SECTIONS,
    "xsim_strategies": _SECTIONS,
    "rl_train": _SECTIONS,
    "serve_latency": _SECTIONS,
    # registry snapshot of the serving loop (benchmarks/serve_latency.py
    # --metrics-json): profile carries the batching-health rates the
    # gate consumes, metrics the raw obs.registry snapshot
    "serve_metrics": _SECTIONS,
    # chaos soak (benchmarks/serve_chaos.py): profile carries fault
    # recovery percentiles + the zero-hung-futures invariant the gate
    # enforces, metrics the final obs.registry snapshot
    "serve_chaos": _SECTIONS,
}

WARNING_PREFIX = "warning: "

# profile keys bench_gate gates on for throughput legs
PROFILE_REQUIRED = ("scenarios_per_sec", "us_per_scenario")

# profile keys bench_gate gates on for serving legs (benchmarks/
# serve_latency.py): decision latency percentiles + sustained rate
SERVE_PROFILE_REQUIRED = ("p50_ms", "p99_ms", "decisions_per_sec")

# profile keys a serve_metrics record must carry (batching health:
# fraction of dispatched rows that were padding, fraction of requests
# the dedup batcher deferred)
SERVE_METRICS_PROFILE_REQUIRED = ("pad_fraction", "defer_rate")

# profile keys a serve_chaos record must carry: p99 seconds from fault
# injection to next successful resolve, count of futures never resolved
# (the invariant: must be 0), and shed requests / submitted requests
CHAOS_PROFILE_REQUIRED = ("recovery_p99_ms", "hung_futures", "shed_rate")


def is_warning(msg: str) -> bool:
    """True for warn-level validation entries (unknown ``kind`` above
    all) — consumers list them but must not hard-fail on them."""
    return msg.startswith(WARNING_PREFIX)


def hard_errors(msgs: list[str]) -> list[str]:
    """The subset of :func:`validate` entries that invalidate a record."""
    return [m for m in msgs if not is_warning(m)]


def record(kind: str, *, run: dict[str, Any], profile: dict[str, Any],
           metrics: dict[str, Any], trace: dict[str, Any] | None = None,
           ) -> dict[str, Any]:
    """Assemble a schema-v1 telemetry record (validates on the way out)."""
    rec = {"telemetry_version": TELEMETRY_VERSION, "kind": kind,
           "run": run, "profile": profile, "metrics": metrics,
           "trace": trace}
    errs = hard_errors(validate(rec))
    if errs:
        raise ValueError("invalid telemetry record: " + "; ".join(errs))
    return rec


def is_telemetry(obj: Any) -> bool:
    """Loose sniff: does this JSON object claim to be a telemetry record?"""
    return isinstance(obj, dict) and "telemetry_version" in obj


def validate(rec: Any) -> list[str]:
    """Return a list of schema violations (empty ⇒ valid).

    Collects every problem instead of raising on the first so CI's
    trace-smoke leg can print them all at once.  An unknown ``kind`` is
    a **warn-level** entry (``warning: ...`` prefix — schema v1 allows
    forward-compatible kinds; the standard four sections are still
    required), never a hard failure; split the two with
    :func:`hard_errors` / :func:`is_warning`.
    """
    errs: list[str] = []
    if not isinstance(rec, dict):
        return [f"record is {type(rec).__name__}, expected object"]
    ver = rec.get("telemetry_version")
    if ver != TELEMETRY_VERSION:
        errs.append(f"telemetry_version is {ver!r}, "
                    f"expected {TELEMETRY_VERSION}")
    kind = rec.get("kind")
    if not isinstance(kind, str) or not kind:
        errs.append(f"kind is {kind!r}, expected a non-empty string "
                    f"(known kinds: {KINDS})")
        return errs
    if kind not in KINDS:
        errs.append(f"{WARNING_PREFIX}kind {kind!r} is not a known kind "
                    f"{KINDS}; validating the standard sections only")
    for sec in REQUIRED_SECTIONS.get(kind, _SECTIONS):
        if sec not in rec:
            errs.append(f"missing section {sec!r}")
        elif sec != "trace" and not isinstance(rec[sec], dict):
            errs.append(f"section {sec!r} is "
                        f"{type(rec[sec]).__name__}, expected object")
    tr = rec.get("trace")
    if tr is not None and not isinstance(tr, dict):
        errs.append(f"section 'trace' is {type(tr).__name__}, "
                    "expected object or null")
    prof = rec.get("profile")
    if kind in ("xsim_throughput",) and isinstance(prof, dict):
        for k in PROFILE_REQUIRED:
            if k not in prof:
                errs.append(f"profile missing {k!r}")
    if kind == "serve_latency" and isinstance(prof, dict):
        for k in SERVE_PROFILE_REQUIRED:
            if k not in prof:
                errs.append(f"profile missing {k!r}")
    if kind == "serve_metrics" and isinstance(prof, dict):
        for k in SERVE_METRICS_PROFILE_REQUIRED:
            if k not in prof:
                errs.append(f"profile missing {k!r}")
    if kind == "serve_chaos" and isinstance(prof, dict):
        for k in CHAOS_PROFILE_REQUIRED:
            if k not in prof:
                errs.append(f"profile missing {k!r}")
    return errs


def throughput_leg(rec: dict[str, Any]) -> dict[str, Any]:
    """Flatten a throughput record into bench_gate's leg view.

    Returns ``{"freed_mode", "n_shards", "traced", "scenarios_per_sec",
    "us_per_scenario", ...profile}`` — raises KeyError-free ValueError
    naming what is missing (bench_gate surfaces it per leg).
    Warn-level entries (unknown kinds) never raise.
    """
    errs = hard_errors(validate(rec))
    if errs:
        raise ValueError("; ".join(errs))
    run, prof = rec["run"], rec["profile"]
    leg = dict(prof)
    leg["freed_mode"] = run.get("freed_mode", "ref")
    leg["n_shards"] = run.get("n_shards")
    leg["traced"] = bool(run.get("traced", False))
    leg["label"] = run.get("label", "")
    return leg


def serve_leg(rec: dict[str, Any]) -> dict[str, Any]:
    """Flatten a serve_latency record into bench_gate's leg view:
    the gated profile (p50/p99 decision latency, decisions/sec, plus the
    batching-health rates pad_fraction/defer_rate when present) and the
    run identity (mode, shards, tenants, batch size).  Raises ValueError
    naming what is missing, like ``throughput_leg``."""
    errs = hard_errors(validate(rec))
    if errs:
        raise ValueError("; ".join(errs))
    if rec.get("kind") != "serve_latency":
        raise ValueError(f"kind is {rec.get('kind')!r}, "
                         "expected 'serve_latency'")
    run, prof = rec["run"], rec["profile"]
    leg = dict(prof)
    # batching health may ride in either section (the bench emits it in
    # profile; older records carried it in metrics) — flatten both
    met = rec.get("metrics") or {}
    for k in ("pad_fraction", "defer_rate"):
        if k not in leg and k in met:
            leg[k] = met[k]
    leg["n_shards"] = run.get("n_shards")
    leg["label"] = run.get("label", "")
    leg["mode"] = run.get("mode", "open")
    for k in ("n_tenants", "n_slots", "batch_size", "backend"):
        if k in run:
            leg[k] = run[k]
    return leg


def serve_metrics_leg(rec: dict[str, Any]) -> dict[str, Any]:
    """Flatten a serve_metrics record (the serving loop's registry
    snapshot): the profile rates plus a handful of headline counters
    from the raw registry snapshot in ``metrics``."""
    errs = hard_errors(validate(rec))
    if errs:
        raise ValueError("; ".join(errs))
    if rec.get("kind") != "serve_metrics":
        raise ValueError(f"kind is {rec.get('kind')!r}, "
                         "expected 'serve_metrics'")
    run, prof = rec["run"], rec["profile"]
    leg = dict(prof)
    leg["n_shards"] = run.get("n_shards")
    leg["label"] = run.get("label", "")
    snap = rec.get("metrics") or {}
    for k in ("asa_serve_requests_total", "asa_serve_resolved_total",
              "asa_serve_failed_total", "asa_serve_deferrals_total",
              "asa_serve_evictions_total",
              "asa_serve_evicted_requests_total"):
        if k in snap:
            leg[k] = snap[k]
    return leg


def serve_chaos_leg(rec: dict[str, Any]) -> dict[str, Any]:
    """Flatten a serve_chaos record (the chaos soak) into bench_gate's
    leg view: the gated profile (recovery_p99_ms, hung_futures,
    shed_rate, plus whatever else the soak reports) and the headline
    fault/recovery counters from the final registry snapshot."""
    errs = hard_errors(validate(rec))
    if errs:
        raise ValueError("; ".join(errs))
    if rec.get("kind") != "serve_chaos":
        raise ValueError(f"kind is {rec.get('kind')!r}, "
                         "expected 'serve_chaos'")
    run, prof = rec["run"], rec["profile"]
    leg = dict(prof)
    leg["label"] = run.get("label", "")
    for k in ("seed", "n_tenants", "max_queue", "duration_s"):
        if k in run:
            leg[k] = run[k]
    snap = rec.get("metrics") or {}
    for k in ("asa_serve_step_errors_total", "asa_serve_crashes_total",
              "asa_serve_restarts_total", "asa_serve_shed_total",
              "asa_serve_lease_evictions_total",
              "asa_serve_checkpoint_failures_total",
              "asa_serve_stop_drained_total"):
        if k in snap:
            leg[k] = snap[k]
    return leg

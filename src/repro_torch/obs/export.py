"""Host-side trace decoding → Chrome trace-event JSON / JSONL (port of
``repro.obs.export``).

``chrome_trace`` turns a swept batch's ring buffers into the Chrome
trace-event format (one *process* track per scenario, one *thread* per
job row): matched start→finish pairs become complete-event spans
(``ph: "X"``), submits/cancels/resubmits become instants (``ph: "i"``),
and per-scenario metadata carries the ring accounting (events ever
appended, kept, dropped) plus ``ScenarioState.steps`` so a trace can be
cross-checked against the state it came from. Open the file directly in
Perfetto / ``chrome://tracing``.

``jsonl_events`` is the structured-log view: one JSON object per decoded
event, ready for ad-hoc ``jq``/pandas work.

``merged_chrome_trace``/``write_merged_trace`` add the serving loop's
request-lifecycle spans (``obs.serve_obs``) to the rings, on reserved pid
rows above every scenario's.

``profile_session`` wraps a ``torch.profiler`` session that writes its
Chrome trace into a directory (warm-up against steady attribution:
annotate the first rep with ``annotate("warmup")`` and the rest with
``annotate("steady")``).

Run ``python -m repro_torch.obs.export --validate f.json ...`` to check a
Chrome trace or telemetry file against its schema.
"""

from __future__ import annotations

import contextlib
import json
from typing import Any

import numpy as np

from repro_torch.obs import trace as obtrace
from repro_torch.obs.trace import (EV_CANCEL, EV_FINISH, EV_KILL, EV_RESUBMIT,
                                   EV_START, EV_SUBMIT, EVENT_NAMES)

_US = 1_000_000.0  # chrome ts unit: microseconds; sim time is seconds


def _scenario_events(events: dict[str, np.ndarray], meta: dict,
                     pid: int, final_t: float) -> list[dict]:
    """One scenario's decoded ring → chrome traceEvents (pid = scenario).

    Spans pair each job's START with its next FINISH; a START with no
    FINISH (still running / budget truncation) closes at the scenario's
    final sim time so Perfetto shows the dangling allocation.
    """
    out: list[dict] = []
    open_start: dict[int, tuple[float, int, float]] = {}  # job → (t, stage, cores)
    for i in range(len(events["kind"])):
        kind = int(events["kind"][i])
        t = float(events["t"][i])
        job = int(events["job"][i])
        stage = int(events["stage"][i])
        cores = float(events["cores"][i])
        args = {"job": job, "stage": stage, "cores": cores,
                "step": int(events["step"][i])}
        if kind == EV_START:
            open_start[job] = (t, stage, cores)
        elif kind == EV_FINISH and job in open_start:
            t0, st0, c0 = open_start.pop(job)
            out.append({"ph": "X", "pid": pid, "tid": job,
                        "name": f"run j{job}" + (f" s{st0}" if st0 >= 0
                                                 else ""),
                        "cat": "run", "ts": t0 * _US,
                        "dur": max(t - t0, 0.0) * _US,
                        "args": {**args, "stage": st0, "cores": c0}})
        elif kind in (EV_SUBMIT, EV_CANCEL, EV_RESUBMIT, EV_KILL):
            if kind == EV_CANCEL:
                open_start.pop(job, None)  # cancelled at its start instant
            elif kind == EV_KILL and job in open_start:
                # killed mid-run by a node failure: close the open
                # allocation span at the kill instant (the lost attempt)
                t0, st0, c0 = open_start.pop(job)
                out.append({"ph": "X", "pid": pid, "tid": job,
                            "name": f"run j{job} (killed)", "cat": "run",
                            "ts": t0 * _US,
                            "dur": max(t - t0, 0.0) * _US,
                            "args": {**args, "stage": st0, "cores": c0}})
            out.append({"ph": "i", "pid": pid, "tid": job, "s": "t",
                        "name": EVENT_NAMES[kind], "cat": EVENT_NAMES[kind],
                        "ts": t * _US, "args": args})
        elif kind == EV_FINISH:  # finish whose start was overwritten
            out.append({"ph": "i", "pid": pid, "tid": job, "s": "t",
                        "name": "finish", "cat": "finish", "ts": t * _US,
                        "args": args})
    for job, (t0, st0, c0) in sorted(open_start.items()):
        out.append({"ph": "X", "pid": pid, "tid": job,
                    "name": f"run j{job} (open)", "cat": "run",
                    "ts": t0 * _US, "dur": max(final_t - t0, 0.0) * _US,
                    "args": {"job": job, "stage": st0, "cores": c0,
                             "open": True}})
    return out


def chrome_trace(final, labels: list[dict] | None = None) -> dict[str, Any]:
    """A batched final ``ScenarioState`` (with trace) → chrome trace dict.

    ``labels`` (e.g. ``ScenarioGrid.labels``) name each scenario's
    process track; scenario accounting (ring totals + ``steps``) rides in
    per-scenario ``trace_meta`` metadata events.
    """
    if final.trace is None:
        raise ValueError("final state carries no trace buffer; build the "
                         "grid with trace_capacity > 0 (XSimConfig) or "
                         "state.freeze(trace_capacity=...)")
    decoded = obtrace.decode_batch(final.trace)
    steps = final.steps.cpu().numpy()
    final_t = final.t.cpu().numpy()
    te: list[dict] = []
    for pid, (events, meta) in enumerate(decoded):
        name = f"scenario {pid}"
        if labels is not None:
            lab = labels[pid]
            name = (f"{lab.get('center', '?')}/{lab.get('workflow', '?')}/"
                    f"{lab.get('strategy', '?')}#{lab.get('seed', pid)}")
        te.append({"ph": "M", "pid": pid, "name": "process_name",
                   "args": {"name": name}})
        te.append({"ph": "M", "pid": pid, "name": "trace_meta",
                   "args": {**meta, "steps": int(steps[pid])}})
        te.extend(_scenario_events(events, meta, pid, float(final_t[pid])))
    return {"traceEvents": te, "displayTimeUnit": "ms",
            "otherData": {"format": "repro.obs.chrome_trace", "version": 1,
                          "n_scenarios": len(decoded)}}


def merged_chrome_trace(final=None, labels: list[dict] | None = None,
                        serve=None) -> dict[str, Any]:
    """One Chrome trace interleaving the device event rings with the
    serve-side request-lifecycle timeline.

    ``final`` is a batched final ``ScenarioState`` carrying a trace (or
    None for a serve-only file); ``serve`` is an
    ``obs.serve_obs.ServeObs``. The serve rows land on the reserved pids
    ``serve_obs.SERVE_PID``/``SERVE_REQUEST_PID``, checked to lie above
    every scenario pid, so one file never collides ids between the two
    sources. Scenario rows tick in simulated seconds, serve rows in
    wall-clock seconds since the ``ServeObs`` epoch: separate process
    tracks, not aligned clocks.
    """
    from repro_torch.obs import serve_obs as sobs

    if final is None and serve is None:
        raise ValueError("merged_chrome_trace needs a traced final "
                         "state, a ServeObs, or both")
    if final is not None:
        out = chrome_trace(final, labels)
    else:
        out = {"traceEvents": [], "displayTimeUnit": "ms",
               "otherData": {"format": "repro.obs.chrome_trace",
                             "version": 1, "n_scenarios": 0}}
    if serve is not None:
        n = out["otherData"]["n_scenarios"]
        if n >= sobs.SERVE_PID:
            raise ValueError(
                f"{n} scenario pids reach the reserved serve pid "
                f"{sobs.SERVE_PID}; shrink the fleet or move SERVE_PID")
        out["traceEvents"].extend(serve.chrome_events())
        out["otherData"]["serve_pid"] = sobs.SERVE_PID
        out["otherData"]["serve_request_pid"] = sobs.SERVE_REQUEST_PID
    return out


def write_merged_trace(path: str, final=None, labels=None,
                       serve=None) -> dict[str, Any]:
    """Export + write the merged trace; returns a small accounting dict
    for the telemetry record (event counts per source + the path)."""
    merged = merged_chrome_trace(final, labels, serve)
    with open(path, "w") as f:
        json.dump(merged, f)
    meta: dict[str, Any] = {"path": path,
                            "n_scenarios": merged["otherData"]
                            ["n_scenarios"],
                            "events_total": len(merged["traceEvents"])}
    if serve is not None:
        meta["serve_events_kept"] = len(serve.events)
        meta["serve_events_dropped"] = serve.events_dropped
    return meta


def jsonl_events(final, labels: list[dict] | None = None) -> list[dict]:
    """Structured-log view: one dict per decoded event, all scenarios."""
    if final.trace is None:
        raise ValueError("final state carries no trace buffer")
    rows: list[dict] = []
    for sid, (events, meta) in enumerate(obtrace.decode_batch(final.trace)):
        lab = labels[sid] if labels is not None else {}
        for i in range(len(events["kind"])):
            rows.append({
                "scenario": sid,
                "event": EVENT_NAMES.get(int(events["kind"][i]), "?"),
                "t": float(events["t"][i]),
                "job": int(events["job"][i]),
                "stage": int(events["stage"][i]),
                "cores": float(events["cores"][i]),
                "policy": int(events["policy"][i]),
                "step": int(events["step"][i]),
                **{k: lab[k] for k in ("center", "workflow", "strategy")
                   if k in lab},
            })
    return rows


def trace_meta(final) -> dict[str, Any]:
    """Telemetry ``trace`` section: fleet-level ring accounting."""
    if final.trace is None:
        return None
    head = final.trace.head.cpu().numpy()
    C = obtrace.capacity(final.trace)
    return {"capacity": C,
            "n_scenarios": int(head.shape[0]),
            "events_total": int(head.sum()),
            "events_dropped": int(np.maximum(head - C, 0).sum()),
            "scenarios_overflowed": int((head > C).sum())}


def write_chrome_trace(path: str, final, labels=None) -> dict[str, Any]:
    """Export + write a chrome trace; returns its ``trace_meta`` section
    (with the output ``path`` added) for the telemetry record."""
    with open(path, "w") as f:
        json.dump(chrome_trace(final, labels), f)
    meta = trace_meta(final)
    meta["path"] = path
    return meta


def write_jsonl(path: str, final, labels=None) -> int:
    """Write the JSONL view; returns the number of event rows."""
    rows = jsonl_events(final, labels)
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return len(rows)


# --------------------------------------------- torch.profiler attribution


@contextlib.contextmanager
def profile_session(logdir: str | None):
    """A ``torch.profiler`` session around a section (None = off): the
    host's operations and, where there is a card, its kernels; the Chrome
    trace is written into ``logdir`` when the section ends."""
    if logdir is None:
        yield
        return
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


def annotate(name: str):
    """Named profiler span (e.g. "warmup" for rep 0, "steady" after)."""
    import torch

    return torch.profiler.record_function(name)


# ------------------------------------------------------- schema validation


def validate_chrome(obj: Any) -> list[str]:
    """Structural check of an exported chrome trace (empty ⇒ valid)."""
    errs: list[str] = []
    if not isinstance(obj, dict):
        return [f"trace is {type(obj).__name__}, expected object"]
    te = obj.get("traceEvents")
    if not isinstance(te, list):
        return [f"traceEvents is {type(te).__name__}, expected list"]
    for i, ev in enumerate(te):
        if not isinstance(ev, dict):
            errs.append(f"traceEvents[{i}] is not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "i", "M"):
            errs.append(f"traceEvents[{i}] has ph={ph!r}")
        if ph != "M" and not isinstance(ev.get("ts"), (int, float)):
            errs.append(f"traceEvents[{i}] ({ev.get('name')}) missing ts")
        if ph == "X" and not isinstance(ev.get("dur"), (int, float)):
            errs.append(f"traceEvents[{i}] ({ev.get('name')}) missing dur")
        if "pid" not in ev:
            errs.append(f"traceEvents[{i}] missing pid")
        if len(errs) > 20:
            errs.append("... (further errors suppressed)")
            break
    return errs


def validate_file(path: str) -> list[str]:
    """Validate one JSON file as telemetry or a chrome trace (by sniff)."""
    from repro_torch.obs import telemetry

    try:
        with open(path) as f:
            obj = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return [f"{path}: unreadable ({e})"]
    if telemetry.is_telemetry(obj):
        msgs = telemetry.validate(obj)
        for w in msgs:
            if telemetry.is_warning(w):
                print(f"{path}: {w}")
        errs = telemetry.hard_errors(msgs)
    elif isinstance(obj, dict) and "traceEvents" in obj:
        errs = validate_chrome(obj)
    else:
        errs = ["neither a telemetry record (telemetry_version) nor a "
                "chrome trace (traceEvents)"]
    return [f"{path}: {e}" for e in errs]


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="validate exported telemetry / chrome-trace JSON")
    ap.add_argument("--validate", nargs="+", metavar="FILE", required=True)
    args = ap.parse_args(argv)
    failures = []
    for path in args.validate:
        errs = validate_file(path)
        failures.extend(errs)
        print(f"{'FAIL' if errs else 'ok':4s} {path}")
    for e in failures:
        print(f"  {e}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())

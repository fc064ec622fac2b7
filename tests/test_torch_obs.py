"""The port's observability layer (``repro_torch.obs``) on the CPU.

Two parts.

* The contracts of ``tests/test_obs.py``, rerun on the port's own traced
  sweeps: ring append order and decode, overflow dropping the oldest
  events, fused against chained appends, bad capacities refused, the
  untraced path bit-identical, a small ring changing only the trace, the
  Chrome export's round trip and validation, the ``--validate`` CLI, the
  differential replay of the ASA chain's waits, the ``sweep_summary``
  counters, ``backfill_hits`` on a crafted scenario, and the telemetry
  copy.
* Parity with the reference: reference-built traced states (the 12
  scenarios of ``test_obs.py``: hpc2n, blast, policies 0-3, 1/64 size,
  ``pred_seed=3``; and a naive ``faulty`` family grid, where kills,
  cancels and resubmits occur) are carried across with
  ``repro_torch.convert`` and swept by both packages. Decoded rings:
  ``kind``, ``job``, ``stage``, ``policy``, ``step``, ``cores`` and the
  head exact, ``t`` within ``TIME_RTOL`` (relative to max(|t|, 1);
  measured worst case 0.0 on both grids). ``sweep_summary``: counters
  and the wait histogram exact, ``oh_core_hours`` and ``steps_frac``
  within ``SUMMARY_RTOL`` (measured worst case 1.3e-7 on the faulty
  grid, ``oh_core_hours``: the order of the batch sum).
"""

from __future__ import annotations

import functools
import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import asa as jasa
from repro.obs import metrics as jmetrics
from repro.obs import trace as JT
from repro.xsim import events as jevents
from repro.xsim import families as jfamilies
from repro.xsim import grid as jgrid
from repro.xsim import policies as jpolicies
from repro.xsim import state as X
from repro_torch import convert
from repro_torch.obs import export as obs_export
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import telemetry
from repro_torch.obs import trace as T
from repro_torch.xsim import compare as tcompare
from repro_torch.xsim import events as tevents
from repro_torch.xsim import families as tfamilies
from repro_torch.xsim import policies as tpolicies
from repro_torch.xsim.grid import XSimConfig, make_grid, run_grid
from repro_torch.xsim.state import (ASA, ASA_NAIVE, BIGJOB, PER_STAGE,
                                    QUEUED, RUNNING)

jax.config.update("jax_threefry_partitionable", True)
torch.set_num_threads(1)   # small tensors: threads only contend

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
TIME_RTOL = 1e-5
SUMMARY_RTOL = 1e-5
TINY = dict(n_warm=8, n_backlog=6, n_arrivals=8, max_stages=9, t0=1800.0)
POLICIES = (BIGJOB, PER_STAGE, ASA, ASA_NAIVE)


def tiny_cfg(**kw) -> XSimConfig:
    return XSimConfig(**TINY, **kw)


def tiny_grid(cfg):
    # hpc2n has 3 paper scales → B = 3 · 4 policies = 12 scenarios
    return make_grid(cfg, center_names=("hpc2n",), workflows=("blast",),
                     policy_ids=POLICIES, n_seeds=1, shrink=1 / 64.0,
                     device=CPU)


def _t(*xs, dtype=torch.float32):
    return torch.tensor([list(xs)], dtype=dtype)


def _i(*xs):
    return _t(*xs, dtype=torch.int32)


def _one(v, dtype=torch.float32):
    return torch.tensor([v], dtype=dtype)


@pytest.fixture(scope="module")
def runs():
    """One untraced and one traced sweep of the port over the same
    12-scenario grid."""
    cfg = tiny_cfg()
    tcfg = cfg.with_trace()                    # default 4·max_jobs slots
    grid = tiny_grid(cfg)
    fleet = tpolicies.init_fleet(int(grid.geo_idx.max()) + 1, device=CPU)
    fu, mu = run_grid(grid, fleet, pred_seed=3, device=CPU)
    tgrid = tiny_grid(tcfg)
    ft, mt = run_grid(tgrid, fleet, pred_seed=3, device=CPU)
    return SimpleNamespace(cfg=cfg, tcfg=tcfg, fleet=fleet, fu=fu, mu=mu,
                           ft=ft, mt=mt, grid=tgrid)


# ------------------------------------------------------- ring buffer unit


def test_ring_append_order_and_decode():
    tr = T.init(4, 1, device=CPU)
    tr = T.append_masked(tr, torch.tensor([[True, False, True, True]]),
                         kind=T.EV_SUBMIT, t=_one(1.5),
                         job=torch.arange(4, dtype=torch.int32)[None],
                         stage=torch.arange(4, dtype=torch.int32)[None],
                         cores=torch.full((1, 4), 2.0),
                         policy=_one(ASA, torch.int32),
                         step=_one(1, torch.int32))
    ev, meta = T.decode(tr)
    assert meta == {"capacity": 4, "total": 3, "kept": 3, "dropped": 0,
                    "overflowed": False}
    np.testing.assert_array_equal(ev["job"], [0, 2, 3])     # lane order
    np.testing.assert_array_equal(ev["kind"], [T.EV_SUBMIT] * 3)
    np.testing.assert_array_equal(ev["t"], [1.5] * 3)
    assert ev["job"].dtype == np.int32 and ev["t"].dtype == np.float32

    one = dict(policy=_one(ASA, torch.int32))
    tr = T.append_if(tr, _one(True, torch.bool), kind=T.EV_START,
                     t=_one(2.0), job=_one(7, torch.int32),
                     stage=_one(1, torch.int32), cores=_one(2.0),
                     step=_one(2, torch.int32), **one)
    ev, meta = T.decode(tr)
    assert meta["total"] == 4 and not meta["overflowed"]
    np.testing.assert_array_equal(ev["job"], [0, 2, 3, 7])

    # a False flag appends nothing at all
    tr2 = T.append_if(tr, _one(False, torch.bool), kind=T.EV_CANCEL,
                      t=_one(9.0), job=_one(9, torch.int32),
                      stage=_one(0, torch.int32), cores=_one(1.0),
                      step=_one(3, torch.int32), **one)
    assert torch.equal(tr2.data, tr.data) and torch.equal(tr2.head, tr.head)


def test_ring_lanes_are_independent_scenarios():
    """A batch of rings: each scenario slides by its own count."""
    tr = T.init(3, 2, device=CPU)
    mask = torch.tensor([[True, True, False], [False, False, True]])
    job = torch.tensor([[0, 1, 2], [3, 4, 5]], dtype=torch.int32)
    kw = dict(kind=T.EV_FINISH, t=torch.tensor([1.0, 2.0]), job=job,
              stage=torch.full((2, 3), -1, dtype=torch.int32),
              cores=torch.ones(2, 3),
              policy=torch.tensor([0, 1], dtype=torch.int32),
              step=torch.tensor([1, 1], dtype=torch.int32))
    tr = T.append_masked(tr, mask, **kw)
    tr = T.append_masked(tr, mask, **kw)
    (e0, m0), (e1, m1) = T.decode_batch(tr)
    np.testing.assert_array_equal(e0["job"], [1, 0, 1])   # 4 → newest 3
    assert m0["dropped"] == 1 and m0["overflowed"]
    np.testing.assert_array_equal(e1["job"], [5, 5])
    np.testing.assert_array_equal(e1["t"], [2.0, 2.0])
    assert not m1["overflowed"]
    np.testing.assert_array_equal(T.overflowed(tr).numpy(), [True, False])
    np.testing.assert_array_equal(T.decode(tr, 1)[0]["job"], [5, 5])


def test_ring_overflow_drops_oldest_deterministically():
    tr = T.init(4, 1, device=CPU)
    for i in range(6):
        tr = T.append_if(tr, _one(True, torch.bool), kind=T.EV_FINISH,
                         t=_one(10.0 + i), job=_one(i, torch.int32),
                         stage=_one(0, torch.int32), cores=_one(1.0),
                         policy=_one(ASA, torch.int32),
                         step=_one(i + 1, torch.int32))
    assert bool(T.overflowed(tr)[0])
    ev, meta = T.decode(tr)
    assert meta == {"capacity": 4, "total": 6, "kept": 4, "dropped": 2,
                    "overflowed": True}
    # oldest two (jobs 0, 1) fell off the front; survivors uncorrupted
    np.testing.assert_array_equal(ev["job"], [2, 3, 4, 5])
    np.testing.assert_array_equal(ev["t"], [12.0, 13.0, 14.0, 15.0])
    np.testing.assert_array_equal(ev["step"], [3, 4, 5, 6])


def test_one_append_larger_than_the_ring_keeps_its_newest_lanes():
    tr = T.init(3, 1, device=CPU)
    mask = torch.tensor([[True, False, True, True, True, True]])
    tr = T.append_masked(tr, mask, kind=T.EV_SUBMIT, t=_one(1.0),
                         job=torch.arange(6, dtype=torch.int32)[None],
                         stage=torch.zeros(1, 6, dtype=torch.int32),
                         cores=torch.ones(1, 6),
                         policy=_one(0, torch.int32),
                         step=_one(1, torch.int32))
    ev, meta = T.decode(tr)
    assert meta["total"] == 5 and meta["dropped"] == 2
    np.testing.assert_array_equal(ev["job"], [3, 4, 5])


def test_append_segments_equals_chained_masked_appends():
    k = dict(t=_one(5.0), policy=_one(ASA_NAIVE, torch.int32),
             step=_one(7, torch.int32))
    m1 = torch.tensor([[False, True, True]])
    m2 = torch.tensor([[True, False, True]])
    job = torch.arange(3, dtype=torch.int32)[None]
    stage = _i(0, 1, 2)
    cores = _t(1.0, 2.0, 4.0)
    segs = [(m1, T.EV_FINISH, job, stage, cores),
            (m2, T.EV_START, job, stage, cores)]
    fused = T.append_segments(T.init(8, 1, device=CPU), segs, **k)
    chained = T.append_masked(T.init(8, 1, device=CPU), m1,
                              kind=T.EV_FINISH, job=job, stage=stage,
                              cores=cores, **k)
    chained = T.append_masked(chained, m2, kind=T.EV_START, job=job,
                              stage=stage, cores=cores, **k)
    assert torch.equal(fused.data, chained.data)
    assert int(fused.head) == int(chained.head) == 4


def test_init_rejects_bad_capacity():
    with pytest.raises(ValueError, match="capacity"):
        T.init(0, 1, device=CPU)
    with pytest.raises(ValueError, match="trace_capacity"):
        XSimConfig(trace_capacity=-1)
    with pytest.raises(ValueError, match="trace_capacity"):
        tiny_cfg().with_trace(0)
    assert tiny_cfg().with_trace().trace_capacity == 4 * tiny_cfg().max_jobs


# ------------------------------------------- disabled path == bit-identical


def _untraced_equal(a, b) -> None:
    x, y = convert.to_numpy(a), convert.to_numpy(b._replace(trace=None))
    assert x.keys() == y.keys()
    for k in x:
        assert x[k].dtype == y[k].dtype, k
        np.testing.assert_array_equal(x[k].view(np.uint8),
                                      y[k].view(np.uint8), err_msg=k)


def test_tracing_disabled_path_is_bit_identical(runs):
    """trace=None against a live ring: every other field identical bit
    for bit; enabling observability moves not a single ULP."""
    assert runs.fu.trace is None and runs.ft.trace is not None
    _untraced_equal(runs.fu, runs.ft)
    for k in runs.mu:
        assert torch.equal(runs.mu[k], runs.mt[k]), k


def test_small_ring_only_changes_the_trace(runs):
    """Shrinking the ring (forcing overflow) still perturbs nothing
    outside the trace, and keeps exactly the newest events."""
    fo, _ = run_grid(tiny_grid(runs.cfg.with_trace(8)), runs.fleet,
                     pred_seed=3, device=CPU)
    _untraced_equal(runs.fu, fo)
    big = T.decode_batch(runs.ft.trace)
    for i, (ev, meta) in enumerate(T.decode_batch(fo.trace)):
        bev, bmeta = big[i]
        assert meta["total"] == bmeta["total"]  # head counts every event
        assert meta["kept"] == min(meta["total"], 8)
        assert meta["overflowed"] == (meta["total"] > 8)
        for f in T.FIELDS:  # survivors = newest slice of the full ring
            np.testing.assert_array_equal(
                ev[f], bev[f][meta["total"] - meta["kept"]:], err_msg=f)


def test_untraced_sweep_calls_no_trace_function(monkeypatch):
    """The untraced program never reaches ``obs.trace``: every function
    there raises, and a naive-and-faults sweep still runs."""
    def boom(*a, **k):
        raise AssertionError("the untraced sweep called obs.trace")
    for name in ("init", "append_masked", "append_segments", "append_if",
                 "_append", "_slide", "_rows"):
        monkeypatch.setattr(T, name, boom)
    monkeypatch.setattr(tevents, "_job_stage", boom)
    grid = tfamilies.family_grid(tiny_cfg(), "faulty", n_seeds=1,
                                 policy_ids=(2, 3), shrink=1 / 64.0,
                                 device=CPU)
    final, m = run_grid(grid, device=CPU)
    assert final.trace is None
    assert int(m["restarts"].sum()) > 0 and int(m["misses"].sum()) > 0


# --------------------------------------------------- chrome export roundtrip


def test_chrome_trace_roundtrip(runs):
    ct = obs_export.chrome_trace(runs.ft, runs.grid.labels)
    assert obs_export.validate_chrome(ct) == []
    decoded = T.decode_batch(runs.ft.trace)
    steps = runs.ft.steps.numpy()
    by_pid: dict[int, list[dict]] = {}
    for e in ct["traceEvents"]:
        by_pid.setdefault(e["pid"], []).append(e)
    assert len(by_pid) == runs.grid.n
    for pid, (ev, meta) in enumerate(decoded):
        evs = by_pid[pid]
        metas = {e["name"]: e["args"] for e in evs if e["ph"] == "M"}
        # ring accounting + the steps counter round-trip exactly
        assert metas["trace_meta"] == {**meta, "steps": int(steps[pid])}
        kinds = ev["kind"]
        n_start = int((kinds == T.EV_START).sum())
        n_cancel = int((kinds == T.EV_CANCEL).sum())
        spans = [e for e in evs if e["ph"] == "X"]
        inst = [e for e in evs if e["ph"] == "i"]
        closed = [e for e in spans if not e["args"].get("open")]
        # every START becomes exactly one span unless cancelled at its
        # start instant; instants = submits/cancels/resubmits + finishes
        # of pre-sweep (warm) runs that never logged a START
        assert len(spans) == n_start - n_cancel
        n_orphan_fin = int((kinds == T.EV_FINISH).sum()) - len(closed)
        assert n_orphan_fin >= 0
        assert len(inst) == (int((kinds == T.EV_SUBMIT).sum()) + n_cancel
                             + int((kinds == T.EV_RESUBMIT).sum())
                             + n_orphan_fin)
        for e in spans:
            assert e["dur"] >= 0.0
    names = [e["args"]["name"] for e in ct["traceEvents"]
             if e["ph"] == "M" and e["name"] == "process_name"]
    assert any("asa" in n for n in names)
    rows = obs_export.jsonl_events(runs.ft, runs.grid.labels)
    assert len(rows) == sum(m["kept"] for _, m in decoded)
    assert {r["strategy"] for r in rows} == {
        "bigjob", "per_stage", "asa", "asa_naive"}


def test_chrome_trace_requires_a_trace(runs):
    with pytest.raises(ValueError, match="trace"):
        obs_export.chrome_trace(runs.fu)
    with pytest.raises(ValueError, match="trace"):
        obs_export.jsonl_events(runs.fu)
    assert obs_export.trace_meta(runs.fu) is None


def test_merged_trace_without_serve_and_serve_refused(tmp_path, runs):
    merged = obs_export.merged_chrome_trace(runs.ft, runs.grid.labels)
    assert merged == obs_export.chrome_trace(runs.ft, runs.grid.labels)
    meta = obs_export.write_merged_trace(str(tmp_path / "m.json"), runs.ft)
    assert meta["events_total"] == len(merged["traceEvents"])
    # the serve side merges since the service was ported: its rows follow
    # the rings' on the reserved pids, and it is refused where the
    # scenario pids would reach them
    from repro_torch.obs.serve_obs import SERVE_PID, ServeObs
    obs = ServeObs(spans=True)
    obs.enqueue(0, 3, obs.now())
    with_serve = obs_export.merged_chrome_trace(runs.ft, runs.grid.labels,
                                                serve=obs)
    n = len(merged["traceEvents"])
    assert with_serve["traceEvents"][:n] == merged["traceEvents"]
    assert with_serve["traceEvents"][n:] == obs.chrome_events()
    assert with_serve["otherData"]["serve_pid"] == SERVE_PID
    crowded = {"traceEvents": [], "otherData": {"n_scenarios": SERVE_PID}}
    with mock.patch.object(obs_export, "chrome_trace", return_value=crowded):
        with pytest.raises(ValueError, match="reserved serve pid"):
            obs_export.merged_chrome_trace(runs.ft, serve=obs)
    with pytest.raises(ValueError, match="traced final state"):
        obs_export.merged_chrome_trace()


def test_validate_chrome_flags_malformed_events():
    errs = obs_export.validate_chrome(
        {"traceEvents": [{"ph": "Z", "pid": 0},
                         {"ph": "X", "pid": 0, "name": "a", "ts": 1.0},
                         {"ph": "i", "name": "b", "ts": 1.0}]})
    assert len(errs) == 4   # bad ph ALSO misses its ts — both named
    assert any("ph=" in e for e in errs)
    assert any("dur" in e for e in errs)
    assert any("pid" in e for e in errs)


def test_export_validate_cli(tmp_path, runs):
    good = tmp_path / "trace.json"
    meta = obs_export.write_chrome_trace(str(good), runs.ft,
                                         runs.grid.labels)
    assert meta["events_total"] == int(runs.ft.trace.head.sum())
    assert meta["scenarios_overflowed"] == 0
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [{"ph": "Z"}]}))
    rec = tmp_path / "rec.json"
    rec.write_text(json.dumps(telemetry.record(
        "xsim_throughput", run={"label": "t"},
        profile={"scenarios_per_sec": 1.0, "us_per_scenario": 1.0},
        metrics={}, trace=meta)))
    assert obs_export.main(["--validate", str(good), str(rec)]) == 0
    assert obs_export.main(["--validate", str(good), str(bad)]) == 1
    assert obs_export.write_jsonl(str(tmp_path / "ev.jsonl"), runs.ft) \
        == meta["events_total"]
    # the module's own command line, as a user runs it
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.export", "--validate",
         str(good), str(bad)], capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 1, out.stderr
    assert f"ok   {good}" in out.stdout and f"FAIL {bad}" in out.stdout


def test_profile_session_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "prof"
    with obs_export.profile_session(str(logdir)):
        with obs_export.annotate("steady"):
            torch.ones(8).cumsum(0)
    files = list(logdir.glob("*.json"))
    assert len(files) == 1
    trace = json.loads(files[0].read_text())
    assert any(e.get("name") == "steady" for e in trace["traceEvents"])
    with obs_export.profile_session(None):   # off: nothing written
        pass


# -------------------------------------------------------- differential test


def test_replay_chain_waits_matches_compare_metrics(runs):
    """Waits reconstructed from the trace ALONE (plus the static job
    table) equal the engine's settled-timeline metric exactly, on all 12
    scenarios."""
    twt = runs.mt["twt_s"].numpy()
    n_checked = 0
    for i in range(runs.grid.n):
        pwt, valid, got = obs_metrics.replay_chain_waits(runs.ft, i)
        assert got == twt[i], (i, runs.grid.labels[i])
        n_checked += valid.sum()
    assert n_checked > 0  # the comparison is not vacuous


def test_replay_requires_lossless_ring(runs):
    with pytest.raises(ValueError, match="no trace"):
        obs_metrics.replay_chain_waits(runs.fu)
    fo, _ = run_grid(tiny_grid(runs.cfg.with_trace(8)), runs.fleet,
                     pred_seed=3, device=CPU)
    assert bool(T.overflowed(fo.trace)[0])
    with pytest.raises(ValueError, match="overflow"):
        obs_metrics.replay_chain_waits(fo, 0)


# ----------------------------------------------------------- fleet metrics


def test_sweep_summary_counters(runs):
    h = obs_metrics.to_host(
        obs_metrics.sweep_summary(runs.ft, n_steps=runs.tcfg.n_steps))
    assert h["n_scenarios"] == runs.grid.n
    assert h["wf_done"] <= h["wf_total"]
    assert 0.0 <= h["drain_frac"] <= 1.0
    assert h["trace_dropped"] == 0
    kinds = sum(h[f"ev_{n}"] for n in T.EVENT_NAMES.values())
    assert kinds == h["trace_events"]
    assert len(h["wait_hist"]) == obs_metrics.HIST_BINS
    assert sum(h["wait_hist"]) > 0
    h0 = obs_metrics.to_host(
        obs_metrics.sweep_summary(runs.fu, n_steps=runs.cfg.n_steps))
    assert "trace_events" not in h0 and "ev_start" not in h0


def test_backfill_hits_on_crafted_scenario():
    # job1 (submitted later) starts while job0 is still queued → one hit;
    # job2 is a zero-core background row and never counts
    s = SimpleNamespace(
        submit=_t(0.0, 5.0, 1.0), start=_t(10.0, 6.0, float("inf")),
        status=_i(RUNNING, RUNNING, QUEUED), cores=_t(4.0, 2.0, 0.0))
    assert obs_metrics.backfill_hits(s).tolist() == [1]
    # no overtake once job0 starts first
    s2 = SimpleNamespace(submit=_t(0.0, 5.0), start=_t(2.0, 6.0),
                         status=_i(RUNNING, RUNNING), cores=_t(4.0, 2.0))
    assert obs_metrics.backfill_hits(s2).tolist() == [0]


def test_backfill_hits_blocks_do_not_change_the_count(runs, monkeypatch):
    whole = obs_metrics.backfill_hits(runs.ft)
    n = runs.ft.start.shape[1]
    monkeypatch.setattr(obs_metrics, "PAIR_BLOCK", 5 * n * n)  # 5 a block
    assert torch.equal(obs_metrics.backfill_hits(runs.ft), whole)
    assert int(whole.sum()) > 0


# --------------------------------------------------------- telemetry schema


def test_telemetry_record_roundtrip():
    rec = telemetry.record(
        "xsim_throughput",
        run={"label": "t", "freed_mode": "ref", "n_shards": 2,
             "traced": True},
        profile={"scenarios_per_sec": 100.0, "us_per_scenario": 10_000.0},
        metrics={}, trace=None)
    assert telemetry.is_telemetry(rec)
    assert telemetry.validate(rec) == []
    leg = telemetry.throughput_leg(rec)
    assert leg["freed_mode"] == "ref" and leg["n_shards"] == 2
    assert leg["traced"] is True
    assert leg["scenarios_per_sec"] == 100.0


def test_telemetry_missing_profile_is_named():
    bad = {"telemetry_version": 1, "kind": "xsim_throughput",
           "run": {}, "metrics": {}, "trace": None}
    errs = telemetry.validate(bad)
    assert any("profile" in e for e in errs)
    with pytest.raises(ValueError, match="profile"):
        telemetry.throughput_leg(bad)
    with pytest.raises(ValueError, match="profile"):
        telemetry.record("xsim_throughput", run={}, profile=None,
                         metrics={}, trace=None)
    assert any("kind" in e for e in
               telemetry.validate({"telemetry_version": 1, "kind": "wat"}))


def test_telemetry_copy_imports_without_torch():
    """The copy is stdlib-only: loaded from its file with ``torch`` and
    ``numpy`` made unimportable, it still validates."""
    path = ROOT / "src" / "repro_torch" / "obs" / "telemetry.py"
    code = ("import sys, importlib.util\n"
            "sys.modules['torch'] = None; sys.modules['numpy'] = None\n"
            "spec = importlib.util.spec_from_file_location("
            f"'telemetry_copy', {str(path)!r})\n"
            "t = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(t)\n"
            "assert t.validate({}) != []\n"
            "assert t.TELEMETRY_VERSION == 1\n")
    subprocess.run([sys.executable, "-c", code], check=True)
    assert importlib.util.find_spec("repro_torch.obs.telemetry") is not None


# ------------------------------------------------ parity with the reference


def _ref_tiny_grid(cfg, family: str | None):
    if family is None:
        return jgrid.make_grid(cfg, center_names=("hpc2n",),
                               workflows=("blast",), policy_ids=POLICIES,
                               n_seeds=1, shrink=1 / 64.0)
    return jfamilies.family_grid(cfg, family, n_seeds=1, shrink=1 / 64.0,
                                 policy_ids=POLICIES)


@functools.cache
def _parity(family: str | None):
    """(reference grid, its traced initial states, the reference's final
    states, the port's final states from the same initial states)."""
    cfg = jgrid.XSimConfig(**TINY).with_trace()
    grid = _ref_tiny_grid(cfg, family)
    fleet = jpolicies.init_fleet(int(grid.geo_idx.max()) + 1)
    st = grid.build(jpolicies.scenario_estimators(
        fleet, jnp.asarray(grid.geo_idx), 3))
    kw = dict(n_steps=cfg.n_steps, chunk_steps=cfg.chunk_steps,
              pred_mode=cfg.pred_mode, naive=True, faults=grid.has_faults)
    ref = jevents.sweep(st, **kw)
    got = tevents.sweep(_port(st), device=CPU, **kw)
    return grid, st, ref, got, kw


def _port(ref_state):
    return convert.scenario_state(jax.tree.map(np.asarray, ref_state))


def _rings_match(ref_trace, got_trace) -> tuple[float, np.ndarray]:
    """Decoded rings equal, ``t`` within TIME_RTOL; returns the worst
    relative ``t`` error and every scenario's event kinds."""
    want, have = JT.decode_batch(ref_trace), T.decode_batch(got_trace)
    assert len(want) == len(have)
    worst, kinds = 0.0, []
    for (we, wm), (he, hm) in zip(want, have):
        assert wm == hm
        for f in T.FIELDS:
            if f == "t":
                err = (np.abs(he[f] - we[f])
                       / np.maximum(np.abs(we[f]), 1.0))
                worst = max(worst, float(err.max(initial=0.0)))
            else:
                np.testing.assert_array_equal(he[f], we[f], err_msg=f)
        kinds.append(he["kind"])
    assert worst <= TIME_RTOL, worst
    return worst, np.concatenate(kinds)


def _summaries_match(ref_final, got_final, n_steps: int) -> dict:
    want = jmetrics.to_host(jmetrics.sweep_summary(ref_final,
                                                   n_steps=n_steps))
    have = obs_metrics.to_host(obs_metrics.sweep_summary(got_final,
                                                         n_steps=n_steps))
    assert want.keys() == have.keys()
    for k in want:
        if k in ("oh_core_hours", "steps_frac", "drain_frac"):
            assert abs(have[k] - want[k]) <= SUMMARY_RTOL * max(
                abs(want[k]), 1.0), (k, have[k], want[k])
        else:
            assert have[k] == want[k], k
    return have


@pytest.mark.parametrize("family", [None, "faulty"])
def test_rings_and_summary_match_reference(family):
    grid, _, ref, got, kw = _parity(family)
    assert got.trace is not None
    _, kinds = _rings_match(ref.trace, got.trace)
    h = _summaries_match(ref, got, kw["n_steps"])
    assert h["trace_events"] == len(kinds) and h["trace_dropped"] == 0
    present = set(np.unique(kinds).tolist())
    if family == "faulty":   # every event kind occurs, kills included
        assert present == set(T.EVENT_NAMES), present
    else:
        assert {T.EV_SUBMIT, T.EV_START, T.EV_FINISH} <= present
    # the replay holds on the port's rings, lane by lane
    twt = tcompare.metrics(got)["twt_s"].numpy()
    for i, lab in enumerate(grid.labels):
        if lab["strategy"] in ("asa", "asa_naive"):
            assert obs_metrics.replay_chain_waits(got, i)[2] == twt[i], i


def test_traced_reference_state_carried_across_mid_sweep():
    """A traced reference state taken part-way through the faulty sweep,
    carried across and finished by the port, ends on the reference's own
    finish of the same state: its ring's first events are the
    reference's."""
    _, st, _, _, kw = _parity("faulty")
    mid = jevents.sweep(st, **{**kw, "n_steps": 12, "chunk_steps": 0})
    assert int(np.asarray(mid.trace.head).min()) > 0
    ref = jevents.sweep(mid, **kw)
    got = tevents.sweep(_port(mid), device=CPU, **kw)
    _rings_match(ref.trace, got.trace)
    _summaries_match(ref, got, kw["n_steps"])


# stage durations of a naive workflow whose stages all start at t = 0 on
# an idle machine (tests/test_torch_xsim_naive.py): "hold" needs four
# drain iterations in its first step, "cancel" cancels stage 2 there
DRAIN_DURS = {"hold": (100.0, 100.0, 100.0, 50.0),
              "cancel": (100.0, 400.0, 100.0, 100.0)}


def _same_instant(durs, key: int):
    t = X.empty_table(8)
    for y, d in enumerate(durs):
        X.add_job(t, y, cores=1.0, duration=d, submit=0.0, status=X.PENDING,
                  wf_next=y + 1 if y + 1 < len(durs) else -1, is_wf=True)
    return X.freeze(t, total_cores=16.0, free_cores=16.0,
                    policy=X.ASA_NAIVE, pred_mode="sample",
                    est=jasa.init(53, jax.random.PRNGKey(key)),
                    trace_capacity=32)


def test_speculative_drain_leaves_the_whole_drains_ring(monkeypatch):
    """A chunk run with the drain cut at ``SPEC_HOOK_PAIRS`` iterations
    and again whole leaves the ring the whole drain leaves: every chunk
    size (0: no cut at all) gives the reference's ring, a cancel
    included, and the cut chunk was indeed run again."""
    ref0 = jax.tree.map(lambda *xs: jnp.stack(xs),
                        _same_instant(DRAIN_DURS["hold"], 3),
                        _same_instant(DRAIN_DURS["cancel"], 4))
    ref = jevents.sweep(ref0, n_steps=40, naive=True)
    redo = []
    step = tevents.sim_step

    def spy(s, bins, **kw):
        if kw.get("naive") and kw.get("hook_pairs") is None:
            redo.append(1)
        return step(s, bins, **kw)
    monkeypatch.setattr(tevents, "sim_step", spy)
    rings = {}
    for k in (0, 1, 8):
        redo.clear()
        got = tevents.sweep(_port(ref0), n_steps=40, chunk_steps=k,
                            naive=True, device=CPU)
        _, kinds = _rings_match(ref.trace, got.trace)
        assert T.EV_CANCEL in kinds and T.EV_RESUBMIT in kinds
        if k:   # the cut chunk was run again with the whole drain
            assert redo
        rings[k] = got.trace
    assert torch.equal(rings[0].data, rings[8].data)
    assert torch.equal(rings[0].head, rings[8].head)


def test_concat_joins_rings():
    """``concat`` joins the frozen batches' rings lane by lane and
    refuses to mix traced and untraced batches."""
    from repro_torch.xsim import state as S

    def one(cap, now):
        return S.freeze(S.empty_table(8), total_cores=8.0, free_cores=8.0,
                        now=now, trace_capacity=cap, device=CPU)
    a, b = one(4, 1.0), one(4, 2.0)
    a = a._replace(trace=T.append_if(
        a.trace, _one(True, torch.bool), kind=T.EV_SUBMIT, t=a.t,
        job=_one(3, torch.int32), stage=_one(0, torch.int32),
        cores=_one(1.0), policy=a.policy, step=a.steps))
    c = S.concat([a, b, a])
    assert c.trace.data.shape == (3, 4, T.NF)
    assert c.trace.head.tolist() == [1, 0, 1]
    assert torch.equal(c.trace.data[2], a.trace.data[0])
    assert S.concat([one(0, 1.0), one(0, 2.0)]).trace is None
    with pytest.raises(ValueError, match="event ring"):
        S.concat([a, one(0, 1.0)])

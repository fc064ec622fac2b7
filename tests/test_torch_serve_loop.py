"""The port's ASA service (``repro_torch.serve.loop``, its checkpoint
codec, observability, chaos hooks and pool) on the CPU.

* The contracts of ``tests/test_serve.py`` (batching, tenant tables,
  durability), ``tests/test_serve_obs.py`` (registry, span conservation,
  bit-identity with spans on and off, ``stats``, the merged Chrome trace
  over the port's own traced sweep, the scrape endpoint, checkpoint
  stalls) and ``tests/test_serve_chaos.py`` (chaos schedules,
  containment, crash recovery bitwise, integrity fallback, shedding and
  lease eviction, lifecycle, every future resolving under chaos), rerun
  on the port.
* Parity of the whole service: one stream of requests made from a seed
  (observations, decisions, evictions that force slot reuse) goes through
  both packages' ``ASAServer`` with ``step_once(wait_s=0)``, so the
  batches are identical. Admissions, slots, tenant ids, dirty masks and
  PRNG keys are equal; the decisions follow the tolerances of
  ``tests/test_torch_serve_asa.py``.
* Checkpoints interchange both ways (a reference server's checkpoint
  restores into the port's server and the other way round, and the two
  answer the next batch alike), the ``zlib`` codec forced, and the race of
  two saves of one step into one directory, reproduced on the codec's
  old form (no per-step lock).
* ``tests/test_pool_properties.py`` rerun on the port's pool copy.

Every wait on a thread or future has a timeout.
"""

from __future__ import annotations

import ast
import contextlib
import importlib.util
import json
import random
import tempfile
import threading
import time
import urllib.error
import urllib.request
from collections import Counter as TallyCounter
from http.client import RemoteDisconnected
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.serve import loop as jloop
from repro_torch import convert
from repro_torch.core.bins import make_bins
from repro_torch.obs import export as obs_export
from repro_torch.obs import registry as reg
from repro_torch.obs.serve_obs import (PHASES, SERVE_PID, SERVE_REQUEST_PID,
                                       ServeObs, serve_registry)
from repro_torch.runtime import checkpoint as CKPT
from repro_torch.runtime import pool as tpool
from repro_torch.serve import asa as serve_asa
from repro_torch.serve import chaos as schaos
from repro_torch.serve.loop import (ASAServer, QueueFullError,
                                    RequestExpired, ServeConfig,
                                    ServeSupervisor, ServerCrashed,
                                    ServerStopped, TableFullError)

jax.config.update("jax_threefry_partitionable", True)
torch.set_num_threads(1)   # small tensors: threads only contend

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
BINS = make_bins(53)
LOG_P_ATOL = 1e-4          # as tests/test_torch_serve_asa.py
NEAR_TIE_GAP = 2e-4
EXPECTED_RTOL = 1.5e-5
ENTROPY_ATOL = 1e-5


def _cfg(tmp_path=None, **kw):
    kw.setdefault("n_slots", 8)
    kw.setdefault("batch_size", 4)
    if tmp_path is not None:
        kw.setdefault("checkpoint_dir", str(tmp_path / "ckpt"))
    return ServeConfig(**kw)


def _server(cfg, **kw) -> ASAServer:
    return ASAServer(cfg, device=CPU, **kw)


def _restore(cfg, **kw) -> ASAServer:
    return ASAServer.restore(cfg, device=CPU, **kw)


def _decide(server, tenants):
    futs = [server.submit(t) for t in tenants]
    while any(not f.done() for f in futs):
        server.step_once(wait_s=0)
    return [f.result(timeout=10) for f in futs]


def _probe(server, tenants):
    """Decide-only probes: pure table reads, safe for bitwise compares
    whatever the batch composition."""
    return [(d.lead_s, d.expected_s, d.entropy)
            for d in _decide(server, tenants)]


def _drain_all(server, futs, max_steps=64):
    steps = 0
    while any(not f.done() for f in futs):
        server.step_once(wait_s=0)
        steps += 1
        assert steps < max_steps, "requests not draining"
    return futs


# ======================================================= tests/test_serve.py
def test_entry_points_default_to_cuda(tmp_path):
    cfg = _cfg(tmp_path)
    if torch.cuda.is_available():
        assert ASAServer(cfg)._table.log_p.is_cuda
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ASAServer(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeSupervisor(cfg)
    _server(cfg).save(step=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ASAServer.restore(cfg)


def test_sharded_config_raises_naming_the_roadmap_item():
    """The sharded server is ported (tests/test_torch_serve_sharded.py):
    it raises on a shard count past the device inventory (the CPU counts
    one device) and on a batch the shards do not split."""
    with pytest.raises(ValueError, match="device"):
        _server(_cfg(n_shards=2))
    with pytest.raises(ValueError, match="divisible"):
        _cfg(n_shards=3)
    assert _server(_cfg(n_shards=1))._mesh.shape == {"scenarios": 1}


def test_fresh_tenant_answers_prior_map():
    server = _server(_cfg())
    (d,) = _decide(server, [17])
    assert d.lead_s == pytest.approx(float(BINS[0]))
    assert d.entropy == pytest.approx(float(np.log(53)), rel=1e-5)


def test_duplicate_observation_defers_preserving_order():
    """A tenant's second same-batch observation (and its later requests)
    defer to the next batch; both updates still apply, in order."""
    server = _server(_cfg(batch_size=8))
    f1 = server.submit(3, observed_wait=100.0)
    f2 = server.submit(3, observed_wait=200.0)
    f3 = server.submit(3)
    n = server.step_once(wait_s=0)
    assert n == 1 and f1.done() and not f2.done() and not f3.done()
    n = server.step_once(wait_s=0)
    assert n == 2 and f2.done() and f3.done()
    # the same two updates applied in turn to the tenant's fresh row
    from repro_torch.core import asa as core_asa
    slot = server._slot_of[3]
    fresh = serve_asa.init_table(8, 53, 0, device=CPU)
    row = core_asa.ASAState(*(x[slot] for x in fresh))
    bins = torch.as_tensor(BINS, dtype=torch.float32)
    for w in (100.0, 200.0):
        row = core_asa.learn_wait_if(row, bins, torch.tensor(w),
                                     torch.tensor(True))
    assert f3.result().lead_s == pytest.approx(
        float(core_asa.map_wait(row, bins)))


def test_table_full_fails_the_future_not_the_loop():
    server = _server(_cfg(n_slots=2, batch_size=4))
    f1, f2, f3 = server.submit(1), server.submit(2), server.submit(3)
    server.step_once(wait_s=0)
    assert f1.result(timeout=10) and f2.result(timeout=10)
    with pytest.raises(TableFullError):
        f3.result(timeout=10)
    server.evict(1)
    f4 = server.submit(4)
    server.step_once(wait_s=0)
    assert f4.result(timeout=10).tenant == 4


def test_evicted_slot_resets_on_reuse():
    server = _server(_cfg(n_slots=1, batch_size=2))
    for _ in range(4):
        fut = server.submit(11, observed_wait=900.0)
        server.step_once(wait_s=0)
    assert fut.result(timeout=10).lead_s > float(BINS[0])
    server.evict(11)
    f = server.submit(12)
    server.step_once(wait_s=0)
    assert f.result(timeout=10).lead_s == pytest.approx(float(BINS[0]))


def test_threaded_loop_serves_many_tenants():
    server = _server(_cfg(n_slots=64, batch_size=16))
    server.start()
    try:
        futs = [server.submit(t, observed_wait=50.0 * (1 + t % 5))
                for t in range(48)]
        decs = [f.result(timeout=60) for f in futs]
    finally:
        server.stop()
    assert {d.tenant for d in decs} == set(range(48))
    assert server.stats["tenants"] == 48
    assert server.stats["deferred"] == 0


def _traffic(server, rounds=3):
    rng = np.random.default_rng(5)
    for _r in range(rounds):
        for t in range(5):
            fut = server.submit(t, float(rng.uniform(20, 2000)))
            server.step_once(wait_s=0)
            fut.result(timeout=10)


def test_restart_is_bitwise_identical(tmp_path):
    cfg = _cfg(tmp_path)
    server = _server(cfg)
    _traffic(server)
    server.save(step=3)
    restored = _restore(cfg, step=3)
    assert _probe(server, range(5)) == _probe(restored, range(5))
    for t in range(5):
        fa = server.submit(t, observed_wait=333.0)
        fb = restored.submit(t, observed_wait=333.0)
        server.step_once(wait_s=0)
        restored.step_once(wait_s=0)
        a, b = fa.result(timeout=10), fb.result(timeout=10)
        assert (a.lead_s, a.expected_s, a.entropy) == \
               (b.lead_s, b.expected_s, b.entropy)
    for x, y in zip(server._table, restored._table):
        assert torch.equal(x, y)


def test_restore_latest_and_tenant_map(tmp_path):
    cfg = _cfg(tmp_path)
    server = _server(cfg)
    _decide(server, [42, 7])
    server.evict(7)
    server.save(step=1)
    server.save(step=4)
    restored = _restore(cfg)
    assert restored._batches == 4
    assert restored._slot_of == server._slot_of
    assert set(restored._free) == set(server._free)
    (d,) = _decide(restored, [99])
    assert d.lead_s == pytest.approx(float(BINS[0]))


def test_checkpoint_cadence_runs_async_saves(tmp_path):
    cfg = _cfg(tmp_path, checkpoint_every=2)
    server = _server(cfg)
    _traffic(server, rounds=2)            # 10 batches -> 5 cadence saves
    server.stop()                         # collects the last handle
    assert CKPT.latest_step(cfg.checkpoint_dir) == 10


def test_save_async_failure_raises_at_join(tmp_path):
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("file, not a directory")
    h = CKPT.save_async({"x": torch.zeros(3)}, blocker / "sub", 1)
    with pytest.raises((NotADirectoryError, FileExistsError, OSError)):
        h.result(timeout=30)
    assert h.done()


def test_save_async_success_reports_path(tmp_path):
    h = CKPT.save_async({"x": torch.arange(4, dtype=torch.int32)},
                        tmp_path, 2)
    assert h.result(timeout=30) == tmp_path / "step_2"
    assert CKPT.latest_step(tmp_path) == 2


def test_save_async_snapshot_is_taken_at_the_call(tmp_path):
    """The host copy happens in the caller's thread: mutating a host
    array after ``save_async`` returns cannot reach the checkpoint."""
    ids = np.arange(4, dtype=np.int32)
    h = CKPT.save_async({"ids": ids}, tmp_path, 1)
    ids[:] = -7
    h.result(timeout=30)
    r = CKPT.restore({"ids": ids}, tmp_path, 1, device=CPU)
    assert r["ids"].tolist() == [0, 1, 2, 3]


def test_server_save_async_failure_surfaces_on_next_save(tmp_path):
    import shutil
    cfg = _cfg(tmp_path)
    server = _server(cfg)
    _decide(server, [1])
    server.save_async(step=1).result(timeout=30)
    shutil.rmtree(cfg.checkpoint_dir)
    Path(cfg.checkpoint_dir).write_text("now a file")
    server.save_async(step=2)
    with pytest.raises((NotADirectoryError, FileExistsError, OSError)):
        server.save_async(step=3)


def test_reused_tmp_dir_drops_stale_leaves(tmp_path):
    small = {"a": torch.zeros(4)}
    tmp = tmp_path / "_tmp_step_5"
    tmp.mkdir()
    (tmp / "a.bin").write_bytes(b"stale")
    (tmp / "b.bin").write_bytes(b"stale")
    CKPT.save(small, tmp_path, 5)
    names = {p.name for p in (tmp_path / "step_5").iterdir()}
    assert "b.bin" not in names, "stale leaf leaked into the checkpoint"
    r = CKPT.restore(small, tmp_path, 5, device=CPU)
    assert torch.equal(r["a"], torch.zeros(4))


def test_int64_leaves_are_stored_as_uint32(tmp_path):
    key = torch.tensor([[0, 0xFFFFFFFF], [7, 1 << 31]], dtype=torch.int64)
    CKPT.save({"k": key}, tmp_path, 1)
    manifest = json.loads((tmp_path / "step_1" / "manifest.json")
                          .read_text())
    assert manifest["leaves"][0]["dtype"] == "uint32"
    r = CKPT.restore({"k": key}, tmp_path, 1, device=CPU)
    assert r["k"].dtype == torch.int64 and torch.equal(r["k"], key)
    with pytest.raises(ValueError, match="uint32"):
        CKPT.save({"k": torch.tensor([-1])}, tmp_path, 2)


# ================================================== the codec with others
def _jax_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_server_leaf_names_are_the_reference_names(tmp_path):
    cfg = _cfg(tmp_path)
    _server(cfg).save(step=1)
    jloop.ASAServer(cfg).save(step=2)
    names = [json.loads((tmp_path / "ckpt" / f"step_{s}" / "manifest.json")
                        .read_text())["leaves"] for s in (1, 2)]
    assert [(m["name"], m["dtype"], m["shape"]) for m in names[0]] == \
        [(m["name"], m["dtype"], m["shape"]) for m in names[1]]
    assert [m["name"] for m in names[0]] == [
        "admissions", "dirty", "table_.log_p", "table_.round_loss",
        "table_.rounds", "table_.t", "table_.key", "tenant_ids"]


def _same_server_state(tsrv: ASAServer, jsrv) -> None:
    """Host bookkeeping equal, keys and counters bitwise, log_p within
    LOG_P_ATOL."""
    jt = convert.serve_state(_jax_tree(jsrv._state_tree()), CPU)
    tt = tsrv._state_tree()
    assert tsrv._admissions == jsrv._admissions
    assert tsrv._slot_of == jsrv._slot_of
    assert tsrv._dirty == jsrv._dirty
    assert np.array_equal(tt["tenant_ids"], jt["tenant_ids"])
    for f in ("key", "rounds", "t", "round_loss"):
        assert torch.equal(getattr(tt["table"], f),
                           getattr(jt["table"], f)), f
    err = float((tt["table"].log_p - jt["table"].log_p).abs().max())
    assert err <= LOG_P_ATOL, err


def _same_decisions(t_decs, j_decs, jsrv) -> int:
    """Decisions within the stated tolerances; MAP flips only at near-ties
    of the reference posterior. Returns the flips."""
    log_p = np.asarray(jsrv._table.log_p)
    flips = 0
    for a, b in zip(t_decs, j_decs):
        assert a.tenant == b.tenant
        assert a.expected_s == pytest.approx(b.expected_s,
                                             rel=EXPECTED_RTOL)
        assert abs(a.entropy - b.entropy) <= ENTROPY_ATOL
        if a.lead_s != b.lead_s:
            row = log_p[jsrv._slot_of[a.tenant]]
            got = int(np.flatnonzero(BINS.astype(np.float32)
                                     == np.float32(a.lead_s))[0])
            assert row.max() - row[got] <= NEAR_TIE_GAP
            flips += 1
    return flips


def _stream(seed: int, n_ops: int, n_tenants: int):
    """(op, tenant, wait) rows: 'submit' with or without an observation,
    'evict', 'step' (dispatch what is queued)."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n_ops):
        u = rng.random()
        tenant = int(rng.integers(0, n_tenants))
        if u < 0.08:
            ops.append(("evict", tenant, None))
        elif u < 0.25:
            ops.append(("step", -1, None))
        elif u < 0.65:
            ops.append(("submit", tenant, float(np.exp(
                rng.uniform(np.log(5.0), np.log(9e4))))))
        else:
            ops.append(("submit", tenant, None))
    ops.append(("step", -1, None))
    return ops


def _drive(server, ops):
    """Run the stream; returns every resolved Decision (typed failures
    as their type names) in submission order."""
    futs = []
    for op, tenant, wait in ops:
        if op == "submit":
            futs.append(server.submit(tenant, wait))
        elif op == "evict":
            if tenant in server._slot_of:
                server.evict(tenant)
        else:
            while server.step_once(wait_s=0):
                pass
    while any(not f.done() for f in futs):
        server.step_once(wait_s=0)
    return [f.result(timeout=10) if f.exception(timeout=10) is None
            else type(f.exception()).__name__ for f in futs]


@pytest.mark.parametrize("seed", [0, 1])
def test_whole_service_parity_with_reference(seed):
    """The same request stream through both packages' servers: identical
    batches, admissions, slot reuse keys and tenant maps; decisions
    within the tolerances."""
    cfg = ServeConfig(n_slots=10, batch_size=8, seed=seed)
    ops = _stream(seed, 160, 14)
    tsrv, jsrv = _server(cfg), jloop.ASAServer(cfg)
    t_out, j_out = _drive(tsrv, ops), _drive(jsrv, ops)
    assert [x if isinstance(x, str) else x.tenant for x in t_out] == \
        [x if isinstance(x, str) else x.tenant for x in j_out]
    assert tsrv._batches == jsrv._batches
    assert tsrv._dirty or tsrv._admissions > cfg.n_slots  # slots reused
    _same_server_state(tsrv, jsrv)
    t_dec = [x for x in t_out if not isinstance(x, str)]
    j_dec = [x for x in j_out if not isinstance(x, str)]
    flips = _same_decisions(t_dec, j_dec, jsrv)
    assert flips <= len(t_dec) // 10


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_checkpoints_interchange(tmp_path, direction):
    """A checkpoint written by one package restores in the other, and
    both servers answer the next batches alike."""
    cfg = _cfg(tmp_path, n_slots=12, batch_size=8)
    ops = _stream(3, 90, 16)
    if direction == "reference_to_port":
        src = jloop.ASAServer(cfg)
        _drive(src, ops)
        src.save(step=7)
        dst = ASAServer.restore(cfg, step=7, device=CPU)
        tsrv, jsrv = dst, src
    else:
        src = _server(cfg)
        _drive(src, ops)
        src.save(step=7)
        dst = jloop.ASAServer.restore(cfg, step=7)
        tsrv, jsrv = src, dst
    assert dst._batches == 7
    _same_server_state(tsrv, jsrv)
    tenants = sorted(tsrv._slot_of)
    _same_decisions(_decide(tsrv, tenants), _decide(jsrv, tenants), jsrv)
    more = _stream(4, 40, 20)
    t_out, j_out = _drive(tsrv, more), _drive(jsrv, more)
    _same_server_state(tsrv, jsrv)
    _same_decisions([x for x in t_out if not isinstance(x, str)],
                    [x for x in j_out if not isinstance(x, str)], jsrv)


def test_zlib_codec_forced(tmp_path, monkeypatch):
    """Without ``zstandard`` the codec is zlib; its checkpoints restore in
    both packages, and a zstd checkpoint then refuses to restore."""
    cfg = _cfg(tmp_path)
    server = _server(cfg)
    _traffic(server, rounds=1)
    if CKPT.zstandard is not None:
        server.save(step=1)               # written with zstd
    monkeypatch.setattr(CKPT, "zstandard", None)
    server.save(step=2)
    manifest = json.loads((tmp_path / "ckpt" / "step_2" / "manifest.json")
                          .read_text())
    assert manifest["codec"] == "zlib"
    restored = _restore(cfg, step=2)
    assert _probe(restored, range(5)) == _probe(server, range(5))
    jsrv = jloop.ASAServer.restore(cfg, step=2)
    _same_server_state(restored, jsrv)
    if (tmp_path / "ckpt" / "step_1").exists():
        with pytest.raises(RuntimeError, match="zstandard"):
            _restore(cfg, step=1)


def _blocking_compressor(gate: threading.Event, entered: threading.Event):
    """A codec whose first compression waits on ``gate``: holds the first
    save of a step mid-write."""
    real = CKPT._compressor
    first = [True]

    def compressor(level):
        name, fn = real(level)

        def compress(data):
            if first[0]:
                first[0] = False
                entered.set()
                assert gate.wait(timeout=30)
            return fn(data)
        return name, compress
    return compressor


def _two_saves_of_one_step(tmp_path, monkeypatch):
    gate, entered = threading.Event(), threading.Event()
    monkeypatch.setattr(CKPT, "_compressor",
                        _blocking_compressor(gate, entered))
    a = CKPT.save_async({"x": torch.zeros(8)}, tmp_path, 4)
    assert entered.wait(timeout=30)
    b = CKPT.save_async({"x": torch.ones(8)}, tmp_path, 4)
    return a, b, gate


def test_concurrent_saves_of_one_step_race_without_the_lock(tmp_path,
                                                            monkeypatch):
    """The codec's old form (no per-step lock): a second save of the
    same step clears and renames the shared ``_tmp_step_4`` while the
    first is still writing into it, and the first save fails."""
    monkeypatch.setattr(CKPT, "_step_lock",
                        lambda final: contextlib.nullcontext())
    a, b, gate = _two_saves_of_one_step(tmp_path, monkeypatch)
    assert b.result(timeout=30) == tmp_path / "step_4"
    gate.set()
    with pytest.raises(OSError):
        a.result(timeout=30)


def test_concurrent_saves_of_one_step_serialise(tmp_path, monkeypatch):
    """With the lock the second save waits for the first; both publish,
    the step verifies and holds the last writer's tree."""
    a, b, gate = _two_saves_of_one_step(tmp_path, monkeypatch)
    time.sleep(0.2)
    assert not b.done(), "the second save did not wait for the first"
    gate.set()
    assert a.result(timeout=30) == b.result(timeout=30)
    assert CKPT.verify_step(tmp_path, 4) == []
    r = CKPT.restore({"x": torch.zeros(8)}, tmp_path, 4, device=CPU)
    assert torch.equal(r["x"], torch.ones(8))
    assert not (tmp_path / "_tmp_step_4").exists()


# =================================================== tests/test_serve_obs.py
def test_geometric_buckets_shape_and_errors():
    b = reg.geometric_buckets(1e-4, 100.0)
    assert len(b) == reg.M_BUCKETS_DEFAULT == 53
    assert b[0] == pytest.approx(1e-4) and b[-1] == pytest.approx(100.0)
    assert list(b) == sorted(b)
    r = np.diff(np.log(np.asarray(b)))
    np.testing.assert_allclose(r, r[0], rtol=1e-9)
    for lo, hi, n in ((0.0, 1.0, 53), (2.0, 1.0, 53), (1.0, 2.0, 1)):
        with pytest.raises(ValueError):
            reg.geometric_buckets(lo, hi, n=n)


def test_counter_monotone_and_gauge():
    r = reg.Registry()
    c = r.counter("x_total", "help text")
    c.inc()
    c.inc(2.5)
    assert c.value == 3.5
    with pytest.raises(ValueError):
        c.inc(-1)
    g = r.gauge("depth")
    g.set(4)
    g.inc()
    g.dec(2)
    assert g.value == 3


def test_histogram_bucketing_and_overflow():
    h = reg.Histogram("lat", (1.0, 2.0, 4.0))
    for v in (0.5, 1.0, 3.0, 100.0):
        h.observe(v)
    snap = h.snapshot()
    assert snap["buckets"] == [1.0, 2.0, 4.0]
    assert snap["counts"] == [2, 0, 1, 1]
    assert snap["count"] == 4
    assert snap["sum"] == pytest.approx(104.5)
    h.observe_many([0.1, 9.0])
    assert h.snapshot()["counts"] == [3, 0, 1, 2]
    with pytest.raises(ValueError):
        reg.Histogram("bad", (3.0, 1.0))


def test_registry_get_or_create_and_kind_clash():
    r = reg.Registry()
    assert r.counter("a") is r.counter("a")
    with pytest.raises(TypeError):
        r.gauge("a")
    assert r.get("a").kind == "counter"
    assert r.get("nope") is None


def test_prometheus_text_format():
    r = reg.Registry()
    r.counter("asa_x_total", "things").inc(3)
    r.gauge("asa_depth").set(2.5)
    r.histogram("asa_lat", (1.0, 2.0), "waits").observe_many([0.5, 5.0])
    text = r.prometheus_text()
    lines = text.splitlines()
    for line in ("# HELP asa_x_total things", "# TYPE asa_x_total counter",
                 "asa_x_total 3", "# TYPE asa_depth gauge", "asa_depth 2.5",
                 'asa_lat_bucket{le="1"} 1', 'asa_lat_bucket{le="2"} 1',
                 'asa_lat_bucket{le="+Inf"} 2', "asa_lat_sum 5.5",
                 "asa_lat_count 2"):
        assert line in lines, line
    assert text.endswith("\n")


def test_registry_snapshot_and_json_line():
    r = serve_registry()
    r.counter("asa_serve_requests_total").inc(7)
    snap = r.snapshot()
    assert snap["asa_serve_requests_total"] == 7
    assert snap["asa_serve_request_latency_seconds"]["count"] == 0
    line = json.loads(r.json_line(ts=123.0))
    assert line["ts"] == 123.0
    assert line["asa_serve_requests_total"] == 7


def _tally(obs: ServeObs) -> TallyCounter:
    return TallyCounter(ev[1] for ev in obs.events)


def _request_rids(obs: ServeObs, name: str) -> list[int]:
    return [ev[6] for ev in obs.events
            if ev[1] == name and ev[2] == SERVE_REQUEST_PID]


def test_span_conservation_happy_path():
    server = _server(_cfg(obs_spans=True, batch_size=8))
    futs = [server.submit(t % 3, observed_wait=50.0 * (1 + t % 4))
            for t in range(12)]
    _drain_all(server, futs)
    o = server.obs
    enq = _request_rids(o, "enqueue")
    assert sorted(enq) == sorted(_request_rids(o, "request"))
    assert len(set(enq)) == len(enq) == 12
    s = server.stats
    assert s["requests"] == 12
    assert int(o.c_resolved.value) + s["failed"] == 12
    assert o.g_inflight.value == 0


def test_span_conservation_table_full():
    server = _server(_cfg(n_slots=1, batch_size=4, obs_spans=True))
    f_ok, f_full = server.submit(1), server.submit(2)
    server.step_once(wait_s=0)
    assert f_ok.result(timeout=10).tenant == 1
    assert f_full.exception(timeout=10) is not None
    o = server.obs
    assert sorted(_request_rids(o, "enqueue")) == \
        sorted(_request_rids(o, "request"))
    errors = [ev[7] for ev in o.events if ev[1] == "request"]
    assert errors.count("table_full") == 1
    assert _tally(o)["table_full"] == 1
    assert server.stats["failed"] == 1
    assert server.stats["table_full"] == 1
    assert o.g_inflight.value == 0


def test_span_conservation_eviction_race():
    server = _server(_cfg(obs_spans=True))
    f0 = server.submit(5, observed_wait=700.0)
    server.step_once(wait_s=0)
    f0.result(timeout=10)
    f1 = server.submit(5)
    server.evict(5)
    server.step_once(wait_s=0)
    assert f1.result(timeout=10).tenant == 5
    o = server.obs
    assert sorted(_request_rids(o, "enqueue")) == \
        sorted(_request_rids(o, "request"))
    assert _tally(o)["evict"] == 1
    assert server.stats["evicted_tenants"] == 1
    assert o.g_inflight.value == 0


def test_deferred_duplicates_conserve_and_count():
    server = _server(_cfg(obs_spans=True, batch_size=8))
    fs = [server.submit(3, observed_wait=100.0),
          server.submit(3, observed_wait=200.0), server.submit(3)]
    _drain_all(server, fs)
    o = server.obs
    assert sorted(_request_rids(o, "enqueue")) == \
        sorted(_request_rids(o, "request"))
    assert int(o.c_deferrals.value) == _tally(o)["defer"] == 2
    assert o.rates()["defer_rate"] == pytest.approx(2 / 3)


def test_decisions_bit_identical_spans_on_off():
    traffic = [(t % 4, 60.0 * (1 + t % 5)) for t in range(16)]
    answers = []
    for spans in (False, True):
        server = _server(_cfg(obs_spans=spans))
        futs = [server.submit(t, observed_wait=w) for t, w in traffic]
        _drain_all(server, futs)
        answers.append([(d.lead_s, d.expected_s, d.entropy)
                        for d in (f.result(timeout=10) for f in futs)])
        if not spans:
            assert len(server.obs.events) == 0
    assert answers[0] == answers[1]


def test_stats_keeps_evicted_tenant_request_counts():
    server = _server(_cfg())
    for _ in range(3):
        f = server.submit(7, observed_wait=100.0)
        server.step_once(wait_s=0)
        f.result(timeout=10)
    f = server.submit(8)
    server.step_once(wait_s=0)
    f.result(timeout=10)
    server.evict(7)
    s = server.stats
    for k in ("batches", "decisions", "tenants", "n_slots", "deferred"):
        assert k in s
    assert s["decisions"] == 4 and s["tenants"] == 1
    assert s["evicted_tenants"] == 1
    assert s["evicted_requests"] == 3
    assert s["requests"] == 4
    server.evict(8)
    assert server.stats["evicted_requests"] == 4


def test_spans_off_takes_no_timestamps():
    o = ServeObs(spans=False)
    assert o.now() == 0.0
    o.enqueue(0, 1, 0.0)
    o.span("batch_form", 0.0, 0.0)
    o.instant("admit", 0.0)
    assert len(o.events) == 0 and o.events_dropped == 0


def test_span_buffer_bounded_drops_oldest():
    o = ServeObs(spans=True, span_capacity=4)
    for i in range(7):
        o.enqueue(i, 0, float(i))
    assert len(o.events) == 4
    assert o.events_dropped == 3
    assert [ev[6] for ev in o.events] == [3, 4, 5, 6]


def _small_served_obs():
    server = _server(_cfg(obs_spans=True))
    futs = [server.submit(t % 3, observed_wait=80.0 * (1 + t % 3))
            for t in range(9)]
    _drain_all(server, futs)
    return server.obs


def test_chrome_events_shape():
    evs = _small_served_obs().chrome_events()
    names = {e["name"] for e in evs}
    assert {"process_name", "serve_obs_meta", "enqueue",
            "request"} <= names
    by_pid = TallyCounter(e["pid"] for e in evs)
    assert by_pid[SERVE_PID] > 0 and by_pid[SERVE_REQUEST_PID] > 0
    for e in evs:
        if e["ph"] == "X":
            assert e["dur"] >= 0.0 and "ts" in e
        elif e["ph"] == "i":
            assert e["s"] == "t"
    loop_names = {e["name"] for e in evs if e["pid"] == SERVE_PID}
    assert set(PHASES[:5]) <= loop_names
    req = next(e for e in evs if e["name"] == "request")
    assert {"rid", "tenant"} <= set(req["args"])


def test_merged_trace_serve_only(tmp_path):
    o = _small_served_obs()
    meta = obs_export.write_merged_trace(str(tmp_path / "m.json"), serve=o)
    obj = json.loads((tmp_path / "m.json").read_text())
    assert obs_export.validate_chrome(obj) == []
    assert obj["otherData"]["serve_pid"] == SERVE_PID
    assert obj["otherData"]["n_scenarios"] == 0
    assert meta["serve_events_kept"] == len(o.events)
    assert meta["serve_events_dropped"] == 0
    with pytest.raises(ValueError, match="needs"):
        obs_export.merged_chrome_trace()


@pytest.fixture(scope="module")
def traced_sweep():
    """A tiny traced sweep of the port: the device event rings the merged
    trace interleaves with the serve rows."""
    from repro_torch.xsim import policies
    from repro_torch.xsim.grid import XSimConfig, make_grid, run_grid
    from repro_torch.xsim.state import ASA
    cfg = XSimConfig(n_warm=8, n_backlog=6, n_arrivals=8, max_stages=9,
                     t0=1800.0).with_trace()
    grid = make_grid(cfg, center_names=("hpc2n",), workflows=("blast",),
                     policy_ids=(ASA,), n_seeds=1, shrink=1 / 64.0,
                     device=CPU)
    fleet = policies.init_fleet(int(grid.geo_idx.max()) + 1, device=CPU)
    final, _ = run_grid(grid, fleet, pred_seed=3, device=CPU)
    return final, grid.labels


def test_merged_trace_roundtrip_no_pid_collisions(tmp_path, traced_sweep):
    final, labels = traced_sweep
    o = _small_served_obs()
    path = tmp_path / "merged.json"
    meta = obs_export.write_merged_trace(str(path), final, labels, o)
    obj = json.loads(path.read_text())
    assert obs_export.validate_chrome(obj) == []
    pids = {e["pid"] for e in obj["traceEvents"]}
    scen = {p for p in pids if p < SERVE_PID}
    assert scen == set(range(obj["otherData"]["n_scenarios"]))
    assert {SERVE_PID, SERVE_REQUEST_PID} <= pids
    assert obj["otherData"]["serve_request_pid"] == SERVE_REQUEST_PID
    n_serve = sum(1 for e in obj["traceEvents"] if e["pid"] >= SERVE_PID)
    assert n_serve == len(o.chrome_events())
    assert meta["events_total"] == len(obj["traceEvents"])
    fake = {"traceEvents": [], "displayTimeUnit": "ms",
            "otherData": {"format": "repro.obs.chrome_trace",
                          "version": 1, "n_scenarios": SERVE_PID + 1}}
    import unittest.mock as mock
    with mock.patch.object(obs_export, "chrome_trace", return_value=fake):
        with pytest.raises(ValueError, match="reserved serve pid"):
            obs_export.merged_chrome_trace(final, labels, o)


def _get(port, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _scrape_value(text, name):
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[1])
    raise AssertionError(f"{name} not exposed")


def test_scrape_endpoint_smoke():
    server = _server(_cfg())
    port = server.serve_metrics_http(port=0)
    try:
        f = server.submit(1, observed_wait=100.0)
        server.step_once(wait_s=0)
        f.result(timeout=10)
        status, ctype, body = _get(port, "/metrics")
        assert status == 200 and "version=0.0.4" in ctype
        text = body.decode()
        assert "# TYPE asa_serve_requests_total counter" in text
        first = _scrape_value(text, "asa_serve_requests_total")
        f = server.submit(2)
        server.step_once(wait_s=0)
        f.result(timeout=10)
        _, _, body2 = _get(port, "/metrics")
        assert _scrape_value(body2.decode(),
                             "asa_serve_requests_total") == first + 1
        status, ctype, body = _get(port, "/metrics.json")
        assert status == 200 and ctype == "application/json"
        assert json.loads(body)["asa_serve_requests_total"] == 2
        status, _, body = _get(port, "/stats")
        assert json.loads(body) == server.stats
        with pytest.raises(urllib.error.HTTPError):
            _get(port, "/nope")
        with pytest.raises(RuntimeError, match="already running"):
            server.serve_metrics_http(port=0)
    finally:
        server.stop_metrics_http()


def test_metrics_port_config_starts_endpoint_with_loop():
    server = _server(_cfg(metrics_port=0))
    server.start()
    try:
        port = server._http.server_address[1]
        assert _get(port, "/metrics")[0] == 200
    finally:
        server.stop()
    assert server._http is None


def test_checkpoint_stall_recorded(tmp_path):
    server = _server(_cfg(checkpoint_dir=str(tmp_path / "ckpt"),
                          obs_spans=True))
    f = server.submit(1)
    server.step_once(wait_s=0)
    f.result(timeout=10)
    server.save_async(step=1).result(timeout=30)
    server.save_async(step=2).result(timeout=30)
    o = server.obs
    assert int(o.c_checkpoints.value) == 2
    assert _tally(o)["checkpoint_stall"] == 1
    assert float(o.c_ckpt_stall_s.value) >= 0.0


# ================================================= tests/test_serve_chaos.py
def test_chaos_event_validation():
    with pytest.raises(ValueError, match="unknown chaos kind"):
        schaos.ChaosEvent(0, "meteor_strike")
    with pytest.raises(ValueError, match="batch must be >= 0"):
        schaos.ChaosEvent(-1, "step_exception")
    with pytest.raises(ValueError, match="magnitude > 0"):
        schaos.slow_step(3, 0.0)
    with pytest.raises(ValueError, match="magnitude >= 1"):
        schaos.queue_burst(3, 0)


def test_chaos_schedule_sorts_and_rejects_duplicates():
    s = schaos.ChaosSchedule((schaos.crash(5), schaos.step_exception(1),
                              schaos.checkpoint_error(1)))
    assert [e.batch for e in s.events] == [1, 1, 5]
    assert [e.kind for e in s.events[:2]] == \
        ["step_exception", "checkpoint_write_error"]
    with pytest.raises(ValueError, match="duplicate chaos event"):
        schaos.ChaosSchedule((schaos.crash(2), schaos.crash(2)))


def test_mix_schedule_is_deterministic():
    a = schaos.mix_schedule(20, seed=7)
    assert a.events == schaos.mix_schedule(20, seed=7).events
    assert len(a) == 9


def test_injector_fires_at_or_after_and_once():
    inj = schaos.ChaosInjector(schaos.ChaosSchedule(
        (schaos.step_exception(3),)))
    inj.before_device_step(0)
    assert len(inj.pending) == 1
    with pytest.raises(schaos.InjectedStepFault):
        inj.before_device_step(7)
    assert inj.pending == ()
    inj.before_device_step(7)
    assert inj.counts()["step_exception"] == 1


def test_step_exception_fails_the_batch_not_the_loop():
    inj = schaos.ChaosInjector(schaos.ChaosSchedule(
        (schaos.step_exception(0),)))
    server = _server(_cfg(), chaos=inj)
    futs = [server.submit(t) for t in (1, 2, 3)]
    server.step_once(wait_s=0)
    for f in futs:
        err = f.exception(timeout=10)
        assert isinstance(err, serve_asa.ServeStepError)
        assert err.batch == 0
        assert isinstance(err.__cause__, schaos.InjectedStepFault)
    assert server.stats["batches"] == 0
    assert server.stats["step_errors"] == 1
    (d,) = _decide(server, [9])
    assert d.lead_s > 0
    assert server.stats["batches"] == 1


def test_device_failure_fails_the_batch_and_keeps_the_table(monkeypatch):
    """An exception inside the step itself (not an injected one) fails
    the batch's futures typed; the table holds its pre-dispatch state."""
    server = _server(_cfg())
    _decide(server, [1, 2])
    before = [x.clone() for x in server._table]

    def broken(*a, **k):
        raise RuntimeError("device fault")
    monkeypatch.setattr(serve_asa, "serve_step", broken)
    f = server.submit(1, observed_wait=500.0)
    server.step_once(wait_s=0)
    assert isinstance(f.exception(timeout=10), serve_asa.ServeStepError)
    for a, b in zip(server._table, before):
        assert torch.equal(a, b)


def test_checkpoint_write_error_is_contained(tmp_path):
    inj = schaos.ChaosInjector(schaos.ChaosSchedule(
        (schaos.checkpoint_error(0),)))
    server = _server(_cfg(tmp_path, checkpoint_every=1), chaos=inj)
    _decide(server, [1, 2])
    assert server.stats["batches"] >= 1
    reg_ = server.obs.registry.snapshot()
    assert reg_["asa_serve_checkpoint_failures_total"] >= 1
    _decide(server, [3, 4])
    server.stop()
    assert CKPT.latest_step(server.cfg.checkpoint_dir) is not None


def test_crash_recovery_is_bitwise_with_uninterrupted_run(tmp_path):
    cfg = _cfg(tmp_path)
    ref = _server(cfg)
    for t in range(6):
        fut = ref.submit(t, observed_wait=250.0 * (t + 1))
        ref.step_once(wait_s=0)
        fut.result(timeout=10)
    ref.save(step=3)
    inj = schaos.ChaosInjector(schaos.ChaosSchedule((schaos.crash(0),)))
    sup = ServeSupervisor(cfg, chaos=inj, device=CPU)
    sup.start()
    try:
        fut = sup.submit(0)
        deadline = time.monotonic() + 30
        while sup.restarts == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert sup.restarts == 1
        err = fut.exception(timeout=30)
        assert err is None or isinstance(err, ServerCrashed)
        assert sup.submit(1).result(timeout=30).lead_s > 0
    finally:
        sup.stop()
    restored = _restore(cfg, step=3, verified=True)
    assert _probe(restored, range(6)) == _probe(ref, range(6))
    assert torch.equal(restored._table.log_p, ref._table.log_p)
    assert torch.equal(restored._table.key, ref._table.key)


def test_crash_drains_pending_with_typed_error():
    inj = schaos.ChaosInjector(schaos.ChaosSchedule((schaos.crash(0),)))
    server = _server(_cfg(), chaos=inj)
    futs = [server.submit(t) for t in range(5)]
    with pytest.raises(schaos.InjectedCrash):
        server.step_once(wait_s=0)
    server._crash(schaos.InjectedCrash("boom"))
    for f in futs:
        assert isinstance(f.exception(timeout=10), ServerCrashed)
    with pytest.raises(ServerCrashed):
        server.submit(99)
    with pytest.raises(ServerCrashed, match="cannot start"):
        server.start()
    assert server.stats["crashes"] == 1


def test_loop_that_fails_to_set_its_device_strands_nothing(monkeypatch):
    """The loop thread's first act (setting its CUDA device) is inside the
    crash path: a failure there fails pending futures typed and signals
    the crash, instead of a thread that dies silently."""
    server = _server(_cfg())
    server._device = torch.device("cuda", 0)    # as a card server holds it

    def refuse(dev):
        raise RuntimeError(f"cannot set {dev}")
    monkeypatch.setattr(torch.cuda, "set_device", refuse)
    fut = server.submit(1)
    server.start()
    assert server._crash_event.wait(timeout=10)
    assert isinstance(fut.exception(timeout=10), ServerCrashed)
    server._thread.join(timeout=10)
    assert not server._thread.is_alive()


def test_watchdog_gauges_track_loop_health():
    server = _server(_cfg())
    server.start()
    try:
        server.submit(1).result(timeout=30)
        snap = server.obs.registry.snapshot()
        assert snap["asa_serve_loop_healthy"] == 1.0
        assert snap["asa_serve_last_batch_age_seconds"] >= 0.0
    finally:
        server.stop()
    assert server.obs.registry.snapshot()["asa_serve_loop_healthy"] == 0.0


def test_corrupted_latest_falls_back_to_verified_step(tmp_path):
    cfg = _cfg(tmp_path)
    server = _server(cfg)
    _decide(server, [1, 2, 3])
    server.save(step=1)
    _decide(server, [4, 5])
    server.save(step=2)
    ckpt_dir = tmp_path / "ckpt"
    assert CKPT.verify_step(ckpt_dir, 2) == []
    leaf = sorted((ckpt_dir / "step_2").glob("*.bin"))[0]
    raw = bytearray(leaf.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    leaf.write_bytes(bytes(raw))
    assert CKPT.verify_step(ckpt_dir, 2) != []
    assert CKPT.latest_step(ckpt_dir) == 2
    assert CKPT.latest_step(ckpt_dir, verified=True) == 1
    with pytest.raises(CKPT.CheckpointCorruptError):
        _restore(cfg, step=2)
    restored = _restore(cfg, verified=True)
    assert restored._batches == 1
    assert _probe(restored, [1, 2, 3]) == \
        _probe(_restore(cfg, step=1), [1, 2, 3])


def test_full_table_sheds_coldest_lease_not_table_full():
    server = _server(_cfg(n_slots=4, tenant_ttl_s=30.0))
    for t in range(4):
        _decide(server, [t])
    for t in range(1, 4):
        _decide(server, [t])
    (d,) = _decide(server, [77])
    assert d.lead_s > 0
    assert 77 in server._slot_of and 0 not in server._slot_of
    assert server.stats["lease_evictions"] == 1
    assert server.stats["table_full"] == 0


def test_idle_lease_expires_and_frees_the_slot():
    server = _server(_cfg(n_slots=2, tenant_ttl_s=0.05))
    _decide(server, [1])
    time.sleep(0.08)
    _decide(server, [2])
    _decide(server, [3])
    assert 1 not in server._slot_of
    assert {2, 3} <= set(server._slot_of)


def test_default_config_still_raises_table_full():
    server = _server(_cfg(n_slots=2))
    _decide(server, [1, 2])
    fut = server.submit(3)
    server.step_once(wait_s=0)
    assert isinstance(fut.exception(timeout=10), TableFullError)


def test_in_batch_tenants_are_never_shed():
    server = _server(_cfg(n_slots=2, batch_size=4, tenant_ttl_s=30.0))
    futs = [server.submit(t) for t in (10, 11, 12)]
    server.step_once(wait_s=0)
    assert futs[0].result(timeout=10).lead_s > 0
    assert futs[1].result(timeout=10).lead_s > 0
    assert isinstance(futs[2].exception(timeout=10), TableFullError)
    assert server.stats["lease_evictions"] == 0
    assert set(server._slot_of) == {10, 11}
    (d,) = _decide(server, [12])
    assert d.lead_s > 0 and server.stats["lease_evictions"] == 1


def test_queue_full_sheds_with_typed_error():
    server = _server(_cfg(max_queue=2))
    f1, f2 = server.submit(1), server.submit(2)
    f3 = server.submit(3)
    assert isinstance(f3.exception(timeout=1), QueueFullError)
    assert server.stats["shed"] == 1
    assert server.obs.registry.snapshot()[
        "asa_serve_shed_queue_full_total"] == 1
    while not (f1.done() and f2.done()):
        server.step_once(wait_s=0)
    assert f1.result(timeout=10).lead_s > 0
    assert f2.result(timeout=10).lead_s > 0


def test_deadline_shed_at_batch_form():
    server = _server(_cfg())
    dead = server.submit(1, deadline_s=1e-6)
    live = server.submit(2, deadline_s=60.0)
    time.sleep(0.01)
    server.step_once(wait_s=0)
    assert isinstance(dead.exception(timeout=10), RequestExpired)
    assert live.result(timeout=10).lead_s > 0
    snap = server.obs.registry.snapshot()
    assert snap["asa_serve_shed_expired_total"] == 1
    assert snap["asa_serve_shed_total"] == 1


def test_stop_drains_and_fails_queued_with_server_stopped():
    server = _server(_cfg())
    futs = [server.submit(t) for t in range(4)]
    server.stop()
    for f in futs:
        assert isinstance(f.exception(timeout=10), ServerStopped)
    with pytest.raises(ServerStopped):
        server.submit(99)
    assert server.obs.registry.snapshot()[
        "asa_serve_stop_drained_total"] == 4


def test_repeated_stop_is_idempotent():
    server = _server(_cfg())
    server.start()
    server.submit(1).result(timeout=30)
    server.stop()
    server.stop()
    server.stop_metrics_http()
    server.stop_metrics_http()


def test_scrape_racing_shutdown_answers_500(monkeypatch):
    server = _server(_cfg())
    port = server.serve_metrics_http(port=0)
    url = f"http://127.0.0.1:{port}/stats"
    assert urllib.request.urlopen(url, timeout=5).status == 200
    monkeypatch.setattr(
        ASAServer, "stats",
        property(lambda self: (_ for _ in ()).throw(
            RuntimeError("teardown race"))))
    try:
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(url, timeout=5)
        assert exc.value.code == 500
    except RemoteDisconnected:  # pragma: no cover
        pytest.fail("handler died on the socket instead of answering 500")
    finally:
        monkeypatch.undo()
        server.stop_metrics_http()


def _chaos_property_body(seed, rng, tmp):
    """``tests/test_serve_chaos.py``'s property on the port: every future
    resolves (a Decision or a typed error) and the surviving checkpoint
    restores bitwise. The probe servers inherit ``checkpoint_every``, so
    their probes save steps too; they are stopped, which collects those
    saves before the directory goes away (the reference's body leaves
    them running: the race of ROADMAP Queue 3)."""
    cfg = ServeConfig(n_slots=6, batch_size=4,
                      checkpoint_dir=str(tmp / "ckpt"),
                      checkpoint_every=2, max_queue=64,
                      tenant_ttl_s=5.0)
    events = [schaos.step_exception(rng.randrange(1, 6)),
              schaos.crash(rng.randrange(1, 6))]
    if rng.random() < 0.5:
        burst_b = rng.randrange(1, 6)
        if all(e.batch != burst_b or e.kind != "queue_burst"
               for e in events):
            events.append(schaos.queue_burst(burst_b, 8))
    inj = schaos.ChaosInjector(schaos.ChaosSchedule(tuple(events)),
                               seed=seed)
    sup = ServeSupervisor(cfg, chaos=inj, device=CPU)
    futs = []
    sup.start()
    try:
        for _ in range(rng.randrange(10, 30)):
            op = rng.random()
            tenant = rng.randrange(10)
            if op < 0.5:
                futs.append(sup.submit(tenant))
            elif op < 0.8:
                futs.append(sup.submit(
                    tenant, observed_wait=rng.uniform(10.0, 4000.0)))
            else:
                try:
                    sup.server.evict(tenant)
                except (KeyError, ServerCrashed):
                    pass
            if rng.random() < 0.3:
                time.sleep(0.002)
        deadline = time.monotonic() + 120
        for f in futs + list(inj.burst_futures):
            remaining = deadline - time.monotonic()
            assert remaining > 0, "futures still pending at deadline"
            err = f.exception(timeout=remaining)
            assert err is None or isinstance(err, RuntimeError), \
                f"untyped error {err!r}"
    finally:
        sup.stop()
    step = CKPT.latest_step(cfg.checkpoint_dir, verified=True)
    if step is not None:
        a = _restore(cfg, step=step, verified=True)
        b = _restore(cfg, step=step, verified=True)
        try:
            assert _probe(a, range(10)) == _probe(b, range(10))
            assert torch.equal(a._table.log_p, b._table.log_p)
        finally:
            a.stop()
            b.stop()


@settings(max_examples=5, deadline=None)
@given(st.integers(min_value=0, max_value=10**9))
def test_every_future_resolves_under_chaos(seed):
    rng = random.Random(seed)
    with tempfile.TemporaryDirectory(prefix="chaos_prop_") as tmp:
        _chaos_property_body(seed, rng, Path(tmp))


@pytest.mark.parametrize("seed", [8, 11, 14])
def test_chaos_seeds_that_race_on_the_reference(seed):
    """Seeds whose reference run raced (``OSError: Directory not empty``
    when the temporary directory was removed under the probe servers'
    saves) pass on the port."""
    rng = random.Random(seed)
    with tempfile.TemporaryDirectory(prefix="chaos_seed_") as tmp:
        _chaos_property_body(seed, rng, Path(tmp))


# ============================================ tests/test_pool_properties.py
POOL_TESTS = ROOT / "tests" / "test_pool_properties.py"


def _pool_test_names() -> list[str]:
    tree = ast.parse(POOL_TESTS.read_text())
    return [n.name for n in tree.body if isinstance(n, ast.FunctionDef)
            and n.name.startswith("test_")]


@pytest.fixture(scope="module")
def port_pool_tests():
    """The reference's pool tests, loaded as their own module, with the
    name they test bound to the port's copy of the pool."""
    spec = importlib.util.spec_from_file_location("_port_pool_properties",
                                                  POOL_TESTS)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.ResourcePool = tpool.ResourcePool
    return mod


@pytest.mark.parametrize("name", _pool_test_names())
def test_pool_properties_on_the_port_copy(port_pool_tests, name):
    assert port_pool_tests.ResourcePool is tpool.ResourcePool
    getattr(port_pool_tests, name)()

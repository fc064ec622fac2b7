"""The port's sharded decision step (``serve_step(mesh=)``) and sharded
server (``ServeConfig.n_shards``, ``ASAServer(mesh=)``) against its
single-device step and server, bit for bit (CPU).

The 4 contracts of ``tests/test_serve_sharded.py``, rerun on the port at
k = 1, 2, 4 and 8 blocks: new tables (posteriors and PRNG keys, on every
replica) and decision batches equal the single-device step's; a
sequence of sharded steps stays on the single-device trajectory; two
servers fed one request stream answer alike; a sharded server saved and
restored continues bitwise. The blocks of ``ScenariosMesh([cpu] * k)``
share one replica, as the reference's fake CPU devices would each hold
an identical one.
"""

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import ScenariosMesh
from repro_torch.parallel import fleet as pfleet
from repro_torch.serve import asa as serve_asa
from repro_torch.serve.loop import ASAServer, ServeConfig

torch.set_num_threads(1)   # small tensors: threads only contend

CPU = "cpu"
KS = (1, 2, 4, 8)


def mesh_of(k: int) -> ScenariosMesh:
    return ScenariosMesh([CPU] * k)


def _query(n, seed=0):
    """A busy batch: repeated decision slots, unique observation slots
    (the invariant the host batcher guarantees)."""
    rng = np.random.default_rng(seed)
    slot = rng.integers(0, 12, n).astype(np.int32)
    has = np.zeros(n, bool)
    seen = set()
    for i in range(n):
        if int(slot[i]) not in seen and rng.random() < 0.7:
            seen.add(int(slot[i]))
            has[i] = True
    return serve_asa.QueryBatch(
        slot=torch.as_tensor(slot),
        observed_wait=torch.as_tensor(
            rng.uniform(20.0, 3000.0, n).astype(np.float32)),
        has_obs=torch.as_tensor(has))


def _assert_tables_equal(a, b):
    """``b`` may be a table or its replicas: every replica must equal."""
    for rep in ((b,) if isinstance(b, serve_asa.asa.ASAState) else b):
        for la, lb in zip(a, rep):
            assert torch.equal(la, lb)


@pytest.mark.parametrize("k", KS)
def test_serve_step_sharded_bit_identical(k):
    table = serve_asa.init_table(16, seed=3, device=CPU)
    q = _query(24)
    qp, mask = pfleet.pad_batch(q, 32)          # 32 % k == 0 for all k
    ref_t, ref_d = serve_asa.serve_step(table, qp, mask)
    sh_t, sh_d = serve_asa.serve_step(table, qp, mask, mesh=mesh_of(k))
    assert len(sh_t) == 1                       # one device, one replica
    _assert_tables_equal(ref_t, sh_t)
    for la, lb in zip(ref_d, sh_d):
        assert torch.equal(la, lb)
    assert bool(qp.has_obs.any())
    assert not all(torch.equal(a, b) for a, b in zip(table, ref_t))


@pytest.mark.parametrize("k", KS)
def test_sharded_steps_compose_bit_identical(k):
    """A whole sequence of sharded steps stays bitwise on the
    single-device trajectory (the replicas never drift across steps)."""
    mesh = mesh_of(k)
    ref = sh = serve_asa.init_table(16, seed=1, device=CPU)
    for step in range(4):
        q = _query(24, seed=step)
        qp, mask = pfleet.pad_batch(q, 32)
        ref, _ = serve_asa.serve_step(ref, qp, mask)
        sh, _ = serve_asa.serve_step(sh, qp, mask, mesh=mesh)
        _assert_tables_equal(ref, sh)


def _stream(sv, ss, seed=9, rounds=6):
    rng = np.random.default_rng(seed)
    for _ in range(rounds):
        reqs = [(int(rng.integers(0, 10)),
                 float(rng.uniform(20, 2000))
                 if rng.random() < 0.6 else None)
                for _ in range(6)]
        fa = [sv.submit(t, w) for t, w in reqs]
        fb = [ss.submit(t, w) for t, w in reqs]
        while any(not f.done() for f in fa):
            sv.step_once(wait_s=0)
        while any(not f.done() for f in fb):
            ss.step_once(wait_s=0)
        for a, b in zip(fa, fb):
            da, db = a.result(timeout=10), b.result(timeout=10)
            assert (da.lead_s, da.expected_s, da.entropy) == \
                   (db.lead_s, db.expected_s, db.entropy)


@pytest.mark.parametrize("k", KS)
def test_sharded_server_matches_vmap_server(k):
    """Two whole servers, one single-device and one sharded, fed one
    request stream answer identical decisions."""
    sv = ASAServer(ServeConfig(n_slots=16, batch_size=8), device=CPU)
    ss = ASAServer(ServeConfig(n_slots=16, batch_size=8), mesh=mesh_of(k),
                   device=CPU)
    _stream(sv, ss)
    _assert_tables_equal(sv._table, ss._table)
    if k == 1:    # n_shards builds the one-device mesh of the CPU
        sn = ASAServer(ServeConfig(n_slots=16, batch_size=8, n_shards=1),
                       device=CPU)
        _stream(ASAServer(ServeConfig(n_slots=16, batch_size=8),
                          device=CPU), sn)
        _assert_tables_equal(sv._table, sn._table)


@pytest.mark.parametrize("k", KS)
def test_sharded_restart_bitwise(tmp_path, k):
    """Durability through the sharded path: save under sharded serving
    (from the first replica), restore onto every replica, and both
    servers continue bitwise identically."""
    cfg = ServeConfig(n_slots=16, batch_size=8,
                      checkpoint_dir=str(tmp_path / "ckpt"))
    server = ASAServer(cfg, mesh=mesh_of(k), device=CPU)
    rng = np.random.default_rng(2)
    for _ in range(5):
        fut = server.submit(int(rng.integers(0, 6)),
                            float(rng.uniform(20, 2000)))
        server.step_once(wait_s=0)
        fut.result(timeout=10)
    server.save(step=1)
    restored = ASAServer.restore(cfg, step=1, mesh=mesh_of(k), device=CPU)
    _assert_tables_equal(serve_asa.first_replica(server._table),
                         restored._table)
    # range(8) admits tenants neither server has seen: post-restart
    # admissions (dirty mask + reset-key salt were checkpointed) must
    # also line up bitwise with the uninterrupted server's
    for t in range(8):
        fa = server.submit(t, observed_wait=444.0)
        fb = restored.submit(t, observed_wait=444.0)
        server.step_once(wait_s=0)
        restored.step_once(wait_s=0)
        a, b = fa.result(timeout=10), fb.result(timeout=10)
        assert (a.lead_s, a.expected_s, a.entropy) == \
               (b.lead_s, b.expected_s, b.entropy)
    _assert_tables_equal(serve_asa.first_replica(server._table),
                         restored._table)

"""The port's ASA decision step (``repro_torch.serve.asa``) and batch
padding (``repro_torch.parallel.fleet``) on the CPU.

Two parts.

* The decision-step contracts of ``tests/test_serve.py`` (fresh tenant,
  the posterior moving, update then decide within one batch, pad rows
  never touching the table), rerun on the port.
* Parity with the reference: tables grown by the reference's own
  ``serve_step`` from random observations are carried across with
  ``repro_torch.convert.asa_state``; random query batches (pad rows,
  repeated decision slots, observing rows on distinct slots) go through
  both packages' ``serve_step``. Keys, ``rounds`` and ``t`` are bitwise
  equal and ``round_loss`` exact; ``log_p`` within ``LOG_P_ATOL``
  (absolute, values down to about -60: the rounding of logsumexp, as in
  ``tests/test_torch_asa.py``); ``expected_s`` within ``EXPECTED_RTOL``
  and ``entropy`` within ``ENTROPY_ATOL``; ``lead_s`` equal except where
  the MAP bin flips at a near-tie of the reference posterior (a reference
  ``log_p`` gap of at most 2e-4), and those flips are counted (ROADMAP
  Queue 3). Measured worst cases over the three seeds' 30 batches (241
  live reads): ``log_p`` 9.5e-7, ``expected_s`` 1.0e-6 relative,
  ``entropy`` 3.1e-6, no MAP flip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bins import make_bins
from repro.parallel import fleet as jfleet
from repro.serve import asa as jserve
from repro_torch import convert
from repro_torch.core import asa as tasa
from repro_torch.core import prng
from repro_torch.parallel import fleet as tfleet
from repro_torch.serve import asa as tserve

jax.config.update("jax_threefry_partitionable", True)
torch.set_num_threads(1)   # small tensors: threads only contend

CPU = "cpu"
BINS = make_bins(53)
LOG_P_ATOL = 1e-4        # as tests/test_torch_asa.py
NEAR_TIE_GAP = 2e-4      # 2 · LOG_P_ATOL
EXPECTED_RTOL = 1.5e-5   # the engine's relative tolerance
ENTROPY_ATOL = 1e-5


def _tq(slot, wait, has) -> tserve.QueryBatch:
    return tserve.QueryBatch(
        slot=torch.as_tensor(np.asarray(slot, np.int32)),
        observed_wait=torch.as_tensor(np.asarray(wait, np.float32)),
        has_obs=torch.as_tensor(np.asarray(has, bool)))


def _jq(slot, wait, has) -> jserve.QueryBatch:
    return jserve.QueryBatch(slot=jnp.asarray(np.asarray(slot, np.int32)),
                             observed_wait=jnp.asarray(
                                 np.asarray(wait, np.float32)),
                             has_obs=jnp.asarray(np.asarray(has, bool)))


def _row(table: tasa.ASAState, s: int) -> tasa.ASAState:
    return tasa.ASAState(*(x[s] for x in table))


# ------------------------------------------------------------- contracts
def test_fresh_table_answers_prior_map():
    """A fresh slot's lead time is the uniform prior's MAP = bins[0], its
    entropy ln m."""
    table = tserve.init_table(8, device=CPU)
    q, mask = tfleet.pad_batch(_tq([5], [0.0], [False]), 4)
    _, dec = tserve.serve_step(table, q, mask)
    assert float(dec.lead_s[0]) == pytest.approx(float(BINS[0]))
    assert float(dec.entropy[0]) == pytest.approx(float(np.log(53)),
                                                  rel=1e-5)


def test_observations_move_the_posterior():
    """Repeated observations of a long wait pull the MAP to its bin."""
    table = tserve.init_table(8, device=CPU)
    for _ in range(6):
        q, mask = tfleet.pad_batch(_tq([7], [900.0], [True]), 4)
        table, dec = tserve.serve_step(table, q, mask)
    nearest = float(BINS[np.argmin(np.abs(BINS - 900.0))])
    assert float(dec.lead_s[0]) == pytest.approx(nearest)
    assert float(dec.entropy[0]) < np.log(53) - 1e-3


def test_update_then_decide_within_one_batch():
    """A query that both observes and decides answers from the
    post-scatter table (its own fresh posterior)."""
    table = tserve.init_table(4, device=CPU)
    qp, mask = tfleet.pad_batch(_tq([2], [900.0], [True]), 4)
    new_table, dec = tserve.serve_step(table, qp, mask)
    feats = tasa.posterior_features(
        _row(new_table, 2), torch.as_tensor(BINS, dtype=torch.float32))
    assert float(dec.lead_s[0]) == float(feats[0])
    assert float(dec.entropy[0]) == float(feats[2])
    assert float(dec.entropy[0]) < np.log(53) - 1e-6


def test_pad_rows_never_touch_the_table():
    """Pad rows copy row 0, its observation included; the mask keeps the
    copies out of the scatter."""
    table = tserve.init_table(4, device=CPU)
    qp, mask = tfleet.pad_batch(_tq([1], [500.0], [True]), 8)
    assert int(mask.sum()) == 1 and mask.dtype == torch.bool
    once, _ = tserve.serve_step(table, qp, mask)
    alone, _ = tserve.serve_step(table, tfleet.unpad(qp, 1),
                                 torch.ones(1, dtype=torch.bool))
    assert torch.equal(once.log_p[1], alone.log_p[1])
    for s in (0, 2, 3):
        for a, b in zip(_row(once, s), _row(table, s)):
            assert torch.equal(a, b)


def test_serve_step_leaves_its_input_table_alone():
    """The update is functional: the caller's table keeps its values, so
    a failed batch commits nothing."""
    table = tserve.init_table(4, device=CPU)
    before = [x.clone() for x in table]
    qp, mask = tfleet.pad_batch(_tq([0, 3], [50.0, 800.0], [True, True]), 4)
    tserve.serve_step(table, qp, mask)
    for a, b in zip(table, before):
        assert torch.equal(a, b)


def test_serve_step_mesh_raises_naming_the_roadmap_item():
    """The sharded step is ported (tests/test_torch_serve_sharded.py); it
    raises on a batch its mesh's blocks do not split, naming the pad."""
    from repro_torch.launch.mesh import ScenariosMesh

    table = tserve.init_table(4, device=CPU)
    qp, mask = tfleet.pad_batch(_tq([0], [0.0], [False]), 4)
    with pytest.raises(ValueError, match="pad_batch"):
        tserve.serve_step(table, qp, mask, mesh=ScenariosMesh([CPU] * 3))


def test_init_table_defaults_to_cuda():
    if torch.cuda.is_available():
        assert tserve.init_table(4).log_p.is_cuda
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.init_table(4)


def test_decisions_to_host_is_one_transfer(monkeypatch):
    """The three fields come back from one stacked (3, B) tensor."""
    table = tserve.init_table(4, device=CPU)
    qp, mask = tfleet.pad_batch(_tq([0, 1, 1], [10.0, 0.0, 0.0],
                                    [True, False, False]), 4)
    _, dec = tserve.serve_step(table, qp, mask)
    calls = []
    real = torch.Tensor.cpu

    def counting(self, *a, **k):
        calls.append(tuple(self.shape))
        return real(self, *a, **k)
    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    lead, expected, entropy = tserve.decisions_to_host(dec)
    monkeypatch.undo()
    assert calls == [(3, 4)]
    np.testing.assert_array_equal(lead, dec.lead_s.numpy())
    np.testing.assert_array_equal(expected, dec.expected_s.numpy())
    np.testing.assert_array_equal(entropy, dec.entropy.numpy())


def test_reset_slot_is_the_reference_reset():
    """A reused slot: the uniform prior and the reference loop's salted
    fold_in key, bitwise."""
    jt = jserve.init_table(6, 53, 3)
    tt = convert.asa_state(jax.tree.map(np.asarray, jt))
    for admissions in (0, 1, 17):
        jkey = jax.random.fold_in(jax.random.PRNGKey(3 ^ 0x5A5A5A5A),
                                  admissions)
        jt2 = jserve.reset_slot(jt, 4, jkey)
        tt2 = tserve.reset_slot(tt, 4, tserve.slot_key(3, admissions))
        got = convert.asa_state(jax.tree.map(np.asarray, jt2))
        for a, b in zip(tt2, got):
            assert torch.equal(a, b)


# ---------------------------------------------------------- batch padding
@pytest.mark.parametrize("b,n", [(5, 4), (8, 4), (1, 3), (3, 1)])
def test_pad_batch_and_unpad_match_the_reference(b, n):
    rng = np.random.default_rng(b * 10 + n)
    slot = rng.integers(0, 9, b).astype(np.int32)
    wait = rng.uniform(1, 4000, b).astype(np.float32)
    has = rng.random(b) < 0.5
    tq, tmask = tfleet.pad_batch(_tq(slot, wait, has), n)
    jq, jmask = jfleet.pad_batch(_jq(slot, wait, has), n)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    assert tfleet.batch_size(tq) == jfleet.batch_size(jq)
    for a, c in zip(tq, jq):
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
    for a, c in zip(tfleet.unpad(tq, b), jfleet.unpad(jq, b)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
    with pytest.raises(ValueError):
        tfleet.pad_batch(tq, 0)


def test_pad_batch_on_dicts_and_states():
    st = tasa.init_batch(53, 3, prng.PRNGKey(1))
    padded, mask = tfleet.pad_batch({"est": st, "x": torch.arange(3)}, 4)
    assert padded["est"].log_p.shape == (4, 53)
    assert torch.equal(padded["est"].key[3], st.key[0])
    assert mask.tolist() == [True, True, True, False]
    with pytest.raises(ValueError, match="no tensor leaves"):
        tfleet.batch_size({"a": None})


# ------------------------------------------------ parity with the reference
def _random_batch(rng, n_slots: int, b: int, batch: int):
    """``b`` live queries (observations on distinct slots, decisions on
    any slot, repeats included), padded to ``batch``."""
    slot = rng.integers(0, n_slots, b).astype(np.int32)
    has = rng.random(b) < 0.6
    seen: set[int] = set()
    for i in range(b):          # at most one observation per slot
        if has[i] and int(slot[i]) in seen:
            has[i] = False
        elif has[i]:
            seen.add(int(slot[i]))
    wait = np.exp(rng.uniform(np.log(5.0), np.log(9e4), b)).astype(
        np.float32)
    return slot, wait, has


def _ref_step(jt, slot, wait, has, batch):
    jq, jmask = jfleet.pad_batch(_jq(slot, wait, has), batch)
    return jserve.serve_step(jt, jq, jmask)


def _grown_reference_table(rng, n_slots: int, batches: int, batch: int):
    jt = jserve.init_table(n_slots, 53, int(rng.integers(0, 1000)))
    for _ in range(batches):
        b = int(rng.integers(1, batch + 1))
        jt, _ = _ref_step(jt, *_random_batch(rng, n_slots, b, batch), batch)
    return jt


def _compare_tables(tt: tasa.ASAState, jt) -> float:
    got = convert.asa_state(jax.tree.map(np.asarray, jt))
    for f in ("key", "rounds", "t", "round_loss"):
        assert torch.equal(getattr(tt, f), getattr(got, f)), f
    err = float((tt.log_p - got.log_p).abs().max())
    assert err <= LOG_P_ATOL, err
    return err


def _compare_decisions(tdec, jdec, j_log_p_rows: np.ndarray,
                       live: int) -> int:
    lead, expected, entropy = tserve.decisions_to_host(tdec)
    jl, je, jh = (np.asarray(x)[:live] for x in jdec)
    lead, expected, entropy = lead[:live], expected[:live], entropy[:live]
    np.testing.assert_allclose(expected, je, rtol=EXPECTED_RTOL, atol=0)
    np.testing.assert_allclose(entropy, jh, rtol=0, atol=ENTROPY_ATOL)
    flips = 0
    for i in np.flatnonzero(lead != jl):
        got = int(np.flatnonzero(BINS.astype(np.float32) == lead[i])[0])
        gap = j_log_p_rows[i].max() - j_log_p_rows[i, got]
        assert gap <= NEAR_TIE_GAP, (i, gap)
        flips += 1
    return flips


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_serve_step_parity_with_reference(seed):
    """Tables grown by the reference, carried across, then both packages
    step the same random batches, each from its own table."""
    rng = np.random.default_rng(seed)
    n_slots, batch = 24, 16
    jt = _grown_reference_table(rng, n_slots, 12, batch)
    tt = convert.asa_state(jax.tree.map(np.asarray, jt), CPU)
    flips = reads = 0
    for _ in range(10):
        live = int(rng.integers(1, batch + 1))
        slot, wait, has = _random_batch(rng, n_slots, live, batch)
        jt, jdec = _ref_step(jt, slot, wait, has, batch)
        q, mask = tfleet.pad_batch(_tq(slot, wait, has), batch)
        tt, tdec = tserve.serve_step(tt, q, mask)
        _compare_tables(tt, jt)
        j_rows = np.asarray(jt.log_p)[slot]
        flips += _compare_decisions(tdec, jdec, j_rows, live)
        reads += live
    # near-ties are rare: a flip needs two bins within logsumexp's rounding
    assert flips <= reads // 10, (flips, reads)


def test_convert_serve_state_carries_a_reference_server_tree():
    jt = jserve.init_table(6, 53, 2)
    tree = {"table": jt, "tenant_ids": np.array([3, -1, 7, -1, -1, 9],
                                                np.int32),
            "admissions": np.int32(5),
            "dirty": np.array([0, 1, 0, 0, 1, 0], bool)}
    got = convert.serve_state(jax.tree.map(np.asarray, tree), CPU)
    assert torch.equal(got["table"].key,
                       torch.as_tensor(np.asarray(jt.key), dtype=torch.int64))
    assert got["tenant_ids"].dtype == np.int32
    assert got["tenant_ids"].tolist() == [3, -1, 7, -1, -1, 9]
    assert int(got["admissions"]) == 5
    assert got["dirty"].tolist() == [False, True, False, False, True, False]

"""Live batched ASA decisions: the core of ASA-as-a-service (port of
``repro.serve.asa``).

ASA submits each stage of a workflow ahead of the current stage's end, by
the queue wait it expects for it (paper §3, Algorithm 1). This module
answers that question as a service: one **decision step** serves a padded
batch of per-tenant queries against a fixed-slot **tenant table** of
Algorithm-1 posteriors on the device (a batched ``core.asa.ASAState``,
one row per tenant slot).

A query carries (slot, observed_wait, has_obs):

* **observe**: the tenant saw a stage start after ``observed_wait``
  seconds in the queue. The slot's posterior takes the tuned §4.5 update
  (``asa.learn_wait_if``, the update the fleet engine applies), consuming
  the slot's own PRNG key.
* **decide**: every query row answers "how far ahead should the next
  stage be submitted": the MAP wait of the freshly updated posterior, with
  the posterior-mean wait and the entropy (``asa.posterior_features``).

Observations scatter first, then every decision reads the post-scatter
table, so a request that both observes and decides sees its own update.
The host batcher (``serve.loop``) sends at most one observation per slot
per batch, which keeps the scatter well defined; decisions are pure reads,
so repeated decision slots are fine.

Where the reference ``vmap``s the per-row update, the port passes the
batch (``core.asa`` takes any leading batch dims). The reference's
``t.at[tgt].set(u, mode="drop")`` sends rows that do not observe to the
index ``n``, past the table; here each field is extended by one trash row,
``index_copy_`` writes every row (the non-observing ones into the trash
row) and the first ``n`` rows are the new table. Nothing in
:func:`serve_step` reads the device from the host: the one device-to-host
read of a batch is :func:`decisions_to_host`.

The sharded step (``serve_step(mesh=)``, a ``launch.mesh.ScenariosMesh``)
holds the table as **replicas**, one per distinct device of the mesh
(:func:`replicate`). The query batch splits into the mesh's blocks; each
block's rows are updated from its device's replica; every block's target
slots and updated rows are gathered in mesh order (the reference's tiled
``all_gather``), and every replica applies the same full-batch scatter,
so the replicas stay identical and equal the single-device table bit for
bit. The decisions are read once, from the first replica, by the read
the single-device step runs. On a process group's mesh (``mesh.groups``)
each rank holds one replica: it computes its own block's rows, the
ranks' parts are all-gathered in mesh order (one call,
``parallel.fleet.all_gather_tree``) and every rank applies the full
batch's scatter to its replica, as the reference's ``gather_all``
does.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import asa, prng
from repro_torch.core.bins import make_bins
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.parallel import fleet as pfleet


class ServeStepError(RuntimeError):
    """One batch's decision step failed.

    The serve loop raises this INTO the batch's futures: containment is
    per batch, the loop itself survives (``__cause__`` carries the device
    exception; ``batch`` the dispatched-batch index). Clients retry; the
    tenant table keeps its pre-dispatch state (the functional update
    never landed)."""

    def __init__(self, msg: str, *, batch: int = -1):
        super().__init__(msg)
        self.batch = batch


class QueryBatch(NamedTuple):
    """One padded batch of tenant queries (all leaves shaped (B,))."""

    slot: torch.Tensor           # i32 tenant-table slot per query
    observed_wait: torch.Tensor  # f32 observed queue wait (seconds)
    has_obs: torch.Tensor        # bool: this query carries an observation


class DecisionBatch(NamedTuple):
    """Per-query answers (all (B,)); rows where the pad mask is False are
    computed against slot 0's copies and must be discarded."""

    lead_s: torch.Tensor      # MAP wait: the submit-lead-time ASA acts on
    expected_s: torch.Tensor  # posterior-mean wait ⟨p, θ⟩
    entropy: torch.Tensor     # Shannon entropy of p (how much ASA hedges)


@functools.lru_cache(maxsize=None)
def wait_bins(m: int, device: torch.device) -> torch.Tensor:
    """The ``m`` candidate waits as float32 on ``device``, made once per
    (m, device): a copy from host memory inside a step would synchronise.
    The copy is asynchronous (the host buffer is staged at once)."""
    host = torch.as_tensor(make_bins(m), dtype=torch.float32)
    return host.to(device, non_blocking=True)


def init_table(n_slots: int, m: int = 53, seed: int = 0, *,
               device: str | torch.device = DEFAULT_DEVICE) -> asa.ASAState:
    """The fixed-slot tenant table: ``n_slots`` independent Algorithm-1
    estimators with per-slot PRNG keys (a batched ``ASAState``)."""
    dev = resolve_device(device)
    return asa.init_batch(m, n_slots, prng.PRNGKey(seed, device=dev))


def slot_key(seed: int, admissions: int) -> torch.Tensor:
    """The fresh key of a reused slot, on the CPU:
    ``fold_in(PRNGKey(seed ^ 0x5A5A5A5A), admissions)``, the reference
    loop's salt."""
    return prng.fold_in(prng.PRNGKey(seed ^ 0x5A5A5A5A), admissions)


def reset_slot(table, slot: int, key: torch.Tensor):
    """Re-initialise one slot (tenant eviction → slot reuse): the row
    returns to the uniform p_0 = 1/m prior with a fresh PRNG key, on the
    table or on every one of its replicas. The fresh row is built on the
    CPU and copied without a synchronisation."""
    if not isinstance(table, asa.ASAState):
        return tuple(reset_slot(r, slot, key) for r in table)
    m = table.log_p.shape[-1]
    fresh = asa.init(m, key.cpu())
    out = []
    for t, f in zip(table, fresh):
        t = t.clone()
        t[slot] = f.to(t.device, non_blocking=True)
        out.append(t)
    return asa.ASAState(*out)


def pack_query(q: QueryBatch, mask: torch.Tensor) -> torch.Tensor:
    """A query batch and its mask as one ``(4, B)`` int32 tensor (the wait
    by its bits): what ``query_to`` copies, and what a process group's
    server broadcasts (``serve.loop``)."""
    return torch.stack([q.slot.to(torch.int32),
                        q.observed_wait.to(torch.float32).view(torch.int32),
                        q.has_obs.to(torch.int32), mask.to(torch.int32)])


def unpack_query(d: torch.Tensor) -> tuple[QueryBatch, torch.Tensor]:
    """``pack_query``'s inverse, on ``d``'s device."""
    return (QueryBatch(slot=d[0], observed_wait=d[1].view(torch.float32),
                       has_obs=d[2].bool()), d[3].bool())


def query_to(q: QueryBatch, mask: torch.Tensor,
             device: torch.device) -> tuple[QueryBatch, torch.Tensor]:
    """A host query batch and its mask on ``device`` in one transfer: the
    four rows packed as int32, copied without a synchronisation, and
    unpacked on the device."""
    return unpack_query(pack_query(q, mask).to(device, non_blocking=True))


def _row_updates(table: asa.ASAState, q: QueryBatch, mask: torch.Tensor
                 ) -> tuple[torch.Tensor, asa.ASAState]:
    """The batch's updated rows and their target slots: each query's row
    gathered and given the tuned §4.5 update where the query carries an
    observation (learn_wait_if leaves the other lanes, PRNG included, as
    they were); rows that do not observe target the trash row ``n``."""
    m = table.log_p.shape[-1]
    n = table.log_p.shape[0]
    bins = wait_bins(m, table.log_p.device)
    slot = q.slot.long().clamp(0, n - 1)
    rows = asa.ASAState(*(x[slot] for x in table))
    do = mask & q.has_obs
    upd = asa.learn_wait_if(rows, bins, q.observed_wait, do)
    return torch.where(do, slot, n), upd


def _scatter(table: asa.ASAState, tgt: torch.Tensor,
             upd: asa.ASAState) -> asa.ASAState:
    """Write the updated rows back (functional: the input table is left
    as it is); only real observations touch the table."""
    n = table.log_p.shape[0]

    def scatter(t: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        ext = torch.cat([t, t[:1]])
        ext.index_copy_(0, tgt, u)
        return ext[:n]
    return asa.ASAState(*(scatter(t, u) for t, u in zip(table, upd)))


def _update_body(table: asa.ASAState, q: QueryBatch,
                 mask: torch.Tensor) -> asa.ASAState:
    """Apply the batch's observations to the table."""
    return _scatter(table, *_row_updates(table, q, mask))


def _read_decisions(table: asa.ASAState, q: QueryBatch) -> DecisionBatch:
    """Answer every query row from the (post-scatter) table."""
    m = table.log_p.shape[-1]
    n = table.log_p.shape[0]
    slot = q.slot.long().clamp(0, n - 1)
    # posterior_features reads log_p alone: gather that field only
    rows = table._replace(log_p=table.log_p[slot])
    feats = asa.posterior_features(rows, wait_bins(m, table.log_p.device))
    return DecisionBatch(lead_s=feats[:, 0], expected_s=feats[:, 1],
                         entropy=feats[:, 2])


def decision_step(table: asa.ASAState, q: QueryBatch, mask: torch.Tensor
                  ) -> tuple[asa.ASAState, DecisionBatch]:
    """One batched decision step: scatter the observations, then answer
    every query from the post-scatter table (a query that both observes
    and decides sees its own update).

    ``mask`` is the validity mask from ``parallel.fleet.pad_batch``: pad
    rows (copies of query 0) never update the table, and their decision
    rows are garbage for the caller to slice off."""
    table = _update_body(table, q, mask)
    return table, _read_decisions(table, q)


def decisions_to_host(dec: DecisionBatch
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Bring a ``DecisionBatch`` to the host in ONE device-to-host
    transfer (the three fields stacked to ``(3, B)``). The call blocks
    until the dispatched ``serve_step`` has finished, so its time is the
    host-blocked device wait (``obs.serve_obs``'s ``scatter_read`` span,
    apart from the asynchronous ``device_step`` dispatch)."""
    host = torch.stack([dec.lead_s, dec.expected_s,
                        dec.entropy]).cpu().numpy()
    return host[0], host[1], host[2]


def _distinct(mesh) -> list[torch.device]:
    return list(dict.fromkeys(mesh.devices))


def replicate(table: asa.ASAState, mesh) -> tuple[asa.ASAState, ...]:
    """The table's replicas: one on each distinct device of ``mesh``, in
    the order the mesh first names them (the reference's replicated
    table). The first is the one decisions are read from and checkpoints
    are saved from."""
    return tuple(pfleet.replicate(table, d) for d in _distinct(mesh))


def first_replica(table) -> asa.ASAState:
    """The table itself, or the first of its replicas."""
    return table if isinstance(table, asa.ASAState) else table[0]


def _sharded_update(replicas: tuple[asa.ASAState, ...], q: QueryBatch,
                    mask: torch.Tensor, mesh) -> tuple[asa.ASAState, ...]:
    """Each block's rows from its device's replica, gathered in mesh
    order, then the full-batch scatter on every replica (on a process
    group's mesh: this rank's block and its one replica)."""
    devs = _distinct(mesh)
    parts = [_row_updates(replicas[devs.index(d)], bq, bm)
             for (_i, d), (bq, bm) in zip(pfleet.blocks(mesh),
                                          pfleet.split((q, mask), mesh))]
    return tuple(_scatter(r, *pfleet.gather(parts, d, mesh))
                 for r, d in zip(replicas, devs))


def serve_step(table, q: QueryBatch, mask: torch.Tensor, *, mesh=None
               ) -> tuple[asa.ASAState | tuple[asa.ASAState, ...],
                          DecisionBatch]:
    """Dispatch one padded query batch on the table's device, or, with a
    ``scenarios`` mesh, over its blocks (the batch must split evenly:
    ``loop.ServeConfig`` holds ``batch_size % n_shards == 0``). The
    sharded step takes the table or its replicas (:func:`replicate`) and
    returns the replicas; ``q`` and ``mask`` lie on the first replica's
    device. Both paths answer through the one ``_read_decisions``, so
    equal tables give equal decisions bit for bit."""
    if mesh is None:
        return decision_step(table, q, mask)
    if isinstance(table, asa.ASAState):
        table = replicate(table, mesh)
    table = _sharded_update(table, q, mask, mesh)
    return table, _read_decisions(table[0], q)

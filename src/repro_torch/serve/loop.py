"""Event-loop shell around the ASA decision step (port of
``repro.serve.loop``; the host logic is the reference's line for line).

Producers ``submit()`` requests into a ``queue.Queue``; the serve loop (a
stdlib thread) drains up to ``batch_size`` of them, pads the batch with
``parallel.fleet.pad_batch``, sends it to the table's device in one
transfer, dispatches ONE ``serve.asa.serve_step`` and resolves each
request's ``concurrent.futures.Future`` with its :class:`Decision` after
one device-to-host read of the batch's decisions (the only
synchronisation of a batch).

Host-side responsibilities (everything the decision step must not know):

* **tenant admission**: tenant ids map to fixed table slots; a new tenant
  takes a free slot (fresh slots were initialised at table build; reused
  slots are reset through ``serve.asa.reset_slot`` with the reference's
  fold_in key). A full table raises :class:`TableFullError` into the
  request's future, unless ``ServeConfig.tenant_ttl_s`` is set: slots are
  then **leased** through ``runtime.pool`` (claimed at admit, the lease
  refreshed on every request), and a full table first sweeps lapsed
  leases, then sheds the coldest idle tenant; tenants with rows in the
  forming batch are never shed.
* **observation dedup**: at most one observation per slot per batch (the
  scatter must be well defined). The batcher defers a tenant's second
  same-batch observation, and every later request of that tenant, to the
  next batch.
* **checkpoint cadence**: every ``checkpoint_every`` batches the server
  snapshots ``{table, tenant_ids, admissions, dirty}`` through
  ``runtime.checkpoint`` (``save_async``; the previous handle's
  ``result()`` is collected first, so a failed background save surfaces
  in the serve loop). ``ASAServer.restore`` resumes a server whose
  posteriors, PRNG keys included, are bitwise what the saved server held.
  The format is the reference's: either package restores the other's
  checkpoints.
* **observability**: every server carries an ``obs.serve_obs.ServeObs``:
  an always-on ``obs.registry`` metric set (``stats`` is a view over it;
  ``serve_metrics_http()`` serves ``GET /metrics``, ``/metrics.json`` and
  ``/stats``) plus request-lifecycle spans, off by default
  (``ServeConfig.obs_spans``).

Fault tolerance: a failing step fails that batch's futures with a typed
``serve.asa.ServeStepError`` and the table keeps its pre-dispatch state;
a crashed loop fails every pending future with :class:`ServerCrashed` and
signals :class:`ServeSupervisor`, which restores from the newest verified
checkpoint and restarts; ``stop()`` drains and fails what is queued with
:class:`ServerStopped`; ``max_queue`` and ``submit(deadline_s=...)`` shed
under pressure; a ``serve.chaos.ChaosInjector`` is consulted at the batch
boundary, before the device step and at checkpoint cadence.

``ASAServer``, ``ServeSupervisor`` and ``ASAServer.restore`` take
``device=`` (default ``"cuda"``) and raise without a CUDA device unless
the caller names the CPU; the loop thread sets the device it serves on.
``ServeConfig.n_shards`` (a mesh over that many devices of the server's
device type) or ``mesh=`` (a ``launch.mesh.ScenariosMesh``) select the
sharded step (``serve.asa.serve_step(mesh=)``): the table is held as
replicas, one per distinct device of the mesh, each batch splits over the
mesh's blocks, and the queries are served on the first replica's device.
Checkpoints are saved from the first replica and restored onto every
replica; ``ServeSupervisor`` passes the mesh through its restarts.

On a process group's mesh (``launch.mesh.make_scenarios_mesh`` under
``parallel.dist``) each rank holds one replica. Rank 0's ``ASAServer``
owns admission, leases, futures, checkpoints and ``obs``; each step it
broadcasts one message (the padded batch and its mask as
``serve.asa.pack_query`` packs them, the slot resets its admissions
made since the last message, a kind: step, stop or keep-alive, and the
replica the server started from: fresh, or the checkpoint step its
``restore`` read), and the other ranks run :func:`follow` on those
messages: they start their replicas from the one the first message
names, then apply the same resets and step their own block of the same
batch. ``stop()`` ends the followers (the server cannot start again).
A step that fails after its message went out fails its batch and ends
the loop, since the replicas may then differ. ``save`` writes rank 0's
replica; rank 0's ``restore`` and the followers read the same file.
``ServeSupervisor`` refuses a process group's mesh (ROADMAP Queue 1).

The registry is not part of the checkpoint: counters describe this
process's lifetime; a restored server starts them at zero while answering
bitwise-identically.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch.core import asa as core_asa
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.launch.mesh import make_scenarios_mesh
from repro_torch.obs.serve_obs import ServeObs
from repro_torch.parallel import dist
from repro_torch.parallel import fleet as pfleet
from repro_torch.runtime import checkpoint
from repro_torch.runtime.pool import Claim, ResourcePool
from repro_torch.serve import asa as serve_asa


# the kinds of a process group's step message (see the module docstring)
MSG_STEP, MSG_STOP, MSG_KEEPALIVE, MSG_RESETS = 0, 1, 2, 3
# rank 0 sends a keep-alive once it has sent nothing for this share of the
# group's collective timeout, so an idle server's followers never reach it
KEEPALIVE_SHARE = 0.25
# a step message's int32 words: kind, the replica it started from (-1
# fresh, else the checkpoint step), the resets count; then the resets'
# slots and admission salts (``batch_size`` each) and the packed batch
_HEAD = 3


def _message_size(cfg: "ServeConfig") -> int:
    return _HEAD + 2 * cfg.batch_size + 4 * cfg.batch_size


def _group_of(mesh):
    return getattr(mesh, "groups", None)


class TableFullError(RuntimeError):
    """Every tenant slot is occupied; evict a tenant first (or run with
    ``ServeConfig.tenant_ttl_s`` so pressure sheds the coldest lease)."""


class ServerStopped(RuntimeError):
    """The server was stopped: raised by ``submit()`` after ``stop()``,
    and failed into every future ``stop()`` drained."""


class ServerCrashed(RuntimeError):
    """The serve loop died: failed into every queued/deferred future at
    crash time (``__cause__`` carries the loop's exception) and raised
    by ``submit()`` against the dead incarnation."""


class QueueFullError(RuntimeError):
    """Bounded ingress (``ServeConfig.max_queue``) shed this request at
    submit time; resubmit with backoff."""


class RequestExpired(RuntimeError):
    """The request's ``deadline_s`` passed before batch formation; the
    decision would have arrived too late to act on, so it was shed."""


@dataclass(frozen=True)
class ServeConfig:
    """Static server parameters."""

    n_slots: int = 1024        # fixed tenant-table capacity
    m: int = 53                # wait-bin count (paper §4.3)
    batch_size: int = 256      # queries per step (the padded shape)
    n_shards: Optional[int] = None  # sharded step over N devices
    batch_wait_s: float = 0.002     # max idle wait for the first request
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0  # batches between async snapshots (0 = off)
    seed: int = 0
    obs_spans: bool = False    # record request-lifecycle spans (wall-clock)
    metrics_port: Optional[int] = None  # start() scrapes here (0 = any)
    max_queue: Optional[int] = None  # bounded ingress (None = unbounded)
    tenant_ttl_s: Optional[float] = None  # slot-lease TTL (None = no leases)

    def __post_init__(self) -> None:
        if self.n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {self.n_slots}")
        if self.batch_size < 1:
            raise ValueError(
                f"batch_size must be >= 1, got {self.batch_size}")
        if self.n_shards is not None and \
                self.batch_size % self.n_shards != 0:
            raise ValueError(
                f"batch_size {self.batch_size} not divisible by n_shards "
                f"{self.n_shards}: the padded batch must split evenly "
                "over the mesh")
        if self.checkpoint_every and not self.checkpoint_dir:
            raise ValueError("checkpoint_every set without checkpoint_dir")
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(
                f"max_queue must be >= 1 (or None), got {self.max_queue}")
        if self.tenant_ttl_s is not None and self.tenant_ttl_s <= 0:
            raise ValueError(
                f"tenant_ttl_s must be > 0 (or None), "
                f"got {self.tenant_ttl_s}")


@dataclass
class Request:
    """One tenant query: an optional observed stage wait to learn from,
    and (always) the submit-lead-time decision for the next stage.

    ``deadline_s`` is an *absolute* ``time.monotonic()`` deadline
    (stamped by ``submit(deadline_s=...)`` from the relative value);
    ``rid``/``t_enqueue`` are observability bookkeeping stamped by
    ``submit()`` when span recording is on (-1/0.0 otherwise)."""

    tenant: int
    observed_wait: Optional[float] = None
    deadline_s: Optional[float] = None
    rid: int = -1
    t_enqueue: float = 0.0


@dataclass
class Decision:
    """The answer: submit the next stage ``lead_s`` seconds before the
    current stage's expected end (MAP wait); ``expected_s``/``entropy``
    report the posterior mean and how much the estimator still hedges."""

    tenant: int
    lead_s: float
    expected_s: float
    entropy: float


class ASAServer:
    """Batched ASA decision service over a fixed-slot tenant table."""

    def __init__(self, cfg: ServeConfig, mesh=None,
                 obs: Optional[ServeObs] = None, chaos=None, *,
                 device: str | torch.device = DEFAULT_DEVICE):
        self.cfg = cfg
        self._device = resolve_device(device)
        if self._device.type == "cuda" and self._device.index is None:
            # the loop thread sets this device: it needs its index
            self._device = torch.device("cuda", torch.cuda.current_device())
        if mesh is None and cfg.n_shards is not None:
            mesh = make_scenarios_mesh(cfg.n_shards, device=self._device)
        self._mesh = mesh
        self._group = _group_of(mesh)
        if self._group is not None and self._group.index != 0:
            raise ValueError(
                f"rank {self._group.index} of a process group's server "
                "follows rank 0's: run serve.loop.follow there")
        self._resets: list[tuple[int, int]] = []  # (slot, salt) unsent
        self._origin = -1            # fresh; restore: the step it read
        self._released = False       # the followers were sent MSG_STOP
        self._last_message = time.monotonic()
        self._obs = obs if obs is not None else \
            ServeObs(spans=cfg.obs_spans)
        self._chaos = chaos
        self._table = serve_asa.init_table(cfg.n_slots, cfg.m, cfg.seed,
                                           device=self._device)
        if mesh is not None:
            # the replicas; queries are served on the first one's device
            self._table = serve_asa.replicate(self._table, mesh)
            self._device = self._table[0].log_p.device
        # host-side tenant bookkeeping: the (n_slots,) id array is part of
        # the checkpointed state; the dict/free-list are derived views.
        # int32 on purpose: the reference's codec restores through jnp,
        # which is 32-bit without x64 — tenant ids must fit i32
        self._tenant_ids = np.full(cfg.n_slots, -1, np.int32)
        self._slot_of: dict[int, int] = {}
        self._free: deque[int] = deque(range(cfg.n_slots))
        self._dirty: set[int] = set()   # freed slots needing a reset
        self._admissions = 0            # salts reset keys
        self._requests_of: dict[int, int] = {}  # per-tenant lifetime count
        self._queue: "queue.Queue[tuple[Request, Future]]" = queue.Queue()
        self._deferred: deque[tuple[Request, Future]] = deque()
        self._batches = 0
        self._ckpt_handle: Optional[checkpoint.AsyncSave] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._http: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        # ingress gate: submit() checks the lifecycle flags and enqueues
        # under this lock; stop()/crash drain under it too — so no
        # producer can slip a future into a queue that was already
        # drained (the no-hung-futures invariant)
        self._ingress_lock = threading.Lock()
        self._stopped = False
        self._crashed: Optional[BaseException] = None
        self._crash_event = threading.Event()
        self._last_batch_ts = time.monotonic()
        # slot leases (tenant_ttl_s): one pool allocation covers the
        # table; each admitted tenant claims 1 slice with an expiry the
        # serving path refreshes — sweep/LRU shed both run off it
        self._pool: Optional[ResourcePool] = None
        self._lease_of: dict[int, Claim] = {}
        self._tenant_of_claim: dict[int, int] = {}
        if cfg.tenant_ttl_s is not None:
            self._pool = ResourcePool()
            self._pool.add_allocation(cfg.n_slots)
            self._pool.on_revoke.append(self._on_lease_revoked)
        self._obs.g_free_slots.set(len(self._free))
        # fn-backed watchdog: the age keeps growing while the loop is
        # stuck, which is exactly when nothing would push a plain gauge
        self._obs.g_last_batch_age.set_fn(
            lambda: max(0.0, time.monotonic() - self._last_batch_ts))

    @property
    def obs(self) -> ServeObs:
        """The server's registry + span recorder (always present)."""
        return self._obs

    # ------------------------------------------------------------ tenants
    @property
    def n_tenants(self) -> int:
        return len(self._slot_of)

    def _grant_lease(self, tenant: int, now: float) -> None:
        lease = self._pool.claim(
            1, expires_at=now + self.cfg.tenant_ttl_s)
        if lease is not None:  # pool mirrors _free; None only if skewed
            self._lease_of[tenant] = lease
            self._tenant_of_claim[lease.id] = tenant

    def _drop_lease(self, tenant: int) -> None:
        lease = self._lease_of.pop(tenant, None)
        if lease is not None:
            self._tenant_of_claim.pop(lease.id, None)
            self._pool.release(lease)   # no-op if already lapsed

    def _on_lease_revoked(self, lease: Claim) -> None:
        # sweep_expired lapsed an idle tenant's lease: evict it (the
        # sweep already released the slices; evict frees the table slot)
        tenant = self._tenant_of_claim.pop(lease.id, None)
        if tenant is None:
            return
        self._lease_of.pop(tenant, None)
        if tenant in self._slot_of:
            self.evict(tenant)
            self._obs.c_lease_evictions.inc()

    def _shed_coldest(self, protected) -> None:
        """Table full under leases: evict the idlest tenant (oldest
        lease deadline; ties by claim id — deterministic), never one
        whose request already holds a row in the forming batch."""
        cands = [(c.expires_at, c.id, t) for t, c in self._lease_of.items()
                 if t not in protected]
        if not cands:
            return
        _, _, victim = min(cands)
        self.evict(victim)   # evict() drops the lease
        self._obs.c_lease_evictions.inc()
        self._obs.instant("lease_evict", self._obs.now(),
                          {"tenant": victim, "reason": "pressure"})

    def _admit(self, tenant: int, protected=frozenset()) -> int:
        if self._pool is not None:
            now = time.monotonic()
            self._pool.sweep_expired(now)   # on_revoke evicts idle tenants
            if not self._free:
                self._shed_coldest(protected)
        if not self._free:
            raise TableFullError(
                f"all {self.cfg.n_slots} tenant slots occupied")
        slot = self._free.popleft()
        if slot in self._dirty:
            # slot reuse: back to the uniform prior with a fresh key
            key = serve_asa.slot_key(self.cfg.seed, self._admissions)
            self._table = serve_asa.reset_slot(self._table, slot, key)
            self._dirty.discard(slot)
            if self._group is not None:
                self._resets.append((slot, self._admissions))
        self._admissions += 1
        self._slot_of[tenant] = slot
        self._tenant_ids[slot] = tenant
        if self._pool is not None:
            self._grant_lease(tenant, now)
        o = self._obs
        o.c_admissions.inc()
        o.g_tenants.set(len(self._slot_of))
        o.g_free_slots.set(len(self._free))
        o.instant("admit", o.now(), {"tenant": tenant, "slot": slot})
        return slot

    def evict(self, tenant: int) -> None:
        """Free a tenant's slot (its posterior resets on slot reuse).

        The tenant's lifetime request total is snapshotted into the
        registry (``asa_serve_evicted_requests_total``) at this moment,
        so fleet accounting survives the eviction — ``stats`` no longer
        silently loses an evicted tenant's counts."""
        if self._pool is not None:
            self._drop_lease(tenant)
        slot = self._slot_of.pop(tenant)
        self._tenant_ids[slot] = -1
        self._dirty.add(slot)
        self._free.append(slot)
        lifetime = self._requests_of.pop(tenant, 0)
        o = self._obs
        o.c_evictions.inc()
        o.c_evicted_requests.inc(lifetime)
        o.g_tenants.set(len(self._slot_of))
        o.g_free_slots.set(len(self._free))
        o.instant("evict", o.now(),
                  {"tenant": tenant, "slot": slot, "requests": lifetime})

    # ------------------------------------------------------------ serving
    def submit(self, tenant: int,
               observed_wait: Optional[float] = None,
               deadline_s: Optional[float] = None) -> Future:
        """Enqueue one request; the future resolves to a Decision (or a
        typed error — never hangs).  ``deadline_s`` is relative seconds:
        a request still queued that long past now is shed with
        :class:`RequestExpired` instead of dispatched uselessly late.
        Raises :class:`ServerStopped`/:class:`ServerCrashed` immediately
        against a dead server; a full bounded queue *fails the future*
        with :class:`QueueFullError` (shedding, not an API error)."""
        fut: Future = Future()
        req = Request(tenant, observed_wait)
        if deadline_s is not None:
            req.deadline_s = time.monotonic() + deadline_s
        o = self._obs
        with self._ingress_lock:
            if self._crashed is not None:
                raise ServerCrashed(
                    "serve loop crashed; restore/restart before "
                    "submitting") from self._crashed
            if self._stopped:
                raise ServerStopped(
                    "server is stopped: submit() rejected")
            o.c_requests.inc()
            o.g_inflight.inc()
            if observed_wait is not None:
                o.c_observations.inc()
            if o.spans:
                req.rid = o.next_rid()
                req.t_enqueue = time.perf_counter()
                o.enqueue(req.rid, tenant, req.t_enqueue)
            if (self.cfg.max_queue is not None
                    and self._queue.qsize() >= self.cfg.max_queue):
                o.c_shed.inc()
                o.c_shed_queue_full.inc()
                fut.set_exception(QueueFullError(
                    f"ingress queue at max_queue={self.cfg.max_queue}; "
                    f"request for tenant {tenant} shed"))
                o.resolve(req.rid, tenant, req.t_enqueue, o.now(),
                          error="queue_full")
                return fut
            self._queue.put((req, fut))
        return fut

    def _drain(self, wait_s: float) -> list[tuple[Request, Future]]:
        """Pull queued requests into the deferred deque, then pick the
        next batch in order — shedding expired-deadline requests, and
        deferring any tenant whose second same-batch observation would
        break the unique-scatter invariant."""
        pending = self._deferred
        timeout = wait_s if not pending else 0.0
        while True:
            try:
                item = (self._queue.get(timeout=timeout)
                        if timeout > 0 else self._queue.get_nowait())
            except queue.Empty:
                break
            pending.append(item)
            timeout = 0.0
        batch: list[tuple[Request, Future]] = []
        held: deque[tuple[Request, Future]] = deque()
        obs_seen: set[int] = set()
        blocked: set[int] = set()
        o = self._obs
        t_d = o.now()  # one defer timestamp per drain: deferral events
        #                are batch-granular, a clock read each is not free
        now_mono = time.monotonic()  # one deadline check point per drain
        while pending and len(batch) < self.cfg.batch_size:
            req, fut = pending.popleft()
            if req.deadline_s is not None and now_mono >= req.deadline_s:
                # too late to act on the decision: shed at batch-form
                fut.set_exception(RequestExpired(
                    f"tenant {req.tenant}: deadline passed "
                    f"{now_mono - req.deadline_s:.3f}s before batch "
                    "formation"))
                o.c_shed.inc()
                o.c_shed_expired.inc()
                o.resolve(req.rid, req.tenant, req.t_enqueue, t_d,
                          error="expired")
                continue
            if req.tenant in blocked:
                o.defer(req.rid, req.tenant, t_d)
                held.append((req, fut))
                continue
            if req.observed_wait is not None:
                if req.tenant in obs_seen:
                    # second observation for this slot: defer it (and all
                    # later requests of this tenant — order preserved)
                    blocked.add(req.tenant)
                    o.defer(req.rid, req.tenant, t_d)
                    held.append((req, fut))
                    continue
                obs_seen.add(req.tenant)
            batch.append((req, fut))
        held.extend(pending)
        self._deferred = held
        o.g_deferred.set(len(held))
        return batch

    def step_once(self, wait_s: Optional[float] = None) -> int:
        """Drain + dispatch one batch; returns the number of requests
        answered (0 when the queue stayed empty).

        Containment contract: everything from batch-form to the host
        decision read runs under a per-batch guard — a failure there
        resolves this batch's futures with
        :class:`serve.asa.ServeStepError` and returns; the table
        keeps its pre-dispatch state (the functional update commits only
        after the host read), and the loop lives on.  Only an exception
        *outside* the guard (e.g. an injected crash at the boundary)
        kills the loop — and then the crash path drains everything."""
        if self._released:
            raise ServerStopped("the process group's followers were "
                                "stopped: this server cannot step again")
        if self._chaos is not None:
            # boundary hook: bursts land in the queue (drained below, or
            # by the crash path), a crash raise escapes to _run
            self._chaos.on_batch_boundary(self)
        o = self._obs
        t0 = o.now()
        batch = self._drain(self.cfg.batch_wait_s
                            if wait_s is None else wait_s)
        if not batch:
            return 0
        # tenants with rows in THIS batch must survive pressure eviction:
        # a shed-then-readmit inside one batch would reuse a slot within
        # a single scatter
        protected = {req.tenant for req, _f in batch} \
            if self._pool is not None else frozenset()
        now_lease = time.monotonic() if self._pool is not None else 0.0
        slots = np.zeros(len(batch), np.int32)
        waits = np.zeros(len(batch), np.float32)
        has = np.zeros(len(batch), bool)
        live: list[tuple[int, Future, Request]] = []  # (row, future, req)
        for i, (req, fut) in enumerate(batch):
            slot = self._slot_of.get(req.tenant)
            if slot is None:
                try:
                    slot = self._admit(req.tenant, protected)
                except TableFullError as e:
                    fut.set_exception(e)
                    o.c_table_full.inc()
                    tf = o.now()
                    o.instant("table_full", tf, {"tenant": req.tenant})
                    o.resolve(req.rid, req.tenant, req.t_enqueue, tf,
                              error="table_full")
                    continue
            elif self._pool is not None:
                # serving traffic refreshes the lease: only tenants idle
                # a full TTL are sweep/LRU candidates
                lease = self._lease_of.get(req.tenant)
                if lease is not None:
                    self._pool.renew(
                        lease, now_lease + self.cfg.tenant_ttl_s)
            slots[i] = slot
            if req.observed_wait is not None:
                waits[i] = req.observed_wait
                has[i] = True
            self._requests_of[req.tenant] = \
                self._requests_of.get(req.tenant, 0) + 1
            live.append((i, fut, req))
        if not live:  # every request failed admission — nothing to serve
            return 0
        sent = False
        try:
            if self._chaos is not None:
                self._chaos.before_device_step(self._batches)
            t1 = o.now()
            q = serve_asa.QueryBatch(
                slot=torch.from_numpy(slots),
                observed_wait=torch.from_numpy(waits),
                has_obs=torch.from_numpy(has))
            # pad to the one dispatched (batch_size,) shape; the mask
            # guards the pad rows (copies of query 0) from ever touching
            # the table; then one transfer to the table's device
            qp, mask = pfleet.pad_batch(q, self.cfg.batch_size)
            if self._group is None:
                qp, mask = serve_asa.query_to(qp, mask, self._device)
            else:
                packed = serve_asa.pack_query(qp, mask)
                sent = True
                self._send(MSG_STEP, packed)
                qp, mask = serve_asa.unpack_query(
                    packed.to(self._device, non_blocking=True))
            t2 = o.now()
            new_table, dec = serve_asa.serve_step(self._table, qp, mask,
                                                  mesh=self._mesh)
            t3 = o.now()
            # ONE host-blocked device read for the whole decision batch —
            # the scatter-read leg of the request lifecycle
            lead, expected, entropy = serve_asa.decisions_to_host(dec)
        except Exception as e:
            # per-batch containment: this batch's futures fail typed,
            # the table keeps its pre-dispatch state, the loop survives
            err = serve_asa.ServeStepError(
                f"decision step failed at batch {self._batches}: {e!r}",
                batch=self._batches)
            err.__cause__ = e
            t_err = o.now()
            for _i, fut, req in live:
                fut.set_exception(err)
                o.resolve(req.rid, req.tenant, req.t_enqueue, t_err,
                          error="step_error")
            o.c_step_errors.inc()
            o.instant("step_error", t_err,
                      {"batch": self._batches, "error": repr(e)})
            if sent:
                # the followers may have stepped: the replicas can no
                # longer be held equal, so the loop ends here
                raise err
            return 0
        self._table = new_table   # commit only after the read succeeded
        t4 = o.now()
        # one resolve timestamp + one bulk resolve for the whole batch —
        # the requests leave together, and per-request observability
        # calls are measurable at full rate (the bench's overhead
        # budget pays for them)
        t_res = o.now()
        for i, fut, req in live:
            fut.set_result(Decision(req.tenant, float(lead[i]),
                                    float(expected[i]),
                                    float(entropy[i])))
        o.resolve_many([req for _i, _f, req in live], t_res)
        self._batches += 1
        self._last_batch_ts = time.monotonic()
        o.c_batches.inc()
        o.c_decisions.inc(len(live))
        o.c_padded.inc(self.cfg.batch_size - len(live))
        if o.spans:
            t5 = o.now()
            fill = len(live) / self.cfg.batch_size
            o.h_batch_fill.observe(fill)
            o.h_device_step.observe(t3 - t2)
            o.h_scatter_read.observe(t4 - t3)
            o.span("batch_form", t0, t1, {
                "batch": self._batches, "size": len(batch),
                "live": len(live), "batch_size": self.cfg.batch_size,
                "n_obs": int(has.sum()),
                "pad_fraction": 1.0 - fill,
                "deferred": len(self._deferred)})
            o.span("pad", t1, t2)
            o.span("device_step", t2, t3, {"async_dispatch": True})
            o.span("scatter_read", t3, t4, {"host_blocked": True})
            o.span("future_resolve", t4, t5, {"resolved": len(live)})
        if (self.cfg.checkpoint_every
                and self._batches % self.cfg.checkpoint_every == 0):
            # cadenced saves are contained: a failed snapshot (or a
            # previous async save surfacing its failure here) is counted
            # and serving continues — the on-disk latest stays the
            # previous good step.  The direct save_async() API still
            # raises (callers own their error handling).
            try:
                if self._chaos is not None:
                    self._chaos.on_checkpoint(self._batches)
                self.save_async()
            except Exception as e:
                o.c_ckpt_failures.inc()
                o.instant("checkpoint_failure", o.now(),
                          {"batch": self._batches, "error": repr(e)})
                h = self._ckpt_handle
                if h is not None and h.done():
                    # its failure surfaced here; don't re-raise it at
                    # stop()/next cadence
                    self._ckpt_handle = None
        return len(live)

    def _send(self, kind: int, packed: Optional[torch.Tensor] = None
              ) -> None:
        """Broadcast one message to the followers (rank 0 of a process
        group): the unsent slot resets, then ``kind`` with ``packed``
        (``serve.asa.pack_query``'s batch) where it is a step. Resets
        beyond a message's room go first in messages of their own."""
        cap = self.cfg.batch_size
        while True:
            resets, self._resets = self._resets[:cap], self._resets[cap:]
            last = not self._resets
            msg = torch.zeros(_message_size(self.cfg), dtype=torch.int32)
            msg[0] = kind if last else MSG_RESETS
            msg[1] = self._origin
            msg[2] = len(resets)
            if resets:
                msg[_HEAD:_HEAD + len(resets)] = torch.tensor(
                    [r[0] for r in resets])
                msg[_HEAD + cap:_HEAD + cap + len(resets)] = torch.tensor(
                    [r[1] for r in resets])
            if last and packed is not None:
                msg[_HEAD + 2 * cap:] = packed.reshape(-1)
            dist.broadcast(msg, self._group, 0)
            self._last_message = time.monotonic()
            if last:
                return

    def _keepalive(self) -> None:
        if (self._group is not None and not self._released and
                time.monotonic() - self._last_message >
                KEEPALIVE_SHARE * dist.timeout_s()):
            self._send(MSG_KEEPALIVE)

    def _release(self) -> None:
        """End the followers' loops (once)."""
        if self._group is not None and not self._released:
            self._send(MSG_STOP)
            self._released = True

    def _drain_all_pending_locked(self) -> list[tuple[Request, Future]]:
        """Pop every queued + deferred item (caller holds _ingress_lock)."""
        items: list[tuple[Request, Future]] = []
        while True:
            try:
                items.append(self._queue.get_nowait())
            except queue.Empty:
                break
        items.extend(self._deferred)
        self._deferred = deque()
        return items

    def _crash(self, exc: BaseException) -> None:
        """The loop thread died: fail everything pending with a typed
        error (no future may hang), mark the incarnation dead, and
        signal the supervisor."""
        o = self._obs
        with self._ingress_lock:
            self._crashed = exc
            pending = self._drain_all_pending_locked()
        t = o.now()
        for req, fut in pending:
            err = ServerCrashed(
                f"serve loop crashed before this request was served: "
                f"{exc!r}")
            err.__cause__ = exc
            fut.set_exception(err)
            o.resolve(req.rid, req.tenant, req.t_enqueue, t,
                      error="crashed")
        o.c_crashes.inc()
        o.g_loop_healthy.set(0.0)
        o.g_deferred.set(0)
        o.instant("crash", t, {"batch": self._batches,
                               "error": repr(exc),
                               "drained": len(pending)})
        self._crash_event.set()

    def _run(self) -> None:
        o = self._obs
        o.g_loop_healthy.set(1.0)
        self._last_batch_ts = time.monotonic()
        try:
            if self._device.type == "cuda":
                torch.cuda.set_device(self._device)
            while not self._stop.is_set():
                if self.step_once() == 0:
                    # queue stayed empty for batch_wait_s: yield briefly
                    # so a stopped server exits promptly (sqswatcher's
                    # idle poll)
                    self._keepalive()
                    self._stop.wait(self.cfg.batch_wait_s)
            o.g_loop_healthy.set(0.0)
        except BaseException as e:
            self._crash(e)

    def start(self) -> None:
        """Run the serve loop in a daemon thread (plus the metrics
        endpoint when ``ServeConfig.metrics_port`` is set).  A stopped
        server restarts cleanly; a crashed one must be rebuilt
        (``ASAServer.restore`` / :class:`ServeSupervisor`)."""
        if self._thread is not None:
            raise RuntimeError("server already started")
        if self._released:
            raise ServerStopped("the process group's followers were "
                                "stopped: this server cannot start again")
        if self._crashed is not None:
            raise ServerCrashed(
                "cannot start a crashed server; restore a fresh one "
                "from its checkpoint") from self._crashed
        with self._ingress_lock:
            self._stopped = False
        if self.cfg.metrics_port is not None and self._http is None:
            self.serve_metrics_http(self.cfg.metrics_port)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="asa-serve-loop")
        self._thread.start()

    def stop(self) -> None:
        """Stop the loop and **drain-and-fail** everything still queued
        or deferred with :class:`ServerStopped` — no future ever hangs
        across a stop.  Idempotent: repeated calls are no-ops.  The
        server can ``start()`` again afterwards (state intact); while
        stopped, ``submit()`` raises immediately. On a process group's
        mesh it also ends the followers, and the server cannot start
        again."""
        o = self._obs
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._stop.clear()
        with self._ingress_lock:
            self._stopped = True
            pending = self._drain_all_pending_locked()
        if pending:
            t = o.now()
            for req, fut in pending:
                fut.set_exception(ServerStopped(
                    "server stopped before this request was served"))
                o.resolve(req.rid, req.tenant, req.t_enqueue, t,
                          error="stopped")
            o.c_stop_drained.inc(len(pending))
            o.g_deferred.set(0)
        o.g_loop_healthy.set(0.0)
        self.stop_metrics_http()
        if self._crashed is None:
            self._release()
        if self._ckpt_handle is not None:
            handle, self._ckpt_handle = self._ckpt_handle, None
            handle.result()

    # ------------------------------------------------------ metrics scrape
    def serve_metrics_http(self, port: int = 0,
                           host: str = "127.0.0.1") -> int:
        """Start the scrape endpoint on a stdlib ``ThreadingHTTPServer``
        daemon thread; returns the bound port (pass ``port=0`` for an
        ephemeral one).

        * ``GET /metrics`` — Prometheus text exposition of the registry;
        * ``GET /metrics.json`` — the registry snapshot as JSON;
        * ``GET /stats`` — the ``stats`` view (backward-compatible keys).

        Scrapes read live metric values metric-by-metric — a slow
        scraper never blocks the serve loop.  A scrape racing a shutdown
        answers 500 (the handler thread never dies on a socket error).
        """
        if self._http is not None:
            raise RuntimeError("metrics endpoint already running")
        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 (stdlib API name)
                try:
                    if self.path == "/metrics":
                        body = server._obs.registry.prometheus_text() \
                            .encode()
                        ctype = "text/plain; version=0.0.4; charset=utf-8"
                    elif self.path == "/metrics.json":
                        body = json.dumps(
                            server._obs.registry.snapshot()).encode()
                        ctype = "application/json"
                    elif self.path == "/stats":
                        body = json.dumps(server.stats).encode()
                        ctype = "application/json"
                    else:
                        self.send_error(404)
                        return
                except Exception:
                    # snapshot raced a shutdown/teardown: a well-formed
                    # 500 beats an exception unwinding the handler thread
                    try:
                        self.send_error(500)
                    except OSError:
                        pass
                    return
                try:
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except OSError:
                    pass  # client hung up mid-write; nothing to answer

            def log_message(self, *args) -> None:  # quiet by design
                pass

        self._http = ThreadingHTTPServer((host, port), Handler)
        self._http_thread = threading.Thread(
            target=self._http.serve_forever, daemon=True,
            name="asa-serve-metrics")
        self._http_thread.start()
        return self._http.server_address[1]

    def stop_metrics_http(self) -> None:
        """Stop the scrape endpoint; idempotent (extra calls no-op)."""
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()
            self._http = None
        if self._http_thread is not None:
            self._http_thread.join()
            self._http_thread = None

    # --------------------------------------------------------- durability
    def _state_tree(self) -> dict:
        # the full durable state: posteriors AND the host bookkeeping
        # that shapes future admissions (the dirty mask and the
        # admissions counter that salts reset keys) — so a restored
        # server admits new tenants with the exact keys the
        # uninterrupted one would have used
        dirty = np.zeros(self.cfg.n_slots, bool)
        if self._dirty:
            dirty[list(self._dirty)] = True
        return {"table": serve_asa.first_replica(self._table),
                "tenant_ids": self._tenant_ids,
                "admissions": np.int32(self._admissions), "dirty": dirty}

    def save(self, step: Optional[int] = None) -> Path:
        """Synchronous snapshot through the checkpoint codec."""
        assert self.cfg.checkpoint_dir, "ServeConfig.checkpoint_dir unset"
        return checkpoint.save(self._state_tree(), self.cfg.checkpoint_dir,
                               self._batches if step is None else step)

    def save_async(self, step: Optional[int] = None) -> checkpoint.AsyncSave:
        """Background snapshot; a previously-failed save raises HERE (the
        handle's result() re-raises), so cadenced saves can't fail
        silently batch after batch.  The time blocked collecting the
        previous handle is the checkpoint-cadence stall the observability
        layer reports (counter + ``checkpoint_stall`` span)."""
        assert self.cfg.checkpoint_dir, "ServeConfig.checkpoint_dir unset"
        o = self._obs
        if self._ckpt_handle is not None:
            ts = time.perf_counter()
            self._ckpt_handle.result()
            stall = time.perf_counter() - ts
            o.c_ckpt_stall_s.inc(stall)
            if o.spans:
                o.span("checkpoint_stall", ts, ts + stall,
                       {"batch": self._batches})
        o.c_checkpoints.inc()
        self._ckpt_handle = checkpoint.save_async(
            self._state_tree(), self.cfg.checkpoint_dir,
            self._batches if step is None else step)
        return self._ckpt_handle

    @classmethod
    def restore(cls, cfg: ServeConfig, step: Optional[int] = None,
                mesh=None, obs: Optional[ServeObs] = None, chaos=None,
                verified: bool = False, *,
                device: str | torch.device = DEFAULT_DEVICE
                ) -> "ASAServer":
        """Resume a server from its checkpoint: posteriors (PRNG keys
        included) and the tenant map come back exactly, so the restarted
        server's decisions are bitwise those of the uninterrupted one.
        ``verified=True`` picks the newest checkpoint that passes
        integrity verification (a corrupted latest degrades to the
        previous good step).  Registry counters restart at zero — they
        describe the process, not the estimator — unless a shared
        ``obs`` carries them across incarnations (the supervisor does).
        """
        assert cfg.checkpoint_dir, "ServeConfig.checkpoint_dir unset"
        if step is None:
            step = checkpoint.latest_step(cfg.checkpoint_dir,
                                          verified=verified)
            if step is None:
                raise FileNotFoundError(
                    f"no {'verified ' if verified else ''}checkpoint "
                    f"under {cfg.checkpoint_dir}")
        server = cls(cfg, mesh=mesh, obs=obs, chaos=chaos, device=device)
        tree = checkpoint.restore(server._state_tree(),
                                  cfg.checkpoint_dir, step,
                                  device=server._device)
        server._table = tree["table"]
        if server._mesh is not None:
            server._table = serve_asa.replicate(server._table, server._mesh)
        server._tenant_ids = tree["tenant_ids"].cpu().numpy().astype(
            np.int32)
        server._slot_of = {int(t): s
                           for s, t in enumerate(server._tenant_ids)
                           if t >= 0}
        occupied = set(server._slot_of.values())
        server._free = deque(s for s in range(cfg.n_slots)
                             if s not in occupied)
        # the dirty mask and admissions salt come back exactly, so a
        # post-restart admission resets (or not) with the very key the
        # uninterrupted server would have used
        dirty = tree["dirty"].cpu().numpy()
        server._dirty = {s for s in range(cfg.n_slots) if dirty[s]}
        server._admissions = int(tree["admissions"])
        server._batches = step
        server._origin = step
        if server._pool is not None:
            # leases are process state, not estimator state: every
            # restored tenant starts one fresh TTL ahead
            now = time.monotonic()
            for tenant in server._slot_of:
                server._grant_lease(tenant, now)
        server._obs.g_tenants.set(len(server._slot_of))
        server._obs.g_free_slots.set(len(server._free))
        return server

    # -------------------------------------------------------------- stats
    @property
    def stats(self) -> dict:
        """Registry view: the original keys keep their exact meaning
        (``batches`` counts this process's dispatched steps — a restored
        server resumes at its checkpoint step as before); the new keys
        surface the registry counters, including the lifetime request
        totals of evicted tenants snapshotted at evict time and the
        fault-tolerance counters (sheds, step errors, crashes,
        restarts, lease evictions)."""
        o = self._obs
        return {
            "batches": self._batches,
            "decisions": int(o.c_decisions.value),
            "tenants": self.n_tenants,
            "n_slots": self.cfg.n_slots,
            "deferred": len(self._deferred),
            "requests": int(o.c_requests.value),
            "deferrals": int(o.c_deferrals.value),
            "failed": int(o.c_failed.value),
            "table_full": int(o.c_table_full.value),
            "admissions_live": int(o.c_admissions.value),
            "evicted_tenants": int(o.c_evictions.value),
            "evicted_requests": int(o.c_evicted_requests.value),
            "shed": int(o.c_shed.value),
            "step_errors": int(o.c_step_errors.value),
            "crashes": int(o.c_crashes.value),
            "restarts": int(o.c_restarts.value),
            "lease_evictions": int(o.c_lease_evictions.value),
        }


class ServeSupervisor:
    """Crash supervision for one logical ASA server.

    Owns the server's lifecycle the way an init system would: a watch
    thread waits on the incarnation's crash signal; on crash it restores
    a fresh :class:`ASAServer` from the newest **verified** checkpoint
    (``latest_step(verified=True)`` — a torn/corrupted latest degrades
    to the previous good one) and starts it.  Nothing is replayed: the
    crash path already failed every pending future with
    :class:`ServerCrashed`, so clients resubmit, and the restored
    posteriors answer bitwise what the uninterrupted server would have
    (the crash-recovery extension of the restart contract, pinned by
    tests/test_torch_serve_loop.py).

    One :class:`ServeObs` is shared across incarnations, so counters,
    the scrape endpoint's view, and ``asa_serve_restarts_total`` all
    describe the logical service, not one loop thread.  ``submit()``
    retries across the swap window (bounded), so callers race restarts
    safely.
    """

    def __init__(self, cfg: ServeConfig, mesh=None, chaos=None,
                 max_restarts: int = 10,
                 obs: Optional[ServeObs] = None, *,
                 device: str | torch.device = DEFAULT_DEVICE):
        if _group_of(mesh) is not None:
            raise ValueError(
                "ServeSupervisor does not supervise a process group's "
                "server yet (ROADMAP Queue 1): run ASAServer on rank 0 and "
                "serve.loop.follow on the others")
        self.cfg = cfg
        self._mesh = mesh
        self._device = resolve_device(device)
        self._chaos = chaos
        self.max_restarts = max_restarts
        self.obs = obs if obs is not None else ServeObs(spans=cfg.obs_spans)
        self.restarts = 0
        self._closing = False
        self._watch: Optional[threading.Thread] = None
        self.server = ASAServer(cfg, mesh=mesh, obs=self.obs, chaos=chaos,
                                device=self._device)

    def start(self) -> None:
        self.server.start()
        self._watch = threading.Thread(target=self._watch_loop,
                                       daemon=True,
                                       name="asa-serve-supervisor")
        self._watch.start()

    def _watch_loop(self) -> None:
        while not self._closing:
            srv = self.server
            if not srv._crash_event.wait(timeout=0.05):
                continue
            if self._closing or self.restarts >= self.max_restarts:
                return
            self._restart(srv)

    def _restart(self, crashed: ASAServer) -> None:
        crashed.stop_metrics_http()
        if crashed._ckpt_handle is not None:
            try:
                crashed._ckpt_handle.result()
            except Exception:
                self.obs.c_ckpt_failures.inc()
            crashed._ckpt_handle = None
        step = None
        if self.cfg.checkpoint_dir:
            step = checkpoint.latest_step(self.cfg.checkpoint_dir,
                                          verified=True)
        if step is not None:
            fresh = ASAServer.restore(self.cfg, step=step,
                                      mesh=self._mesh, obs=self.obs,
                                      chaos=self._chaos,
                                      device=self._device)
        else:
            # nothing durable yet: restart empty (clients re-admit)
            fresh = ASAServer(self.cfg, mesh=self._mesh, obs=self.obs,
                              chaos=self._chaos, device=self._device)
        fresh.start()
        self.server = fresh
        self.restarts += 1
        self.obs.c_restarts.inc()
        self.obs.instant("restart", self.obs.now(),
                         {"restarts": self.restarts, "from_step": step})

    def submit(self, tenant: int,
               observed_wait: Optional[float] = None,
               deadline_s: Optional[float] = None) -> Future:
        """Submit against the current incarnation, riding out a restart
        swap: a :class:`ServerCrashed` race waits for the replacement
        (bounded) and retries once per incarnation."""
        deadline = time.monotonic() + 30.0
        while True:
            srv = self.server
            try:
                return srv.submit(tenant, observed_wait,
                                  deadline_s=deadline_s)
            except ServerCrashed:
                while (self.server is srv
                       and time.monotonic() < deadline
                       and not self._closing):
                    time.sleep(0.005)
                if self.server is srv:
                    raise

    def stop(self) -> None:
        """Stop the watch thread first (no restart may race the stop),
        then the current incarnation (drain-and-fail semantics)."""
        self._closing = True
        if self._watch is not None:
            self._watch.join()
            self._watch = None
        self.server.stop()

    @property
    def stats(self) -> dict:
        s = self.server.stats
        s["restarts"] = self.restarts
        return s


def _replica(cfg: ServeConfig, mesh, step: int, dev: torch.device):
    """A follower's replica of the table rank 0's server started from:
    fresh (``step`` -1), or ``cfg.checkpoint_dir``'s at ``step``, as
    ``ASAServer.restore`` reads it."""
    table = serve_asa.init_table(cfg.n_slots, cfg.m, cfg.seed, device=dev)
    if step >= 0:
        tmpl = {"table": table,
                "tenant_ids": np.full(cfg.n_slots, -1, np.int32),
                "admissions": np.int32(0),
                "dirty": np.zeros(cfg.n_slots, bool)}
        table = checkpoint.restore(tmpl, cfg.checkpoint_dir, step,
                                   device=dev)["table"]
    return serve_asa.replicate(table, mesh)


def follow(cfg: ServeConfig, mesh, *,
           device: str | torch.device = DEFAULT_DEVICE
           ) -> core_asa.ASAState:
    """A rank other than 0 of a process group's server (``mesh`` its
    ``scenarios`` mesh): hold one replica of the table, started as rank
    0's server started (its first message names a fresh table or the
    checkpoint step its ``restore`` read), and apply rank 0's messages
    (its slot resets, then this rank's block of each step) until rank 0
    stops. Returns the replica."""
    group = _group_of(mesh)
    if group is None or group.index == 0:
        raise ValueError("follow runs on a rank other than 0 of a process "
                         "group's mesh")
    dev = resolve_device(device)
    cap = cfg.batch_size
    table = None
    while True:
        msg = dist.broadcast(
            torch.empty(_message_size(cfg), dtype=torch.int32), group, 0)
        kind, n = int(msg[0]), int(msg[2])
        if table is None:
            table = _replica(cfg, mesh, int(msg[1]), dev)
            home = table[0].log_p.device
        for slot, salt in zip(msg[_HEAD:_HEAD + n].tolist(),
                              msg[_HEAD + cap:_HEAD + cap + n].tolist()):
            table = serve_asa.reset_slot(
                table, slot, serve_asa.slot_key(cfg.seed, salt))
        if kind == MSG_STOP:
            return serve_asa.first_replica(table)
        if kind == MSG_STEP:
            qp, mask = serve_asa.unpack_query(
                msg[_HEAD + 2 * cap:].reshape(4, cap).to(
                    home, non_blocking=True))
            table, _ = serve_asa.serve_step(table, qp, mask, mesh=mesh)


def estimate_lead(state: core_asa.ASAState, bins) -> torch.Tensor:
    """Convenience: the submit-lead-time a single estimator answers
    (MAP wait — what ``DecisionBatch.lead_s`` reports per tenant)."""
    return core_asa.map_wait(state, bins)

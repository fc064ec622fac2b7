"""Slotted scenario state for the batched fleet simulator (port of
``repro.xsim.state``).

A scenario is a fixed-size job table; rows move through the status
ladder INVALID → PENDING → QUEUED → RUNNING → DONE by masked writes. The
port holds a whole fleet in one batch-major ``ScenarioState``: job-table
fields are ``(B, max_jobs)``, stage fields ``(B, max_stages)``, scalars
``(B,)``, and ``est`` is the fleet's batched live ASA estimator. Dtypes
are the reference's: float32 times, cores and posteriors, int32 integer
fields, bool masks.

``empty_table``, ``add_job`` and ``freeze`` build one scenario from a
host-side (numpy) job table, as the reference's do, returning a batch of
one; ``concat`` joins such batches field by field into one fleet (where
the reference ``vmap``s over stacked scenarios).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import asa, prng
from repro_torch.core.bins import M_DEFAULT
from repro_torch.device import DEFAULT_DEVICE, check_device, resolve_device
from repro_torch.obs import trace as obs_trace
from repro_torch.runtime.fault import FaultSchedule

# --- job status ladder -----------------------------------------------------
INVALID = 0   # empty slot (padding)
PENDING = 1   # exists but not yet submitted (submit time possibly unknown)
QUEUED = 2    # submitted, waiting in the FCFS queue
RUNNING = 3
DONE = 4
CANCELLED = 5  # ASA-Naive early allocation, cancelled at start (§4.5)

# --- scenario policy ids ---------------------------------------------------
BIGJOB = 0
PER_STAGE = 1
ASA = 2
ASA_NAIVE = 3
RL = 4         # learned submission-policy head, naive-world rows
PILOT = 5      # pilot job: one peak-cores allocation, stages cycled inside

POLICY_NAMES = ("bigjob", "per_stage", "asa", "asa_naive", "rl", "pilot")

M_BINS = M_DEFAULT  # paper §4.3 wait-time alternatives (m = 53)

# Observation width of the learned policy head (rl_obs buffer width).
RL_FEATURES = 12


class ScenarioState(NamedTuple):
    """A batch of scenarios' full simulation state (tensors, batch-major).

    Field meanings are the reference's, one leading ``B`` axis added.
    """

    # job table (B, max_jobs) ------------------------------------------------
    submit: torch.Tensor      # f32 submission time; +inf = unreleased
    cores: torch.Tensor       # f32
    duration: torch.Tensor    # f32
    start: torch.Tensor       # f32 +inf until started
    end: torch.Tensor         # f32 +inf until start (then start+dur)
    status: torch.Tensor      # i32
    start_dep: torch.Tensor   # i32 row idx of afterok dep, -1 none
    wf_next: torch.Tensor     # i32 successor stage row, -1 none
    is_wf: torch.Tensor       # bool workflow (not background) job
    pred_wait: torch.Tensor   # f32 ASA's live-sampled estimate a_y
    expected_end: torch.Tensor  # f32 ASA chain E[end_y]; -inf unset
    # workflow chain (B, max_stages) ----------------------------------------
    wf_rows: torch.Tensor     # i32 stage y -> row idx, -1 none
    hold: torch.Tensor        # f32 naive idle-hold before stage y
    canc_start: torch.Tensor  # f32 stage y's cancelled attempt's start
    start_pending: torch.Tensor  # bool stage start-hook not yet processed
    chain_pending: torch.Tensor  # bool stage chain-hook not yet processed
    # learned-policy trajectory ---------------------------------------------
    rl_obs: torch.Tensor      # f32 (B, max_stages, RL_FEATURES)
    rl_act: torch.Tensor      # i32 (B, max_stages) chosen bin; -1 none
    # live estimator ---------------------------------------------------------
    est: asa.ASAState         # batched Algorithm-1 state (learns in-run)
    # scalars (B,) -----------------------------------------------------------
    t: torch.Tensor           # f32 current simulation time
    free: torch.Tensor        # f32 free cores
    total: torch.Tensor       # f32 machine size
    policy: torch.Tensor      # i32 policy id
    t0: torch.Tensor          # f32 workflow submission epoch
    busy_cs: torch.Tensor     # f32 ∫ used_cores dt
    min_free: torch.Tensor    # f32 min free cores ever seen
    oh_cs: torch.Tensor       # f32 naive over-allocation core-seconds
    misses: torch.Tensor      # i32 naive early-start count
    repass: torch.Tensor      # bool force an extra same-time step next
    pred_greedy: torch.Tensor  # bool MAP vs line-4 sampled a_y
    steps: torch.Tensor       # i32 event steps executed (drained no-ops
    #   don't count)
    # capacity faults (B, n_faults) -------------------------------------------
    fault_t: torch.Tensor     # f32 event times, sorted; +inf pad
    fault_c: torch.Tensor     # f32 capacity delta in cores
    fault_k: torch.Tensor     # i32 FAULT_FAIL / DRAIN / GROW
    fault_next: torch.Tensor  # i32 (B,) next unprocessed fault index
    cap_debt: torch.Tensor    # f32 (B,) draining cores still owed
    restarts: torch.Tensor    # i32 (B,) jobs killed and requeued
    restart_cs: torch.Tensor  # f32 (B,) lost core-seconds of kills
    pilot_waste_cs: torch.Tensor  # f32 (B,) pilot over-allocation
    # observability ------------------------------------------------------------
    trace: obs_trace.TraceBuffer | None = None  # event rings; None = untraced


def empty_table(max_jobs: int) -> dict[str, np.ndarray]:
    """A host-side (numpy) job table of INVALID rows, ready to fill."""
    return {
        "submit": np.full(max_jobs, np.inf, np.float32),
        "cores": np.zeros(max_jobs, np.float32),
        "duration": np.zeros(max_jobs, np.float32),
        "start": np.full(max_jobs, np.inf, np.float32),
        "end": np.full(max_jobs, np.inf, np.float32),
        "status": np.full(max_jobs, INVALID, np.int32),
        "start_dep": np.full(max_jobs, -1, np.int32),
        "wf_next": np.full(max_jobs, -1, np.int32),
        "is_wf": np.zeros(max_jobs, bool),
        "pred_wait": np.zeros(max_jobs, np.float32),
        "expected_end": np.full(max_jobs, -np.inf, np.float32),
    }


def add_job(table: dict[str, np.ndarray], row: int, *, cores: float,
            duration: float, submit: float = np.inf, status: int = PENDING,
            start: float = np.inf, end: float = np.inf, start_dep: int = -1,
            wf_next: int = -1, is_wf: bool = False,
            pred_wait: float = 0.0) -> None:
    """Fill one host-side table row (scenario construction helper)."""
    table["submit"][row] = submit
    table["cores"][row] = cores
    table["duration"][row] = duration
    table["start"][row] = start
    table["end"][row] = end
    table["status"][row] = status
    table["start_dep"][row] = start_dep
    table["wf_next"][row] = wf_next
    table["is_wf"][row] = is_wf
    table["pred_wait"][row] = pred_wait


def freeze(table: dict[str, np.ndarray], *, total_cores: float,
           free_cores: float, now: float = 0.0, policy: int = BIGJOB,
           t0: float = 0.0, max_stages: int = 9,
           est: asa.ASAState | None = None,
           est_seed: int = 0, pred_mode: str = "sample",
           trace_capacity: int = 0, fault_sched: FaultSchedule | None = None,
           n_faults: int | None = None, pilot_waste_cs: float = 0.0,
           device: str | torch.device = DEFAULT_DEVICE) -> ScenarioState:
    """A batch of one scenario on ``device`` from a host-side table and
    scalars (the reference's ``freeze`` with a leading axis of 1).

    ``wf_rows`` (the stage chain) is derived from ``is_wf`` row order.
    ``est`` seeds the live estimator (an unbatched state gets its batch
    axis; the default is a fresh uniform state keyed by ``est_seed``).
    ``pred_mode="sample"`` draws cascade estimates by Algorithm 1's line
    4, as the event-driven runner does; ``"greedy"`` takes the live MAP.
    ``fault_sched`` (a ``runtime.fault.FaultSchedule``) attaches capacity
    faults, padded to ``n_faults`` slots (default: its length); run the
    batch with ``faults=True``. ``pilot_waste_cs`` is the pilot policy's
    over-allocation (``sched.strategies.pilot_waste_cs``). ASA-Naive
    rows need ``simulate(..., naive=True)``. ``trace_capacity > 0``
    attaches an ``obs.trace`` event ring of that many slots; 0 (default)
    leaves ``trace=None``, the untraced program."""
    if pred_mode not in ("sample", "greedy"):
        raise ValueError(f"unknown pred_mode {pred_mode!r}")
    if trace_capacity < 0:
        raise ValueError(
            f"trace_capacity must be >= 0, got {trace_capacity}")
    dev = resolve_device(device)
    if fault_sched is None:
        fault_sched = FaultSchedule()
    if n_faults is None:
        n_faults = len(fault_sched)
    ft, fc, fk = fault_sched.as_arrays(n_faults, total_cores)
    wf_idx = np.nonzero(table["is_wf"])[0]
    if len(wf_idx) > max_stages:
        raise ValueError(f"{len(wf_idx)} workflow rows > max_stages")
    wf_rows = np.full(max_stages, -1, np.int32)
    wf_rows[:len(wf_idx)] = wf_idx
    if est is None:
        est = asa.init(M_BINS, prng.PRNGKey(est_seed, dev))
    check_device(est.log_p, dev, "est")
    if est.log_p.dim() == 1:
        est = asa.ASAState(*(x.unsqueeze(0) for x in est))

    def row(a) -> torch.Tensor:   # one numpy array or scalar as a (1, ...)
        return torch.as_tensor(np.asarray(a)[None].copy(), device=dev)

    f32, i32 = np.float32, np.int32
    return ScenarioState(
        **{k: row(v) for k, v in table.items()},
        wf_rows=row(wf_rows),
        hold=row(np.zeros(max_stages, f32)),
        canc_start=row(np.full(max_stages, np.inf, f32)),
        start_pending=row(np.zeros(max_stages, bool)),
        chain_pending=row(np.zeros(max_stages, bool)),
        rl_obs=row(np.zeros((max_stages, RL_FEATURES), f32)),
        rl_act=row(np.full(max_stages, -1, i32)),
        est=est,
        t=row(f32(now)),
        free=row(f32(free_cores)),
        total=row(f32(total_cores)),
        policy=row(i32(policy)),
        t0=row(f32(t0)),
        busy_cs=row(f32(0.0)),
        min_free=row(f32(free_cores)),
        oh_cs=row(f32(0.0)),
        misses=row(i32(0)),
        repass=row(False),
        pred_greedy=row(pred_mode == "greedy"),
        steps=row(i32(0)),
        fault_t=row(ft),
        fault_c=row(fc),
        fault_k=row(fk),
        fault_next=row(i32(0)),
        cap_debt=row(f32(0.0)),
        restarts=row(i32(0)),
        restart_cs=row(f32(0.0)),
        pilot_waste_cs=row(f32(pilot_waste_cs)),
        trace=(obs_trace.init(trace_capacity, 1, device=dev)
               if trace_capacity else None),
    )


def concat(states: list[ScenarioState]) -> ScenarioState:
    """One batch of the given batches, field by field along the batch
    axis (they must share ``max_jobs``, ``max_stages``, fault slots,
    device and, when traced, ring capacity). Either every batch carries an
    event ring or none does."""
    traced = {s.trace is not None for s in states}
    if len(traced) > 1:
        raise ValueError("concat: some batches carry an event ring and "
                         "some do not")

    def join(parts):   # a NamedTuple of tensors, field by field
        return type(parts[0])(*(torch.cat(x, dim=0) for x in zip(*parts)))

    return ScenarioState(**{
        f: (join([getattr(s, f) for s in states])
            if f in ("est", "trace") else
            torch.cat([getattr(s, f) for s in states], dim=0))
        for f in ScenarioState._fields if f != "trace" or traced == {True}
    })

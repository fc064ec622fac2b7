"""Slotted scenario state for the batched fleet simulator (port of
``repro.xsim.state``).

A scenario is a fixed-size job table; rows move through the status
ladder INVALID → PENDING → QUEUED → RUNNING → DONE by masked writes. The
port holds a whole fleet in one batch-major ``ScenarioState``: job-table
fields are ``(B, max_jobs)``, stage fields ``(B, max_stages)``, scalars
``(B,)``, and ``est`` is the fleet's batched live ASA estimator. Dtypes
are the reference's: float32 times, cores and posteriors, int32 integer
fields, bool masks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import asa
from repro_torch.core.bins import M_DEFAULT

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
    trace: None = None        # event rings are not ported yet (always None)

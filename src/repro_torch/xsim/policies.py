"""Strategy data and the ASA estimator fleet (port of the parts of
``repro.xsim.policies`` on the fleet sweep's path).

A strategy is data: the same event engine runs every policy, which
differ only in the workflow rows of the job table (built by
``grid.build_batch``) and the per-policy hooks in ``events``. The §4.3
cross-run persistence loop is ``update_fleet``: between sweeps, each
geometry's shared estimator absorbs observed first-stage waits and seeds
the next sweep's per-scenario estimators (``scenario_estimators``).
``add_workflow`` writes one workflow's rows into a host-side table, for
scenarios snapshotted from the event-driven ``QueueSim``
(``compare.scenario_from_queue_sim``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import asa, prng
from repro_torch.core.bins import make_bins
from repro_torch.core.losses import zero_one
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.sched import strategies
from repro_torch.sched.workflows import Workflow
from repro_torch.xsim.state import ASA, BIGJOB, PENDING, PILOT, add_job


def stage_arrays(wf: Workflow, scale: int, max_stages: int
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(cores, durations, valid) padded to ``max_stages`` — grid cell data."""
    s = len(wf.stages)
    if s > max_stages:
        raise ValueError(f"{wf.name} has {s} stages > max_stages={max_stages}")
    cores = np.zeros(max_stages, np.float32)
    durs = np.zeros(max_stages, np.float32)
    valid = np.zeros(max_stages, bool)
    for y, st in enumerate(wf.stages):
        cores[y] = st.cores(scale)
        durs[y] = st.duration(scale)
        valid[y] = True
    return cores, durs, valid


def add_workflow(table: dict[str, np.ndarray], offset: int, wf: Workflow,
                 scale: int, policy: int, t0: float) -> int:
    """Write one workflow's stage rows into a host-side table from row
    ``offset``; returns the number of rows used. BigJob and pilot take
    one peak-width row (the pilot's walltime adds its bootstrap and
    per-stage dispatch latency); the stage policies one row a stage,
    chained by ``wf_next``. ASA rows carry the afterok edge, ASA-Naive
    and learned-policy rows do not. Wait estimates are drawn at run time,
    so none are written here."""
    if policy == BIGJOB:
        add_job(table, offset, cores=wf.peak_cores(scale),
                duration=wf.total_exec(scale), submit=t0, status=PENDING,
                is_wf=True)
        return 1
    if policy == PILOT:
        add_job(table, offset, cores=wf.peak_cores(scale),
                duration=strategies.pilot_duration(wf, scale), submit=t0,
                status=PENDING, is_wf=True)
        return 1
    s = len(wf.stages)
    with_dep = policy == ASA  # naive (§4.5) + RL: no dependency support
    for y, st in enumerate(wf.stages):
        add_job(
            table, offset + y,
            cores=st.cores(scale), duration=st.duration(scale),
            submit=t0 if y == 0 else np.inf, status=PENDING,
            start_dep=offset + y - 1 if y > 0 and with_dep else -1,
            wf_next=offset + y + 1 if y + 1 < s else -1,
            is_wf=True,
        )
    return s


def init_fleet(n: int, m: int = 53, seed: int = 0, *,
               device: str | torch.device = DEFAULT_DEVICE) -> asa.ASAState:
    """One Algorithm-1 estimator per job geometry, as a batched state."""
    dev = resolve_device(device)
    return asa.init_batch(m, n, prng.PRNGKey(seed, dev))


def scenario_estimators(fleet: asa.ASAState, geo_idx: torch.Tensor,
                        pred_seed: int = 1) -> asa.ASAState:
    """Slice the per-geometry fleet into per-scenario live estimators.

    Every scenario gets its geometry's state with its own PRNG key,
    folded from the geometry key with ``index + pred_seed · 100003``
    (uint32 arithmetic, wrapping as the reference's does)."""
    idx = geo_idx.to(device=fleet.log_p.device, dtype=torch.int64)
    per = asa.ASAState(*(x[idx] for x in fleet))
    n = idx.shape[0]
    data = (torch.arange(n, dtype=torch.int64, device=idx.device)
            + ((pred_seed * 100_003) & prng.M32)) & prng.M32
    return per._replace(key=prng.fold_in(per.key, data))


def update_fleet(fleet: asa.ASAState, waits: torch.Tensor,
                 valid: torch.Tensor, gamma: float = 1.0,
                 bins: torch.Tensor | None = None) -> asa.ASAState:
    """Observe true waits: ``waits``/``valid`` are (n_geometries, k); each
    geometry's estimator takes its k observations in sequence (the tuned
    §4.5 ``asa.step``), skipping invalid ones."""
    m = fleet.log_p.shape[-1]
    dev = fleet.log_p.device
    if bins is None:
        bins = torch.as_tensor(make_bins(m), dtype=torch.float32, device=dev)
    g = torch.tensor(gamma, dtype=torch.float32, device=dev)
    waits = waits.to(device=dev, dtype=torch.float32)
    valid = valid.to(device=dev, dtype=torch.bool)
    for j in range(waits.shape[1]):
        lv = zero_one(bins, torch.clamp_min(waits[:, j], 1.0))
        stepped, _ = asa.step(fleet, lv, g, policy="tuned")
        fleet = asa.select(valid[:, j], stepped, fleet)
    return fleet

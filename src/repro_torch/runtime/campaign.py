"""ASA-driven campaign scheduler (port of ``repro.runtime.campaign``): the
paper's technique applied to training campaigns on a batch-managed
accelerator fleet.

A *campaign* is a sequence of stages with different pod geometries
(data-prep → pretrain → anneal → SFT → eval, or an elastic-resize plan
inside one run). Exactly like the paper's workflow stages, each stage's
allocation must be requested from a queue whose wait ASA learns — the
pro-active request for stage y is submitted at ``E[end_{y-1}] − a_y``.

This module glues the port's ``sched.strategies.ASAEstimator`` (its
Algorithm-1 state on ``device``) to its ``sched.queue_sim`` (the
calibrated cluster substrate, on the host) and ``runtime.pool``: when a
stage's allocation arrives, the pool grows.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch.device import DEFAULT_DEVICE
from repro_torch.runtime.pool import ResourcePool
from repro_torch.sched.queue_sim import QueueSim
from repro_torch.sched.strategies import ASAEstimator


@dataclass(frozen=True)
class CampaignStage:
    name: str
    slices: int          # pod slices needed (the "job geometry")
    duration_s: float    # expected execution time
    arch: str = ""       # arch id this stage trains/serves (bookkeeping)


@dataclass
class StageOutcome:
    name: str
    slices: int
    submit_t: float
    alloc_start_t: float
    compute_start_t: float
    compute_end_t: float
    predicted_wait_s: float
    real_wait_s: float
    perceived_wait_s: float


@dataclass
class CampaignReport:
    outcomes: list[StageOutcome] = field(default_factory=list)

    @property
    def makespan_s(self) -> float:
        return (self.outcomes[-1].compute_end_t
                - self.outcomes[0].submit_t) if self.outcomes else 0.0

    @property
    def total_perceived_wait_s(self) -> float:
        return sum(o.perceived_wait_s for o in self.outcomes)

    @property
    def slice_hours(self) -> float:
        """Charged slice-hours: width × (hold time incl. perceived wait)."""
        return sum(
            o.slices * (o.compute_end_t - o.alloc_start_t)
            for o in self.outcomes) / 3600.0


class CampaignScheduler:
    """Pro-active (ASA) stage scheduling over a queue-managed fleet. A
    fresh estimator (``est=None``) keeps its state on ``device``."""

    def __init__(self, sim: QueueSim, est: Optional[ASAEstimator] = None,
                 pool: Optional[ResourcePool] = None, *,
                 device: str | torch.device = DEFAULT_DEVICE):
        self.sim = sim
        self.est = est if est is not None else ASAEstimator(device=device)
        self.pool = pool if pool is not None else ResourcePool()

    def run(self, stages: list[CampaignStage]) -> CampaignReport:
        """Pro-active CASCADE (same scheme as sched.strategies.run_asa):
        stage i+1's request is submitted at E[end_i] − a_{i+1} where E[end_i]
        chains the *predicted* waits — several stage requests can be queued
        concurrently, so deep queue waits overlap earlier stages' waits."""
        rep = CampaignReport()
        sim, est = self.sim, self.est
        n = len(stages)
        jobs: list = [None] * n
        preds = [0.0] * n

        def schedule(i: int, expected_prev_end: float, dep_id) -> None:
            a = est.predict()
            preds[i] = a
            submit_at = max(sim.now, expected_prev_end - a)

            def do():
                j = sim.submit(stages[i].slices, stages[i].duration_s,
                               depend_on=dep_id, user="campaign")
                jobs[i] = j
                expected_end = (max(sim.now + a, expected_prev_end)
                                + stages[i].duration_s)
                if i + 1 < n:
                    schedule(i + 1, expected_end, j.id)

            sim.at(submit_at, do)

        j0 = sim.submit(stages[0].slices, stages[0].duration_s,
                        user="campaign")
        jobs[0] = j0
        a0 = est.predict()
        if n > 1:
            schedule(1, j0.submit_time + a0 + stages[0].duration_s, j0.id)

        prev_compute_end = None
        for i, st in enumerate(stages):
            while jobs[i] is None or jobs[i].start_time is None:
                sim._step()
            job = jobs[i]
            self.pool.add_allocation(st.slices)
            real_wait = job.start_time - job.submit_time
            est.learn(real_wait)
            compute_start = (job.start_time if i == 0
                             else max(job.start_time, prev_compute_end))
            compute_end = compute_start + st.duration_s
            pwt = (real_wait if i == 0
                   else max(0.0, job.start_time - prev_compute_end))
            rep.outcomes.append(StageOutcome(
                name=st.name, slices=st.slices, submit_t=job.submit_time,
                alloc_start_t=job.start_time,
                compute_start_t=compute_start, compute_end_t=compute_end,
                predicted_wait_s=preds[i], real_wait_s=real_wait,
                perceived_wait_s=pwt))
            prev_compute_end = compute_end
        sim.run_until(prev_compute_end)
        return rep

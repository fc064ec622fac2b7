"""Discrete-event batch-queue simulator (Slurm-like: FCFS + EASY backfill).

This is the substrate under every Table-1/Table-2 experiment: the container
has no batch system, so the two centers are simulated (DESIGN.md §8). The
simulator supports everything the strategies need:

  * interactive submission mid-run (ASA's pro-active submissions),
  * job dependencies (``depend_on`` — Slurm ``--dependency=afterok``): the
    job accrues queue position from submission but cannot start before its
    dependency completes,
  * cancellation + resubmission (ASA-Naive miss handling),
  * timed user callbacks (``at``) and job start/end hooks,
  * a calibrated background workload of "other users" (Poisson arrivals,
    log-normal widths/durations, warm-start backlog + initially running mix).

The port's own copy of ``repro.sched.queue_sim`` (numpy and heapq only),
kept line for line: its event order decides every Table-1 and Table-2 row.

Cores are fungible (node-packing is not modelled); the paper's metrics are
all core-granular so this loses nothing for the reproduction.
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from repro_torch.sched.centers import CenterProfile


@dataclass
class Job:
    id: int
    cores: int
    duration: float
    submit_time: float
    depend_on: Optional[int] = None
    user: str = "bg"
    start_time: Optional[float] = None
    end_time: Optional[float] = None
    canceled: bool = False

    @property
    def wait_time(self) -> float:
        assert self.start_time is not None
        return self.start_time - self.submit_time


class QueueSim:
    def __init__(self, profile: CenterProfile, seed: int = 0,
                 bg_horizon: float = float("inf")):
        self.profile = profile
        self.rng = np.random.default_rng(seed)
        self.now = 0.0
        self.free_cores = profile.total_cores
        self.jobs: dict[int, Job] = {}
        self.queue: list[int] = []          # FCFS order (job ids)
        self.running: list[tuple[float, int]] = []  # heap (end_time, id)
        self._events: list[tuple[float, int, str, object]] = []
        self._seq = itertools.count()
        self._ids = itertools.count(1)
        self._start_hooks: dict[int, list[Callable[[Job], None]]] = {}
        self._end_hooks: dict[int, list[Callable[[Job], None]]] = {}
        self.finished: set[int] = set()
        self._bg_horizon = bg_horizon
        self._warm_start()
        self._push(self._next_bg_gap(), "bg_arrival", None)

    # ------------------------------------------------------------- events
    def _push(self, t: float, kind: str, payload) -> None:
        heapq.heappush(self._events, (t, next(self._seq), kind, payload))

    def at(self, t: float, fn: Callable[[], None]) -> None:
        """Schedule a user callback at absolute sim-time t."""
        self._push(max(t, self.now), "user", fn)

    def on_start(self, job: Job, fn: Callable[[Job], None]) -> None:
        if job.start_time is not None:  # already started: fire immediately
            fn(job)
            return
        self._start_hooks.setdefault(job.id, []).append(fn)

    def on_end(self, job: Job, fn: Callable[[Job], None]) -> None:
        if job.id in self.finished:  # already done: fire immediately
            fn(job)
            return
        self._end_hooks.setdefault(job.id, []).append(fn)

    # ------------------------------------------------------- background
    def _next_bg_gap(self) -> float:
        return self.now + self.rng.exponential(1.0 / self.profile.bg_arrival_rate)

    def _bg_job_shape(self) -> tuple[int, float]:
        p = self.profile
        cores = int(np.clip(np.exp(self.rng.normal(p.bg_cores_mean, p.bg_cores_sigma)),
                            1, p.total_cores // 2))
        dur = float(np.clip(np.exp(self.rng.normal(p.bg_duration_mean_s,
                                                   p.bg_duration_sigma)),
                            30.0, 7 * 86400.0))
        return cores, dur

    def _warm_start(self) -> None:
        """Fill the machine with running jobs and pre-queue a backlog."""
        p = self.profile
        used = 0
        while used < int(p.total_cores * 0.97):
            cores, dur = self._bg_job_shape()
            cores = min(cores, p.total_cores - used)
            j = Job(next(self._ids), cores, dur, submit_time=0.0)
            # residual duration: job started some time ago
            j.start_time = 0.0
            j.end_time = self.rng.uniform(0.05, 1.0) * dur
            self.jobs[j.id] = j
            heapq.heappush(self.running, (j.end_time, j.id))
            self._push(j.end_time, "job_end", j.id)
            used += cores
        self.free_cores = p.total_cores - used
        for _ in range(p.bg_initial_backlog):
            cores, dur = self._bg_job_shape()
            j = Job(next(self._ids), cores, dur, submit_time=0.0)
            self.jobs[j.id] = j
            self.queue.append(j.id)

    # ------------------------------------------------------------ submit
    def submit(self, cores: int, duration: float,
               depend_on: Optional[int] = None, user: str = "me") -> Job:
        if cores > self.profile.total_cores:
            raise ValueError(
                f"job wants {cores} cores > machine {self.profile.total_cores}")
        j = Job(next(self._ids), cores, float(duration), self.now,
                depend_on=depend_on, user=user)
        self.jobs[j.id] = j
        self.queue.append(j.id)
        self._schedule_pass()
        return j

    def cancel(self, job: Job) -> None:
        job.canceled = True
        if job.id in self.queue:
            self.queue.remove(job.id)
        elif job.start_time is not None and job.id not in self.finished:
            # running: free its cores immediately
            self.free_cores += job.cores
            self.running = [(t, i) for t, i in self.running if i != job.id]
            heapq.heapify(self.running)
            job.end_time = self.now
            self._schedule_pass()

    # --------------------------------------------------------- scheduler
    def _eligible(self, j: Job) -> bool:
        if j.canceled or j.start_time is not None:
            return False
        if j.depend_on is not None:
            dep = self.jobs[j.depend_on]
            if dep.end_time is None or dep.end_time > self.now:
                return False
        return True

    def _start(self, j: Job) -> None:
        j.start_time = self.now
        j.end_time = self.now + j.duration
        self.free_cores -= j.cores
        heapq.heappush(self.running, (j.end_time, j.id))
        self.queue.remove(j.id)
        self._push(j.end_time, "job_end", j.id)
        for fn in self._start_hooks.pop(j.id, []):
            fn(j)

    def _schedule_pass(self) -> None:
        """FCFS + EASY backfill over the eligible queue."""
        # 1. start jobs from the front while they fit
        while True:
            head = None
            for jid in self.queue:
                j = self.jobs[jid]
                if self._eligible(j):
                    head = j
                    break
            if head is None:
                return
            if head.cores <= self.free_cores:
                self._start(head)
                continue
            break
        # 2. EASY backfill: reservation for `head`, fill around it.
        # Like Slurm's bf_max_job_test, only the first BF_MAX queued jobs
        # are considered — keeps each pass O(BF_MAX) on deep queues.
        BF_MAX = 96
        shadow_time, extra = self._reservation(head)
        for jid in list(self.queue[:BF_MAX]):
            # start hooks may cancel/submit re-entrantly (ASA-Naive
            # resubmission): re-check membership against the LIVE queue
            if jid not in self.queue:
                continue
            j = self.jobs[jid]
            if j is head or j.start_time is not None or not self._eligible(j):
                continue
            if j.cores > self.free_cores:
                continue
            fits_before_shadow = self.now + j.duration <= shadow_time
            fits_in_extra = j.cores <= extra
            if fits_before_shadow or fits_in_extra:
                self._start(j)
                if fits_in_extra:
                    extra -= j.cores

    def _reservation(self, head: Job) -> tuple[float, int]:
        """When can `head` start, and how many cores are spare at that time."""
        free = self.free_cores
        ends = sorted(self.running)
        for end_t, jid in ends:
            if jid in self.finished or self.jobs[jid].canceled:
                continue
            free += self.jobs[jid].cores
            if free >= head.cores:
                return end_t, free - head.cores
        return float("inf"), 0

    # ------------------------------------------------------------- loop
    def run_until(self, t: float) -> None:
        while self._events and self._events[0][0] <= t:
            self._step()
        self.now = max(self.now, t)

    def run_until_job_starts(self, job: Job,
                             hard_limit: float = 90 * 86400.0) -> None:
        while job.start_time is None and not job.canceled:
            if not self._events or self.now > hard_limit:
                raise RuntimeError(f"job {job.id} never started (sim starved)")
            self._step()

    def run_until_job_ends(self, job: Job, hard_limit: float = 90 * 86400.0) -> None:
        while job.id not in self.finished and not job.canceled:
            if not self._events or self.now > hard_limit:
                raise RuntimeError(f"job {job.id} never finished (sim starved)")
            self._step()

    def _step(self) -> None:
        t, _, kind, payload = heapq.heappop(self._events)
        self.now = max(self.now, t)
        if kind == "job_end":
            j = self.jobs[payload]
            if j.canceled:
                return
            self.finished.add(j.id)
            self.free_cores += j.cores
            # lazy cleanup of the running heap (ended jobs leave the top)
            while self.running and self.running[0][1] in self.finished:
                heapq.heappop(self.running)
            for fn in self._end_hooks.pop(j.id, []):
                fn(j)
            self._schedule_pass()
        elif kind == "bg_arrival":
            if self.now < self._bg_horizon:
                burst = self.rng.geometric(1.0 / self.profile.bg_burst_mean)
                for _ in range(int(burst)):
                    cores, dur = self._bg_job_shape()
                    jb = Job(next(self._ids), cores, dur, self.now)
                    self.jobs[jb.id] = jb
                    self.queue.append(jb.id)
                self._schedule_pass()
            self._push(self._next_bg_gap(), "bg_arrival", None)
        elif kind == "user":
            payload()
            self._schedule_pass()

    # --------------------------------------------------------- queries
    def utilization(self) -> float:
        return 1.0 - self.free_cores / self.profile.total_cores

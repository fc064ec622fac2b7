"""The three submission strategies of §2.2/§4.1 + ASA-Naive (§4.5), on the
port's Algorithm-1 core (port of ``repro.sched.strategies``).

Each strategy drives a QueueSim interactively and returns RunMetrics. ASA
carries a (shared, cross-run) estimator state per job geometry, exactly as
the paper shares Algorithm-1 state across runs (§4.3). The runners are
host logic over QueueSim, line for line the reference's; the estimator's
``predict`` and ``learn`` are the only calls that touch tensors.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import asa, prng
from repro_torch.core.bins import make_bins, nearest_bin
from repro_torch.core.losses import zero_one
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.sched.queue_sim import QueueSim
from repro_torch.sched.workflows import Workflow

# §4.5 ASA-Naive miss handling (single source of truth — xsim mirrors
# these; the cross-engine differential tests pin the shared values)
NAIVE_IDLE_THRESHOLD_S = 300.0   # idle the early allocation up to this gap
NAIVE_CANCEL_LATENCY_S = 60.0    # charged OH when cancelling instead

# Pilot-job policy (id 5): one peak-cores allocation, stages cycled inside
# it by an internal task scheduler. The pilot queues ONCE (BigJob-like
# wait) but pays for its startup and the per-stage dispatch latency of the
# internal scheduler on top of the BigJob packing waste.
PILOT_STARTUP_S = 60.0           # pilot bootstrap before the first task
PILOT_TASK_LATENCY_S = 1.0       # internal dispatch latency per stage


@dataclass
class RunMetrics:
    workflow: str
    strategy: str
    center: str
    scale: int
    twt_s: float = 0.0          # total (perceived, for ASA) waiting time
    makespan_s: float = 0.0
    core_hours: float = 0.0     # charged core-hours (incl. OH)
    oh_hours: float = 0.0       # over-allocation (idle) core-hour loss
    hits: int = 0               # stage submissions whose estimate was optimal
    misses: int = 0             # over-predictions forcing resubmission/idle
    stage_waits: list[float] = field(default_factory=list)
    pred_waits: list[float] = field(default_factory=list)
    real_waits: list[float] = field(default_factory=list)


@dataclass
class ASAEstimator:
    """One Algorithm-1 state per job geometry, persisted across runs.

    The state and the bins live on ``device`` (default ``"cuda"``; raises
    without a CUDA device unless ``device="cpu"``). ``predict`` reads one
    value back to hand QueueSim a Python float; ``learn`` reads none: its
    observed wait is written by a fill, not copied from host memory.
    ``was_hit`` compares bins on a numpy float32 copy."""

    m: int = 53
    policy: str = "tuned"
    repetitions: int = 50
    gamma: float = 1.0
    seed: int = 0
    device: str | torch.device = DEFAULT_DEVICE

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        self.bins_np = make_bins(self.m).astype(np.float32)
        self.bins = torch.as_tensor(self.bins_np, device=self.device)
        self.state = asa.init(self.m, prng.PRNGKey(self.seed, self.device))

    def _fill(self, x: float) -> torch.Tensor:
        return torch.full((), x, dtype=torch.float32, device=self.device)

    def predict(self) -> float:
        """Sample a waiting-time estimate according to the current policy."""
        if self.policy == "greedy":
            a = asa.greedy_action(self.state)
        else:
            self.state, a = asa.sample_action(self.state)
        return float(self.bins_np[int(a)])

    def learn(self, true_wait_s: float) -> None:
        lv = zero_one(self.bins, self._fill(max(true_wait_s, 1.0)))
        self.state, _ = asa.step(
            self.state, lv, self._fill(self.gamma), policy=self.policy,
            repetitions=self.repetitions)

    def was_hit(self, predicted_s: float, true_wait_s: float) -> bool:
        b = self.bins_np
        return bool(
            nearest_bin(b, predicted_s) == nearest_bin(b, max(true_wait_s, 1.0)))


def run_bigjob(sim: QueueSim, wf: Workflow, scale: int,
               center: str) -> RunMetrics:
    m = RunMetrics(wf.name, "bigjob", center, scale)
    t_total = wf.total_exec(scale)
    submit_t = sim.now
    job = sim.submit(wf.peak_cores(scale), t_total, user="wf")
    sim.run_until_job_ends(job)
    m.twt_s = job.wait_time
    m.stage_waits = [job.wait_time]
    m.makespan_s = job.end_time - submit_t
    m.core_hours = wf.bigjob_core_seconds(scale) / 3600.0
    return m


def pilot_duration(wf: Workflow, scale: int) -> float:
    """Walltime of the pilot allocation: the serialized stage work plus
    the pilot's bootstrap and per-stage internal dispatch latency."""
    return (wf.total_exec(scale) + PILOT_STARTUP_S
            + len(wf.stages) * PILOT_TASK_LATENCY_S)


def pilot_waste_cs(wf: Workflow, scale: int) -> float:
    """Over-allocation core-seconds of the pilot: everything the
    peak-cores allocation charges beyond the stages' useful work
    (BigJob-style packing waste + startup + dispatch latency)."""
    return (wf.peak_cores(scale) * pilot_duration(wf, scale)
            - wf.core_seconds(scale))


def run_pilot(sim: QueueSim, wf: Workflow, scale: int,
              center: str) -> RunMetrics:
    """Pilot-job policy: queue one peak-cores allocation, cycle every
    stage inside it. One queue wait, BigJob's packing waste plus the
    pilot overheads on core-hours."""
    m = RunMetrics(wf.name, "pilot", center, scale)
    dur = pilot_duration(wf, scale)
    submit_t = sim.now
    job = sim.submit(wf.peak_cores(scale), dur, user="wf")
    sim.run_until_job_ends(job)
    m.twt_s = job.wait_time
    m.stage_waits = [job.wait_time]
    m.makespan_s = job.end_time - submit_t
    m.core_hours = wf.peak_cores(scale) * dur / 3600.0
    m.oh_hours = pilot_waste_cs(wf, scale) / 3600.0
    return m


def run_per_stage(sim: QueueSim, wf: Workflow, scale: int,
                  center: str) -> RunMetrics:
    m = RunMetrics(wf.name, "per_stage", center, scale)
    submit_t = sim.now
    end_prev = None
    for st in wf.stages:
        job = sim.submit(st.cores(scale), st.duration(scale), user="wf")
        sim.run_until_job_ends(job)
        m.stage_waits.append(job.wait_time)
        m.twt_s += job.wait_time
        end_prev = job.end_time
    m.makespan_s = end_prev - submit_t
    m.core_hours = wf.core_seconds(scale) / 3600.0
    return m


def run_asa(
    sim: QueueSim,
    wf: Workflow,
    scale: int,
    center: str,
    est: ASAEstimator,
    *,
    use_dependencies: bool = True,
    naive_idle_threshold_s: float = NAIVE_IDLE_THRESHOLD_S,
    naive_cancel_latency_s: float = NAIVE_CANCEL_LATENCY_S,
) -> RunMetrics:
    """ASA pro-active submission (§3.2, Fig. 4).

    Submissions cascade on expected end-dates: stage y's job is submitted
    at ``E[end_{y-1}] − a_y``, where ``E[end_{y-1}]`` chains the estimated
    wait of stage y−1 (sampled at its own submission) plus its execution
    time and ``a_y`` is ASA's sampled wait estimate for stage y.

    With ``use_dependencies`` (default ASA) each job carries a Slurm-style
    afterok dependency on its predecessor: over-predictions cost nothing
    (OH = 0) and PWT_y = start_y − end_{y-1}.

    ASA-Naive (no dependency support, §4.5): an allocation granted before
    stage y−1 finishes either idles (short gaps, charged as OH
    core-hours) or is cancelled and re-submitted once the predecessor
    actually ends (long gaps), incurring an extra perceived wait.
    """
    name = "asa" if use_dependencies else "asa_naive"
    m = RunMetrics(wf.name, name, center, scale)
    t0 = sim.now
    s = len(wf.stages)
    jobs: list = [None] * s          # final (possibly re-submitted) job per stage
    final: list = [False] * s        # stage job settled (started its compute)
    hold_s = [0.0] * s               # idle hold before compute (naive)

    def duration(y: int) -> float:
        return wf.stages[y].duration(scale)

    def cores(y: int) -> int:
        return wf.stages[y].cores(scale)

    def on_started(y: int):
        """Learning + naive early-start handling, at the job's start event."""
        def hook(j):
            prev = jobs[y - 1] if y > 0 else None
            prev_running_end = (
                None if prev is None or prev.start_time is None
                else prev.start_time + hold_s[y - 1] + duration(y - 1))
            early = (None if y == 0 else
                     (float("inf") if prev_running_end is None
                      else prev_running_end - sim.now))
            if (not use_dependencies and early is not None and early > 0):
                m.misses += 1
                if early <= naive_idle_threshold_s:
                    hold_s[y] = early
                    m.oh_hours += j.cores * early / 3600.0
                    final[y] = True
                    est.learn(j.wait_time)
                else:
                    # cancel now; re-submit when the predecessor really ends
                    m.oh_hours += j.cores * naive_cancel_latency_s / 3600.0
                    sim.cancel(j)

                    def resubmit(pj):
                        nj = sim.submit(cores(y), duration(y), user="wf")
                        jobs[y] = nj
                        sim.on_start(nj, on_started(y))

                    if prev is not None and prev.id in sim.finished:
                        resubmit(prev)
                    elif prev is not None:
                        sim.on_end(prev, resubmit)
                return
            final[y] = True
            est.learn(j.wait_time)
        return hook

    def schedule_stage(y: int, expected_prev_end: float, dep_id) -> None:
        a = est.predict()
        m.pred_waits.append(a)
        submit_at = max(sim.now, expected_prev_end - a)

        def do_submit():
            dep = dep_id if use_dependencies else None
            j = sim.submit(cores(y), duration(y), depend_on=dep, user="wf")
            jobs[y] = j
            sim.on_start(j, on_started(y))
            expected_end = max(sim.now + a, expected_prev_end) + duration(y)
            if y + 1 < s:
                schedule_stage(y + 1, expected_end, j.id)

        sim.at(submit_at, do_submit)

    # stage 0: plain submission, no overlap possible
    j0 = sim.submit(cores(0), duration(0), user="wf")
    jobs[0] = j0
    sim.on_start(j0, on_started(0))
    a0 = est.predict()  # expected wait for the bookkeeping chain
    if s > 1:
        schedule_stage(1, t0 + a0 + duration(0), j0.id)

    # drive the sim until every stage's (final) job has finished
    for y in range(s):
        while jobs[y] is None or not final[y]:
            sim._step()
        sim.run_until_job_ends(jobs[y])

    # ---- metrics from the settled timeline
    logical_end = None
    for y in range(s):
        j = jobs[y]
        start = j.start_time + hold_s[y]
        pwt = j.wait_time if y == 0 else max(0.0, j.start_time - logical_end)
        m.stage_waits.append(pwt)
        m.twt_s += pwt
        m.real_waits.append(j.wait_time)
        if y > 0 and est.was_hit(m.pred_waits[y - 1], j.wait_time):
            m.hits += 1
        logical_end = (start if y == 0 else max(start, logical_end)) + duration(y)
    sim.run_until(logical_end)
    m.makespan_s = logical_end - t0
    m.core_hours = wf.core_seconds(scale) / 3600.0 + m.oh_hours
    return m

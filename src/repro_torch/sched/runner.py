"""Experiment runners reproducing the paper's evaluation (§4), on the
port's Algorithm-1 core (port of ``repro.sched.runner``).

``run_table1``  — 54 runs: {Montage, BLAST, Statistics} × {BigJob, Per-Stage,
                  ASA} × 6 core scalings (28/56/112 @HPC2n, 160/320/640
                  @UPPMAX), plus the ASA-Naive sensitivity runs (§4.5).
``run_table2``  — prediction-accuracy: each job geometry submitted 60× with
                  1-minute gaps; real WT vs ASA WT vs perceived WT, hit/miss
                  ratios, OH losses.

ASA estimator state is shared across runs per (center, scale) job geometry,
exactly as §4.3 prescribes ("Algorithm 1's state is kept across different
runs").

The runners are the reference's, line for line; ``device=`` (default
``"cuda"``) places every ``ASAEstimator`` they make. The estimators' seeds
are ``hash()`` of a tuple of a center name and ints, as in the reference:
Python randomises ``str`` hashes per process unless ``PYTHONHASHSEED`` is
set, so two processes give different rows, and the two packages are
compared within one process.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.sched.centers import CENTERS, CenterProfile
from repro_torch.sched.queue_sim import QueueSim
from repro_torch.sched.strategies import (
    ASAEstimator,
    RunMetrics,
    run_asa,
    run_bigjob,
    run_per_stage,
    run_pilot,
)
from repro_torch.sched.workflows import WORKFLOWS

WARMUP_S = 7200.0


def _fresh_sim(center: CenterProfile, seed: int) -> QueueSim:
    sim = QueueSim(center, seed=seed)
    sim.run_until(WARMUP_S)
    return sim


@dataclass
class Table1Result:
    runs: list[RunMetrics] = field(default_factory=list)

    def rows(self):
        return [
            dict(workflow=r.workflow, strategy=r.strategy, center=r.center,
                 scale=r.scale, twt_s=round(r.twt_s, 1),
                 makespan_s=round(r.makespan_s, 1),
                 core_hours=round(r.core_hours, 2),
                 oh_hours=round(r.oh_hours, 2))
            for r in self.runs
        ]


def run_table1(seed: int = 0, include_naive: bool = True,
               workflows: tuple[str, ...] = ("montage", "blast", "statistics"),
               n_warmup: int = 20,
               include_pilot: bool = False,
               device: str | torch.device = DEFAULT_DEVICE) -> Table1Result:
    dev = resolve_device(device)
    out = Table1Result()
    estimators: dict[tuple[str, int], ASAEstimator] = {}
    for center in CENTERS.values():
        for scale in center.scales:
            est = estimators.setdefault(
                (center.name, scale),
                ASAEstimator(seed=hash((center.name, scale)) % (2**31),
                             device=dev))
            # §4.3: Algorithm-1 state is kept across runs — enter the
            # measured runs warm, like the paper's estimators do
            wsim = _fresh_sim(center, seed + 17)
            for _ in range(n_warmup):
                j = wsim.submit(scale, 120.0, user="warm")
                wsim.run_until(wsim.now + 60.0)
                wsim.run_until_job_starts(j)
                est.learn(j.wait_time)
            for strategy in ("bigjob", "per_stage", "asa") + (
                    ("asa_naive",) if include_naive else ()) + (
                    ("pilot",) if include_pilot else ()):
                # identical background (same seed) for a fair comparison
                sim = _fresh_sim(center, seed)
                for wf_name in workflows:
                    wf = WORKFLOWS[wf_name]
                    if strategy == "bigjob":
                        m = run_bigjob(sim, wf, scale, center.name)
                    elif strategy == "per_stage":
                        m = run_per_stage(sim, wf, scale, center.name)
                    elif strategy == "pilot":
                        m = run_pilot(sim, wf, scale, center.name)
                    elif strategy == "asa":
                        m = run_asa(sim, wf, scale, center.name, est,
                                    use_dependencies=True)
                    else:
                        m = run_asa(sim, wf, scale, center.name, est,
                                    use_dependencies=False)
                    out.runs.append(m)
    return out


@dataclass
class Table2Row:
    workflow: str
    center: str
    scale: int
    real_wt_h: float
    real_wt_std_h: float
    asa_wt_h: float
    asa_wt_std_h: float
    pwt_h: float
    pwt_std_h: float
    hit_ratio: float
    miss_ratio: float
    oh_loss_h: float


def run_table2(seed: int = 0, n_submissions: int = 60,
               gap_s: float = 60.0, probe_duration_s: float = 120.0,
               n_warmup: int = 20, resub_threshold_s: float = 300.0,
               device: str | torch.device = DEFAULT_DEVICE,
               ) -> list[Table2Row]:
    dev = resolve_device(device)
    rows: list[Table2Row] = []
    for center in CENTERS.values():
        for scale in center.scales:
            for wf_name, wf in WORKFLOWS.items():
                est = ASAEstimator(
                    seed=hash((center.name, scale, wf_name)) % (2**31),
                    device=dev)
                sim = _fresh_sim(center, seed + scale)
                # the paper keeps Algorithm-1 state across ALL prior runs
                # (§4.3); warm the estimator the same way before measuring
                for _ in range(n_warmup):
                    j = sim.submit(wf.peak_cores(scale), probe_duration_s,
                                   user="warm")
                    sim.run_until(sim.now + gap_s)
                    sim.run_until_job_starts(j)
                    est.learn(j.wait_time)
                real, pred, pwt = [], [], []
                hits = misses = 0
                oh_h = 0.0
                for k in range(n_submissions):
                    a = est.predict()
                    job = sim.submit(wf.peak_cores(scale), probe_duration_s,
                                     user="probe")
                    sim.run_until(sim.now + gap_s)
                    sim.run_until_job_ends(job)
                    w = job.wait_time
                    real.append(w)
                    pred.append(a)
                    # perceived wait: the fraction of the queue wait NOT
                    # hidden by the pro-active overlap window `a`
                    pwt.append(max(0.0, w - a))
                    if est.was_hit(a, w):
                        hits += 1
                    if a - w > resub_threshold_s:
                        # over-prediction big enough that the allocation
                        # would arrive early and need a re-submission
                        # (paper's miss; threshold = the strategies' naive
                        # idle threshold)
                        misses += 1
                        oh_h += wf.peak_cores(scale) * min(a - w, 3600.0) / 3600.0
                    est.learn(w)
                h = 3600.0
                rows.append(Table2Row(
                    workflow=wf_name, center=center.name, scale=scale,
                    real_wt_h=float(np.mean(real)) / h,
                    real_wt_std_h=float(np.std(real)) / h,
                    asa_wt_h=float(np.mean(pred)) / h,
                    asa_wt_std_h=float(np.std(pred)) / h,
                    pwt_h=float(np.mean(pwt)) / h,
                    pwt_std_h=float(np.std(pwt)) / h,
                    hit_ratio=hits / n_submissions,
                    miss_ratio=misses / n_submissions,
                    oh_loss_h=oh_h / n_submissions,
                ))
    return rows


def summarize_table1(res: Table1Result) -> dict[str, dict[str, float]]:
    """Normalized averages per strategy (paper's 'Normalized Average' rows):
    each metric normalized to the best strategy for that (workflow, scale)."""
    strategies = sorted({r.strategy for r in res.runs})
    keys = sorted({(r.workflow, r.center, r.scale) for r in res.runs})
    agg = {s: {"twt": [], "makespan": [], "ch": []} for s in strategies}
    for key in keys:
        group = [r for r in res.runs
                 if (r.workflow, r.center, r.scale) == key]
        if not group:
            continue
        # floor the normalizers: sub-minute waits are noise, not signal
        best_twt = max(min(r.twt_s for r in group), 60.0)
        best_mk = max(min(r.makespan_s for r in group), 60.0)
        best_ch = max(min(r.core_hours for r in group), 1.0)
        for r in group:
            agg[r.strategy]["twt"].append(max(r.twt_s, 60.0) / best_twt)
            agg[r.strategy]["makespan"].append(r.makespan_s / best_mk)
            agg[r.strategy]["ch"].append(r.core_hours / best_ch)
    return {
        s: {k: float(np.mean(v)) - 1.0 for k, v in d.items()}
        for s, d in agg.items()
    }

"""Supercomputer-center profiles (paper §4.2), calibrated for simulation.

HPC2n : 602 nodes × 2×14-core Xeon E5 v4  → 16 856 cores, Slurm 18.08
UPPMAX: 486 nodes × 2×10-core Xeon E5 v4  →  9 720 cores, Slurm 19.05

The background-workload parameters are calibrated so the *simulated* queue
waits land in the ranges the paper measured (Table 2):

  HPC2n  : small/medium jobs (≤112 cores) wait 0.4–1.5 h with σ comparable
           to the mean (high fragmentation / high variability),
  UPPMAX : large jobs (160–640 cores) wait 11–17 h with small σ (busy but
           stable — long-running wide jobs dominate).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class CenterProfile:
    name: str
    nodes: int
    cores_per_node: int
    # Background (other users') load generator
    bg_arrival_rate: float      # jobs per second (Poisson)
    bg_cores_mean: float        # log-normal-ish job width
    bg_cores_sigma: float
    bg_duration_mean_s: float   # log-normal duration
    bg_duration_sigma: float
    bg_initial_backlog: int     # jobs already queued at t=0
    bg_burst_mean: float        # geometric mean jobs per arrival event
    scales: tuple[int, ...]     # paper's core scalings run at this center

    @property
    def total_cores(self) -> int:
        return self.nodes * self.cores_per_node


# Offered load = rate · E[cores] · E[duration] is kept at ≈95% of capacity
# so the queue is busy-but-stable; waits then come from the warm-start
# backlog + burstiness, matching Table 2's observed ranges.
HPC2N = CenterProfile(
    name="hpc2n",
    nodes=602,
    cores_per_node=28,
    bg_arrival_rate=1.0 / 85.0,  # ×burst 5 ⇒ ~112% offered load, bursty
    bg_cores_mean=3.4,          # e^3.4 ≈ 30 cores typical
    bg_cores_sigma=1.1,
    bg_duration_mean_s=7.6,     # e^7.6 ≈ 2000 s typical
    bg_duration_sigma=1.5,
    bg_initial_backlog=140,
    bg_burst_mean=5.0,          # array-job bursts ⇒ high wait variance
    scales=(28, 56, 112),
)

UPPMAX = CenterProfile(
    name="uppmax",
    nodes=486,
    cores_per_node=20,
    bg_arrival_rate=1.0 / 92.0,  # E[cores]≈41 · E[dur]≈2.2e4 s ⇒ ~95% load
    bg_cores_mean=3.0,
    bg_cores_sigma=1.2,
    bg_duration_mean_s=9.4,     # e^9.4 ≈ 12 100 s — long-running jobs
    bg_duration_sigma=1.1,
    bg_initial_backlog=750,
    bg_burst_mean=1.0,          # steady wide load ⇒ stable long waits
    scales=(160, 320, 640),
)

CENTERS = {c.name: c for c in (HPC2N, UPPMAX)}

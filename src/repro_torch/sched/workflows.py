"""The paper's three scientific workflows (§4.3), as stage profiles.

Stage structure follows the paper exactly; per-stage durations are
calibrated to the paper's 28-core execution times (Table 1 makespans minus
waits) with Amdahl-style scaling exponents chosen per the paper's
scalability statements:

  * Montage   — 9 stages, "not a scalable application" (α small): first two
                and fifth parallel, plus the background-apply stage; third &
                fourth and last three sequential.
  * BLAST     — 2 stages, "very scalable" (α near 1): one wide parallel
                match stage, one sequential merge.
  * Statistics— 4 stages, network-intensive (α mid): two sequential and two
                parallel stages, intertwined.

Sequential stages use SEQ_CORES cores (one resource unit in the paper's
terms; a node's worth of cores would also be defensible — metrics are
dominated by the parallel stages either way).
"""

from __future__ import annotations

from dataclasses import dataclass

SEQ_CORES = 4
BASE_CORES = 28  # durations are specified at the paper's smallest scaling


@dataclass(frozen=True)
class Stage:
    name: str
    parallel: bool
    base_t: float          # seconds at BASE_CORES (parallel) or fixed (seq)
    alpha: float = 0.0     # Amdahl exponent: t(n) = base_t * (BASE/n)^alpha

    def duration(self, n_cores: int) -> float:
        if not self.parallel:
            return self.base_t
        return self.base_t * (BASE_CORES / n_cores) ** self.alpha

    def cores(self, n_cores: int) -> int:
        return n_cores if self.parallel else SEQ_CORES


@dataclass(frozen=True)
class Workflow:
    name: str
    stages: tuple[Stage, ...]

    def total_exec(self, n: int) -> float:
        return sum(s.duration(n) for s in self.stages)

    def peak_cores(self, n: int) -> int:
        return max(s.cores(n) for s in self.stages)

    def core_seconds(self, n: int) -> float:
        """Eq. (2): Σ t_i · n_i — the Per-Stage (optimal) core usage."""
        return sum(s.duration(n) * s.cores(n) for s in self.stages)

    def bigjob_core_seconds(self, n: int) -> float:
        """Eq. (1): n · Σ t_i."""
        return self.peak_cores(n) * self.total_exec(n)


MONTAGE = Workflow(
    "montage",
    (
        Stage("mProject-a", True, 300.0, 0.25),
        Stage("mProject-b", True, 200.0, 0.25),
        Stage("mImgtbl", False, 150.0),
        Stage("mOverlaps", False, 100.0),
        Stage("mDiffFit", True, 250.0, 0.25),
        Stage("mBackground", True, 120.0, 0.25),
        Stage("mConcatFit", False, 60.0),
        Stage("mBgModel", False, 60.0),
        Stage("mAdd", False, 80.0),
    ),
)

BLAST = Workflow(
    "blast",
    (
        Stage("match", True, 2500.0, 0.80),
        Stage("merge", False, 180.0),
    ),
)

STATISTICS = Workflow(
    "statistics",
    (
        Stage("ingest", False, 300.0),
        Stage("stats-a", True, 2400.0, 0.45),
        Stage("reshard", False, 300.0),
        Stage("stats-b", True, 2400.0, 0.45),
    ),
)

WORKFLOWS = {w.name: w for w in (MONTAGE, BLAST, STATISTICS)}

"""repro_torch.xsim — the batched fleet simulator on torch tensors.

Fixed-slot job tables, one event step at a time for a whole batch of
scenarios, the EASY reservation scan as the hand-written CUDA kernel
``csrc/freed_scan.cu``. Ported: the untraced, fault-free program for the
BigJob, Per-Stage, ASA and pilot policies (ids 0, 1, 2, 5).
"""

from repro_torch.xsim.state import (ASA, ASA_NAIVE, BIGJOB, CANCELLED,
                                    PER_STAGE, PILOT, POLICY_NAMES, RL,
                                    ScenarioState)
from repro_torch.xsim.events import simulate, sweep
from repro_torch.xsim.grid import (ScenarioGrid, XSimConfig, center_params,
                                   make_grid, run_grid, warm_fleet)
from repro_torch.xsim.compare import batched_metrics, metrics

__all__ = [
    "ASA", "ASA_NAIVE", "BIGJOB", "CANCELLED", "PER_STAGE", "PILOT",
    "POLICY_NAMES", "RL", "ScenarioState", "simulate", "sweep",
    "ScenarioGrid", "XSimConfig", "center_params", "make_grid", "run_grid",
    "warm_fleet", "batched_metrics", "metrics",
]

"""repro_torch.xsim — the batched fleet simulator on torch tensors.

Fixed-slot job tables, one event step at a time for a whole batch of
scenarios, the EASY reservation scan as the hand-written CUDA kernel
``csrc/freed_scan.cu``. Ported: the program for the BigJob,
Per-Stage, ASA, ASA-Naive and pilot policies (ids 0, 1, 2, 3, 5), with
capacity faults and the robustness families (``clean``, ``faulty``,
``elastic``, ``preempt``), and the host-side helpers that snapshot the
event-driven ``sched.QueueSim`` into a scenario (``empty_table``,
``add_job``, ``freeze``, ``concat``, ``policies.add_workflow``,
``scenario_from_queue_sim``), and event tracing (``XSimConfig.with_trace``,
``freeze(trace_capacity=...)``: the ``obs.trace`` rings). Not yet: the
learned policy (id 4).
"""

from repro_torch.xsim.state import (ASA, ASA_NAIVE, BIGJOB, CANCELLED,
                                    PER_STAGE, PILOT, POLICY_NAMES, RL,
                                    ScenarioState, add_job, concat,
                                    empty_table, freeze)
from repro_torch.xsim.events import simulate, sweep
from repro_torch.xsim.grid import (ScenarioGrid, XSimConfig, center_params,
                                   make_grid, run_grid, warm_fleet)
from repro_torch.xsim.compare import (batched_metrics, metrics,
                                      queue_sim_free_cores,
                                      scenario_from_queue_sim, wf_rows)
from repro_torch.xsim.policies import add_workflow
from repro_torch.xsim.families import FAMILIES, family_grid, family_schedule

__all__ = [
    "ASA", "ASA_NAIVE", "BIGJOB", "CANCELLED", "PER_STAGE", "PILOT",
    "POLICY_NAMES", "RL", "ScenarioState", "add_job", "concat",
    "empty_table", "freeze", "simulate", "sweep",
    "ScenarioGrid", "XSimConfig", "center_params", "make_grid", "run_grid",
    "warm_fleet", "batched_metrics", "metrics", "queue_sim_free_cores",
    "scenario_from_queue_sim", "wf_rows", "add_workflow", "FAMILIES",
    "family_grid", "family_schedule",
]

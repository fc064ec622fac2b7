"""repro_torch.sched — the batch-queue substrate on the port's core:
the event-driven simulator (own copy of the reference's ``QueueSim``),
the center and workflow profiles, the submission strategies (BigJob /
Per-Stage / ASA / ASA-Naive / pilot) and the Table-1 and Table-2
runners."""

from repro_torch.sched.queue_sim import Job, QueueSim
from repro_torch.sched.strategies import (ASAEstimator, RunMetrics, run_asa,
                                          run_bigjob, run_per_stage,
                                          run_pilot)
from repro_torch.sched.runner import (Table1Result, Table2Row, run_table1,
                                      run_table2, summarize_table1)

__all__ = [
    "Job", "QueueSim", "ASAEstimator", "RunMetrics", "run_asa", "run_bigjob",
    "run_per_stage", "run_pilot", "Table1Result", "Table2Row", "run_table1",
    "run_table2", "summarize_table1",
]

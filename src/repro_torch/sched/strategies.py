"""Strategy constants the fleet engine mirrors (copy of the constants in
``repro.sched.strategies``). The event-driven strategy runners themselves
are not ported yet (ROADMAP Queue 1, item 3)."""

# §4.5 ASA-Naive miss handling
NAIVE_IDLE_THRESHOLD_S = 300.0   # idle the early allocation up to this gap
NAIVE_CANCEL_LATENCY_S = 60.0    # charged OH when cancelling instead

# Pilot-job policy (id 5): one peak-cores allocation, stages cycled inside
# it; the pilot pays its bootstrap and a per-stage dispatch latency.
PILOT_STARTUP_S = 60.0           # pilot bootstrap before the first task
PILOT_TASK_LATENCY_S = 1.0       # internal dispatch latency per stage

"""repro_torch.sched — own copies of the reference's center and workflow
profiles and the strategy constants the fleet engine mirrors. The
event-driven runners are not ported yet (ROADMAP Queue 1)."""

"""Event-time advance, completions, admissions, hooks and the chunked sweep
(port of ``repro.xsim.events`` for the untraced, fault-free program
without the naive cancel world and without the learned policy).

One ``sim_step`` jumps every lane of the batch to its next event time
(earliest pending submission or running-job completion), then applies,
as masked writes: completions → per-stage release → admissions →
FCFS/backfill scheduling pass → ASA start hook (learn the observed wait)
→ ASA chain hook (sample the cascade). A lane with no events left steps
as an exact no-op: its time, key and tables are untouched.

The reference drains same-instant hooks in a ``lax.while_loop``. In the
program ported here (ASA stages carry their afterok edge), a lane can
have at most one pending start hook and one pending chain hook per step:
a stage starts only after its predecessor is DONE, and a successor's
submit time is written only by its predecessor's chain hook, so it is
first admitted at a later step. One (start, chain) iteration therefore
drains a step exactly; each step also raises an on-device flag if any
hook were left pending, and the sweep checks that flag at each chunk's
host sync and raises rather than continue on a wrong program.

``simulate`` runs the steps in chunks and leaves as soon as every lane is
out of events. The host synchronises once a chunk, never once a step.
"""

from __future__ import annotations

import torch

from repro_torch.core import asa
from repro_torch.core.bins import make_bins
from repro_torch.device import DEFAULT_DEVICE, check_device, resolve_device
from repro_torch.xsim import backfill
from repro_torch.xsim.state import (ASA, ASA_NAIVE, DONE, PENDING, PER_STAGE,
                                    QUEUED, RL, RUNNING, ScenarioState)

CHUNK_STEPS = 8  # steps between drain-exit checks (see `simulate`)

_INF = float("inf")


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"repro_torch.xsim: {what} is not ported yet (ROADMAP Queue 1, "
        f"{item})")


def _check_program(naive: bool, faults: bool, params) -> None:
    if naive:
        raise not_ported("the naive/RL cancel-resubmit world (naive=True)",
                         "item 4(h)")
    if faults:
        raise not_ported("capacity faults (faults=True)", "item 4(i)")
    if params is not None:
        raise not_ported("the learned policy head (params=...)", "item 7")


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b]] for a (B, K) tensor and (B,) indices."""
    return torch.gather(x, 1, idx.long().unsqueeze(1)).squeeze(1)


def _put(x: torch.Tensor, idx: torch.Tensor, val: torch.Tensor
         ) -> torch.Tensor:
    """x with x[b, idx[b]] = val[b] (a new tensor)."""
    return x.scatter(1, idx.long().unsqueeze(1),
                     val.to(x.dtype).unsqueeze(1))


def _clear(mask: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """mask with mask[b, y[b]] = False."""
    cols = torch.arange(mask.shape[1], device=mask.device)
    return mask & (cols != y.unsqueeze(1))


def _asa_like(s: ScenarioState) -> torch.Tensor:
    """Policies that run the cascade hooks (chain + start + estimator)."""
    return (s.policy == ASA) | (s.policy == ASA_NAIVE) | (s.policy == RL)


def next_event_time(s: ScenarioState) -> torch.Tensor:
    """(B,) earliest pending submit or running end; +inf when a lane has
    nothing left. ``repass`` pins a lane to its current instant."""
    submits = torch.where(s.status == PENDING, s.submit, _INF).amin(dim=1)
    ends = torch.where(s.status == RUNNING, s.end, _INF).amin(dim=1)
    return torch.where(s.repass, s.t, torch.minimum(submits, ends))


def complete_jobs(s: ScenarioState, now: torch.Tensor
                  ) -> tuple[ScenarioState, torch.Tensor]:
    done = (s.status == RUNNING) & (s.end <= now.unsqueeze(1))
    freed = torch.where(done, s.cores, 0.0).sum(dim=1)
    s = s._replace(status=torch.where(done, DONE, s.status).to(torch.int32),
                   free=s.free + freed)
    return s, done


def admit_jobs(s: ScenarioState, now: torch.Tensor
               ) -> tuple[ScenarioState, torch.Tensor]:
    adm = (s.status == PENDING) & (s.submit <= now.unsqueeze(1))
    s = s._replace(status=torch.where(adm, QUEUED, s.status).to(torch.int32))
    return s, adm


def _release_per_stage(s: ScenarioState, newly_done: torch.Tensor,
                       now: torch.Tensor) -> ScenarioState:
    """Stage y DONE ⇒ stage y+1 submitted now (submit-on-completion)."""
    b, n = s.status.shape
    fire = (newly_done & s.is_wf & (s.policy == PER_STAGE).unsqueeze(1)
            & (s.wf_next >= 0))
    succ = torch.where(fire, s.wf_next, n).long()        # n = drop column
    padded = torch.cat([s.submit, s.submit.new_zeros(b, 1)], dim=1)
    padded = padded.scatter(1, succ, now.unsqueeze(1).expand(b, n))
    return s._replace(submit=padded[:, :n])


def _start_hook(s: ScenarioState, now: torch.Tensor, bins: torch.Tensor
                ) -> ScenarioState:
    """Process ONE pending stage start per lane: feed the observed queue
    wait to the tuned estimator update (``asa.learn_wait_if``)."""
    n = s.status.shape[1]
    pending = s.start_pending
    any_p = pending.any(dim=1)
    y = torch.argmax(pending.to(torch.uint8), dim=1)   # lowest pending
    row = _take(s.wf_rows, y).clamp(0, n - 1)
    wait = now - _take(s.submit, row)
    return s._replace(
        est=asa.learn_wait_if(s.est, bins, wait, any_p),
        start_pending=_clear(pending, y),
    )


def _chain_hook(s: ScenarioState, now: torch.Tensor, bins: torch.Tensor,
                greedy: bool | torch.Tensor) -> ScenarioState:
    """Process ONE pending stage admission per lane: the §3.2 cascade.

    Stage y first admitted at s_y ⇒ (stage 0 only) draw a_0, fix
    E_y = max(s_y + a_y, E_{y−1}) + t_y, draw the successor's a_{y+1} from
    the live estimator and schedule it for max(now, E_y − a_{y+1})."""
    n = s.status.shape[1]
    pending = s.chain_pending
    any_p = pending.any(dim=1)
    y = torch.argmax(pending.to(torch.uint8), dim=1)
    row = _take(s.wf_rows, y).clamp(0, n - 1)

    need_a0 = any_p & (y == 0)
    prev_row = torch.where(y > 0, _take(s.wf_rows, (y - 1).clamp_min(0)), -1)
    pc = prev_row.clamp(0, n - 1)
    prev_ee = torch.where(prev_row < 0, -_INF, _take(s.expected_end, pc))
    succ = _take(s.wf_next, row)
    sc = succ.clamp(0, n - 1)
    has_succ = any_p & (succ >= 0)

    if greedy is True:
        # both draws read the same (unchanged) MAP; no key is consumed
        est = s.est
        w_map = asa.map_wait(est, bins)
        a0 = torch.where(need_a0, w_map, 0.0)
        a1 = torch.where(has_succ, w_map, 0.0)
    else:
        est, a0 = asa.sample_wait_if(s.est, bins, need_a0, greedy)
        est, a1 = asa.sample_wait_if(est, bins, has_succ, greedy)

    pw_row = torch.where(need_a0, a0, _take(s.pred_wait, row))
    ee = torch.maximum(now + pw_row, prev_ee) + _take(s.duration, row)

    pred_wait = _put(s.pred_wait, row, pw_row)
    pred_wait = _put(pred_wait, sc,
                     torch.where(has_succ, a1, _take(pred_wait, sc)))
    return s._replace(
        est=est,
        chain_pending=_clear(pending, y),
        pred_wait=pred_wait,
        expected_end=_put(s.expected_end, row, torch.where(
            any_p, ee, _take(s.expected_end, row))),
        submit=_put(s.submit, sc, torch.where(
            has_succ, torch.maximum(now, ee - a1), _take(s.submit, sc))),
    )


def _drain_hooks(s: ScenarioState, now: torch.Tensor, bins: torch.Tensor,
                 greedy: bool | torch.Tensor
                 ) -> tuple[ScenarioState, torch.Tensor]:
    """Drain the step's pending hooks: one (start, chain) pair per lane,
    learning before predicting, as the event-driven simulator does.
    Returns the state and a () bool tensor: True if any hook is still
    pending (the one-pair bound of the module docstring was exceeded)."""
    s = _start_hook(s, now, bins)
    s = _chain_hook(s, now, bins, greedy)
    left = (s.start_pending | s.chain_pending).any()
    return s, left


def sim_step(s: ScenarioState, bins: torch.Tensor, *,
             bf_passes: int = backfill.BF_PASSES, freed_mode: str = "auto",
             pred_mode: str | None = None, naive: bool = False, params=None,
             faults: bool = False) -> tuple[ScenarioState, torch.Tensor]:
    """One event step for every lane. ``pred_mode`` None reads each lane's
    ``pred_greedy`` flag; ``"greedy"``/``"sample"`` fix the rule for the
    batch. Returns the state and the hook-overflow flag of
    ``_drain_hooks``."""
    _check_program(naive, faults, params)
    greedy = {None: s.pred_greedy, "greedy": True,
              "sample": False}[pred_mode]
    nxt = next_event_time(s)
    live = torch.isfinite(nxt)
    now = torch.where(live, torch.maximum(nxt, s.t), s.t)
    # utilization integral over (t, now] at the pre-event allocation
    busy_cs = s.busy_cs + (s.total - s.free) * (now - s.t)
    s = s._replace(t=now, busy_cs=busy_cs,
                   repass=torch.zeros_like(s.repass),
                   steps=s.steps + live.to(torch.int32))
    s, newly_done = complete_jobs(s, now)
    s = _release_per_stage(s, newly_done, now)
    s, newly_admitted = admit_jobs(s, now)
    # first admissions of ASA stages queue a chain-hook event
    rows = s.wf_rows.clamp(0, s.status.shape[1] - 1).long()
    stage_ok = (s.wf_rows >= 0) & _asa_like(s).unsqueeze(1)
    s = s._replace(chain_pending=s.chain_pending | (
        stage_ok & torch.gather(newly_admitted, 1, rows)
        & torch.isneginf(torch.gather(s.expected_end, 1, rows))))
    pre_start = s.start
    s = backfill.schedule_pass(s, bf_passes=bf_passes, freed_mode=freed_mode)
    started = (s.status == RUNNING) & torch.isinf(pre_start)
    s = s._replace(start_pending=s.start_pending | (
        stage_ok & torch.gather(started, 1, rows)))
    return _drain_hooks(s, now, bins, greedy)


def _bins_for(s: ScenarioState) -> torch.Tensor:
    m = s.est.log_p.shape[-1]
    return torch.as_tensor(make_bins(m), dtype=torch.float32,
                           device=s.status.device)


def simulate(s: ScenarioState, *, n_steps: int,
             chunk_steps: int = CHUNK_STEPS,
             bf_passes: int = backfill.BF_PASSES, freed_mode: str = "auto",
             pred_mode: str | None = None, naive: bool = False, params=None,
             faults: bool = False) -> ScenarioState:
    """Run a batch for up to ``n_steps`` event steps, leaving early once
    every lane is drained.

    A static ``n_steps % chunk_steps`` remainder runs first, then
    ``chunk_steps``-step chunks while any lane has an event left (one
    host sync a chunk). Drained steps are exact no-ops, so the result
    equals the unchunked run for every chunk size; at most ``n_steps``
    steps ever run. ``chunk_steps=0`` runs exactly ``n_steps`` steps."""
    _check_program(naive, faults, params)
    bins = _bins_for(s)
    overflow = torch.zeros((), dtype=torch.bool, device=s.status.device)

    def run(s: ScenarioState, k: int, overflow: torch.Tensor):
        for _ in range(k):
            s, left = sim_step(s, bins, bf_passes=bf_passes,
                               freed_mode=freed_mode, pred_mode=pred_mode)
            overflow = overflow | left
        return s, overflow

    def check(overflow: torch.Tensor) -> None:
        if bool(overflow):
            raise RuntimeError(
                "repro_torch.xsim: a step left a stage hook pending after "
                "its (start, chain) drain; this program needs the "
                "multi-iteration drain of the naive world")

    if chunk_steps <= 0:
        s, overflow = run(s, n_steps, overflow)
        check(overflow)
        return s
    n_chunks, rem = divmod(n_steps, chunk_steps)
    s, overflow = run(s, rem, overflow)
    for _ in range(n_chunks):
        flags = torch.stack([torch.isfinite(next_event_time(s)).any(),
                             overflow]).cpu()
        check(flags[1])
        if not bool(flags[0]):
            break
        s, overflow = run(s, chunk_steps, overflow)
    check(overflow)
    return s


def sweep(batched: ScenarioState, *, n_steps: int,
          chunk_steps: int = CHUNK_STEPS,
          bf_passes: int = backfill.BF_PASSES, freed_mode: str = "auto",
          pred_mode: str | None = None, naive: bool = False, params=None,
          faults: bool = False,
          device: str | torch.device = DEFAULT_DEVICE) -> ScenarioState:
    """The fleet program: ``simulate`` over a batch that lies on
    ``device``. With the default ``freed_mode="auto"`` the reservation
    scan runs as the ``freed_scan`` kernel on CUDA."""
    dev = resolve_device(device)
    check_device(batched.status, dev, "the scenario batch")
    return simulate(batched, n_steps=n_steps, chunk_steps=chunk_steps,
                    bf_passes=bf_passes, freed_mode=freed_mode,
                    pred_mode=pred_mode, naive=naive, params=params,
                    faults=faults)

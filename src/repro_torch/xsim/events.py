"""Event-time advance, completions, releases, capacity faults, admissions,
hooks and the chunked sweep (port of ``repro.xsim.events``).

One ``sim_step`` jumps every lane of the batch to its next event time
(earliest pending submission, running-job completion or unprocessed
capacity fault), then applies, as masked writes: completions → per-stage
release → naive resubmit release → capacity faults → admissions →
FCFS/backfill scheduling pass → stage-start hook (learn the observed
wait; under ASA-Naive, idle or cancel an early allocation) → ASA chain
hook (sample the cascade; under the learned policy, the policy head's
draws). A lane with no events left steps as an exact no-op: its time,
key and tables are untouched.

Two static flags pick the program, as in the reference:

* ``faults`` adds the fault-schedule term to the event time, the drain
  debt to ``complete_jobs`` and ``_apply_faults``, which processes every
  event due at ``now`` in schedule order: the reference's ``while_loop``
  becomes ``n_faults`` unrolled iterations, each masked per lane.
* ``naive`` (ASA-Naive in the batch) adds CANCELLED resubmissions to the
  event time and the admissions, the resubmit release and the naive
  branch of the start hook. The reference drains the same-instant hooks
  in a ``while_loop`` that runs per lane while no cancel has set
  ``repass`` and a hook is pending. Each iteration clears at least one
  pending bit and the drain sets none, so ``max_stages`` iterations,
  statically unrolled and masked per lane, drain a step exactly.
  ``simulate`` first tries each chunk with the drain cut at
  ``SPEC_HOOK_PAIRS`` iterations and runs it again whole if a step
  needed more: the result is the same, and most steps need none.

``params`` (a ``repro_torch.rl.policy.PolicyParams``, or None) adds the
learned-policy branch of the chain hook: lanes of policy id 4 draw their
leads from the policy head and record each observation and action in
``rl_obs``/``rl_act``. ``params=None`` runs the program without it,
operation for operation.

Without the naive world (ASA stages carry their afterok edge) a lane has
at most one pending start hook and one pending chain hook a step: a
stage starts only after its predecessor is DONE, and a successor's
submit time is written only by its predecessor's chain hook, so it is
first admitted at a later step. That program runs one (start, chain)
pair a step, raises an on-device flag if any hook were left pending, and
the sweep checks that flag at each chunk's host sync and raises rather
than continue on a wrong program.

A state that carries an event ring (``obs.trace``) appends to it where
the reference does: one fused write a step (finishes, naive resubmits,
admissions, starts, in that order, just before the hook drain), the
kills of each fault iteration, and the cancels of each naive drain
iteration. Each append sits under ``if s.trace is not None``, so the
untraced program launches exactly what it launched before tracing.

``simulate`` runs the steps in chunks and leaves as soon as every lane is
out of events. The host synchronises once a chunk, never once a step.
``sharded_sweep`` runs ``sweep`` on each block of a ``scenarios`` mesh
(``launch.mesh``), each block with its own chunked drain exit, and
gathers the blocks bitwise into the single-device result.
"""

from __future__ import annotations

import torch

from repro_torch.core import asa, prng
from repro_torch.core.bins import make_bins
from repro_torch.device import DEFAULT_DEVICE, check_device, resolve_device
from repro_torch.obs import trace as obs_trace
from repro_torch.parallel import fleet as pfleet
from repro_torch.runtime.fault import FAULT_DRAIN, FAULT_FAIL, FAULT_GROW
from repro_torch.sched.strategies import (NAIVE_CANCEL_LATENCY_S,
                                          NAIVE_IDLE_THRESHOLD_S)
from repro_torch.xsim import backfill
from repro_torch.xsim.state import (ASA, ASA_NAIVE, CANCELLED, DONE, PENDING,
                                    PER_STAGE, QUEUED, RL, RUNNING,
                                    ScenarioState)

CHUNK_STEPS = 8  # steps between drain-exit checks (see `simulate`)
SPEC_HOOK_PAIRS = 2  # naive hook-drain iterations of a first try at a chunk

_INF = float("inf")


RL_MODES = ("sample", "greedy")


def check_rl_mode(rl_mode: str) -> None:
    if rl_mode not in RL_MODES:
        raise ValueError(f"unknown rl_mode {rl_mode!r}")


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b]] for a (B, K) tensor and (B,) indices."""
    return torch.gather(x, 1, idx.long().unsqueeze(1)).squeeze(1)


def _put(x: torch.Tensor, idx: torch.Tensor, val: torch.Tensor
         ) -> torch.Tensor:
    """x with x[b, idx[b]] = val[b] (a new tensor)."""
    return x.scatter(1, idx.long().unsqueeze(1),
                     val.to(x.dtype).unsqueeze(1))


def _row_index(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return idx.long().view(-1, 1, 1).expand(-1, 1, x.shape[2])


def _take_row(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b], :] for a (B, K, F) tensor and (B,) indices."""
    return torch.gather(x, 1, _row_index(x, idx)).squeeze(1)


def _put_row(x: torch.Tensor, idx: torch.Tensor, val: torch.Tensor
             ) -> torch.Tensor:
    """x with x[b, idx[b], :] = val[b] (a new tensor)."""
    return x.scatter(1, _row_index(x, idx), val.unsqueeze(1))


def _clear(mask: torch.Tensor, y: torch.Tensor,
           where: torch.Tensor | None = None) -> torch.Tensor:
    """mask with mask[b, y[b]] = False (only in lanes where ``where``
    holds, when given)."""
    cols = torch.arange(mask.shape[1], device=mask.device)
    if where is None:
        return mask & (cols != y.unsqueeze(1))
    return mask & ~((cols == y.unsqueeze(1)) & where.unsqueeze(1))


def _job_stage(s: ScenarioState) -> torch.Tensor:
    """i32 (B, max_jobs) workflow stage index per row; -1 for background."""
    b, n = s.status.shape
    y = torch.arange(s.wf_rows.shape[1], dtype=torch.int32,
                     device=s.status.device).expand(b, -1)
    tgt = torch.where(s.wf_rows >= 0, s.wf_rows, n).long()   # n = drop
    out = torch.full((b, n + 1), -1, dtype=torch.int32,
                     device=s.status.device)
    return out.scatter(1, tgt, y)[:, :n]


def _asa_like(s: ScenarioState) -> torch.Tensor:
    """Policies that run the cascade hooks (chain + start + estimator)."""
    return (s.policy == ASA) | (s.policy == ASA_NAIVE) | (s.policy == RL)


def _naive_like(s: ScenarioState) -> torch.Tensor:
    """Policies without dependency support: early allocations idle or are
    cancelled and resubmitted (§4.5)."""
    return (s.policy == ASA_NAIVE) | (s.policy == RL)


def next_event_time(s: ScenarioState, naive: bool = False,
                    faults: bool = False) -> torch.Tensor:
    """(B,) earliest pending submit, running end or unprocessed capacity
    fault; +inf when a lane has nothing left. CANCELLED rows with a
    finite submit (``naive``) are resubmissions waiting for their time;
    ``repass`` pins a lane to its current instant. ``faults=False``
    elides the fault-schedule term."""
    submittable = s.status == PENDING
    if naive:
        submittable = submittable | (s.status == CANCELLED)
    submits = torch.where(submittable, s.submit, _INF).amin(dim=1)
    ends = torch.where(s.status == RUNNING, s.end, _INF).amin(dim=1)
    nxt = torch.minimum(submits, ends)
    nf = s.fault_t.shape[1]
    if faults and nf:
        ft = torch.where(s.fault_next < nf,
                         _take(s.fault_t, s.fault_next.clamp(0, nf - 1)),
                         _INF)
        nxt = torch.minimum(nxt, ft)
    return torch.where(s.repass, s.t, nxt)


def complete_jobs(s: ScenarioState, now: torch.Tensor, faults: bool = False
                  ) -> tuple[ScenarioState, torch.Tensor]:
    done = (s.status == RUNNING) & (s.end <= now.unsqueeze(1))
    freed = torch.where(done, s.cores, 0.0).sum(dim=1)
    status = torch.where(done, DONE, s.status).to(torch.int32)
    if faults:
        # draining nodes leave as their work completes: freed cores pay
        # outstanding drain debt before returning to the free pool
        pay = torch.minimum(freed, s.cap_debt)
        s = s._replace(status=status, free=s.free + freed - pay,
                       total=s.total - pay, cap_debt=s.cap_debt - pay)
    else:
        s = s._replace(status=status, free=s.free + freed)
    return s, done


def admit_jobs(s: ScenarioState, now: torch.Tensor, naive: bool = False
               ) -> tuple[ScenarioState, torch.Tensor]:
    submittable = s.status == PENDING
    if naive:   # resubmitted CANCELLED rows re-enter the queue
        submittable = submittable | (s.status == CANCELLED)
    adm = submittable & (s.submit <= now.unsqueeze(1))
    s = s._replace(status=torch.where(adm, QUEUED, s.status).to(torch.int32))
    return s, adm


def _submit_successors(s: ScenarioState, fire: torch.Tensor,
                       now: torch.Tensor) -> ScenarioState:
    """Where ``fire`` holds at row j, row ``wf_next[j]`` is submitted now."""
    b, n = s.status.shape
    succ = torch.where(fire, s.wf_next, n).long()        # n = drop column
    padded = torch.cat([s.submit, s.submit.new_zeros(b, 1)], dim=1)
    padded = padded.scatter(1, succ, now.unsqueeze(1).expand(b, n))
    return s._replace(submit=padded[:, :n])


def _release_per_stage(s: ScenarioState, newly_done: torch.Tensor,
                       now: torch.Tensor) -> ScenarioState:
    """Stage y DONE ⇒ stage y+1 submitted now (submit-on-completion)."""
    fire = (newly_done & s.is_wf & (s.policy == PER_STAGE).unsqueeze(1)
            & (s.wf_next >= 0))
    return _submit_successors(s, fire, now)


def _release_naive_resubmit(s: ScenarioState, newly_done: torch.Tensor,
                            now: torch.Tensor
                            ) -> tuple[ScenarioState, torch.Tensor,
                                       torch.Tensor]:
    """Stage y DONE ⇒ a CANCELLED successor is resubmitted now (§4.5).

    Also returns ``(fire, succ_c)``: the firing predecessor lanes and
    their (clamped) successor rows, for the step's fused ring append."""
    n = s.status.shape[1]
    succ_c = s.wf_next.clamp(0, n - 1).long()
    fire = (newly_done & s.is_wf & _naive_like(s).unsqueeze(1)
            & (s.wf_next >= 0)
            & (torch.gather(s.status, 1, succ_c) == CANCELLED))
    return _submit_successors(s, fire, now), fire, succ_c


def _apply_faults(s: ScenarioState, now: torch.Tensor) -> ScenarioState:
    """Process every capacity-fault event due at ``now``, in schedule
    order (events are time-sorted at build; ``fault_next`` is the cursor).

    * GROW d: nodes join — ``total += d``, ``free += d``.
    * DRAIN d (clamped to the machine present): what is free leaves now;
      the rest becomes ``cap_debt``, collected by ``complete_jobs`` as
      running work finishes.
    * FAIL d (clamped): free cores cover what they can; the deficit is
      covered by killing running jobs, most recently started first (LIFO;
      ties go to the lower row, as the reference's stable ``argsort``
      breaks them). Killed jobs are requeued in place with their submit
      time kept; their lost core-seconds accrue to ``restart_cs`` and
      ``restarts`` counts them.

    One unrolled iteration a schedule slot, each masked per lane by
    ``fault_next < n_faults`` and the event being due: a lane with no
    event due is left exactly as it was. The float operations keep the
    reference's order, so ``free``, ``total`` and ``cap_debt`` (sums of
    whole cores) stay exact. A traced state appends each iteration's kills
    (masked by the iteration's active lanes, so an idle lane appends
    nothing)."""
    nf = s.fault_t.shape[1]
    if nf == 0:
        return s
    col = now.unsqueeze(1)
    if s.trace is not None:
        row_i = torch.arange(s.status.shape[1], dtype=torch.int32,
                             device=now.device).expand_as(s.status)
        stage = _job_stage(s)
    for _ in range(nf):
        i = s.fault_next.clamp(0, nf - 1)
        active = (s.fault_next < nf) & (_take(s.fault_t, i) <= now)
        d = _take(s.fault_c, i)
        k = _take(s.fault_k, i)
        is_grow = k == FAULT_GROW
        is_drain = k == FAULT_DRAIN
        is_fail = k == FAULT_FAIL
        # you can never lose more cores than are physically present
        d_s = torch.minimum(d, s.total)
        # DRAIN: remove what is free now, owe the rest
        rm = torch.minimum(s.free, d_s)
        # FAIL: kill most-recently-started running jobs to cover the
        # deficit (free cores absorb the loss first); 0.0 − start keys a
        # start of 0.0 as +0.0, so no sort can order it against −0.0
        deficit = torch.where(is_fail, d_s - s.free, 0.0)
        running = s.status == RUNNING
        order = torch.sort(torch.where(running, 0.0 - s.start, _INF), dim=1,
                           stable=True).indices
        c_sorted = torch.gather(torch.where(running, s.cores, 0.0), 1, order)
        csum = torch.cumsum(c_sorted, dim=1)
        kill_sorted = ((csum - c_sorted < deficit.unsqueeze(1))
                       & (c_sorted > 0.0))
        kill = (torch.zeros_like(running).scatter(1, order, kill_sorted)
                & running & (is_fail & active).unsqueeze(1))
        killed = torch.where(kill, s.cores, 0.0).sum(dim=1)
        lost_cs = torch.where(kill, s.cores * (col - s.start), 0.0).sum(dim=1)
        if s.trace is not None:
            s = s._replace(trace=obs_trace.append_masked(
                s.trace, kill, kind=obs_trace.EV_KILL, t=now, job=row_i,
                stage=stage, cores=s.cores, policy=s.policy, step=s.steps))

        free = torch.where(
            is_grow, s.free + d,
            torch.where(is_drain, s.free - rm,
                        torch.where(is_fail, s.free + killed - d_s, s.free)))
        total = torch.where(
            is_grow, s.total + d,
            torch.where(is_drain, s.total - rm,
                        torch.where(is_fail, s.total - d_s, s.total)))
        s = s._replace(
            free=torch.where(active, free, s.free),
            total=torch.where(active, total, s.total),
            min_free=torch.where(active, torch.minimum(s.min_free, free),
                                 s.min_free),
            cap_debt=torch.where(
                active, s.cap_debt + torch.where(is_drain, d_s - rm, 0.0),
                s.cap_debt),
            status=torch.where(kill, QUEUED, s.status).to(torch.int32),
            start=torch.where(kill, _INF, s.start),
            end=torch.where(kill, _INF, s.end),
            restarts=s.restarts + kill.sum(dim=1, dtype=torch.int32),
            restart_cs=torch.where(active, s.restart_cs + lost_cs,
                                   s.restart_cs),
            fault_next=s.fault_next + active.to(torch.int32),
        )
    return s


def _start_hook(s: ScenarioState, now: torch.Tensor, bins: torch.Tensor,
                live: torch.Tensor | None = None) -> ScenarioState:
    """Process ONE pending stage start per lane: feed the observed queue
    wait to the tuned estimator update (``asa.learn_wait_if``).

    ``live`` is the naive drain's lane mask for this iteration; with it,
    the naive branch runs (``strategies.run_asa``'s ``on_started``): the
    gap to the predecessor's logical end (start + hold + duration, or its
    cancelled attempt's start + duration) is a miss under ASA-Naive when
    positive — short gaps idle the allocation (OH += cores·gap), long
    gaps cancel it (OH += cores·latency) and park the row as CANCELLED
    until the predecessor completes, setting ``repass``. A cancelled
    start does not learn. ``live=None`` is the program without the naive
    world: every lane, no miss machinery. A traced state appends each
    cancel to its ring."""
    n = s.status.shape[1]
    pending = s.start_pending
    any_p = pending.any(dim=1)
    y = torch.argmax(pending.to(torch.uint8), dim=1)   # lowest pending
    row = _take(s.wf_rows, y).clamp(0, n - 1)
    wait = now - _take(s.submit, row)                  # observed queue wait
    if live is None:
        return s._replace(
            est=asa.learn_wait_if(s.est, bins, wait, any_p),
            start_pending=_clear(pending, y),
        )

    any_p = any_p & live
    yp = (y - 1).clamp_min(0)
    prev_row = torch.where(y > 0, _take(s.wf_rows, yp), -1)
    has_prev = prev_row >= 0
    pc = prev_row.clamp(0, n - 1)
    prev_start = _take(s.start, pc)
    prev_status = _take(s.status, pc)
    prev_dur = _take(s.duration, pc)
    canc_yp = _take(s.canc_start, yp)
    prev_started = has_prev & torch.isfinite(prev_start)
    # a cancelled-not-yet-resubmitted predecessor still projects a logical
    # end from its aborted attempt
    prev_cancelled = (has_prev & (prev_status == CANCELLED)
                      & torch.isfinite(canc_yp))
    prev_logical = torch.where(
        ~has_prev, -_INF,
        torch.where(prev_started, prev_start + _take(s.hold, yp) + prev_dur,
                    torch.where(prev_cancelled, canc_yp + prev_dur, _INF)))
    early = prev_logical - now
    is_early = any_p & _naive_like(s) & (early > 0.0)
    do_cancel = is_early & (early > NAIVE_IDLE_THRESHOLD_S)
    do_hold = is_early & ~do_cancel

    est = asa.learn_wait_if(s.est, bins, wait, any_p & ~do_cancel)
    resub_t = torch.where(has_prev & (prev_status == DONE), now, _INF)
    cores = _take(s.cores, row)
    start = _take(s.start, row)
    if s.trace is not None:
        s = s._replace(trace=obs_trace.append_if(
            s.trace, do_cancel, kind=obs_trace.EV_CANCEL, t=now, job=row,
            stage=y.to(torch.int32), cores=cores, policy=s.policy,
            step=s.steps))
    return s._replace(
        est=est,
        start_pending=_clear(pending, y, any_p),
        hold=_put(s.hold, y, torch.where(do_hold, early, _take(s.hold, y))),
        oh_cs=s.oh_cs
        + torch.where(do_hold, cores * early, 0.0)
        + torch.where(do_cancel, cores * NAIVE_CANCEL_LATENCY_S, 0.0),
        misses=s.misses + is_early.to(torch.int32),
        status=_put(s.status, row, torch.where(
            do_cancel, CANCELLED, _take(s.status, row))),
        canc_start=_put(s.canc_start, y, torch.where(
            do_cancel, start, _take(s.canc_start, y))),
        start=_put(s.start, row, torch.where(do_cancel, _INF, start)),
        end=_put(s.end, row, torch.where(do_cancel, _INF,
                                         _take(s.end, row))),
        submit=_put(s.submit, row, torch.where(do_cancel, resub_t,
                                               _take(s.submit, row))),
        free=s.free + torch.where(do_cancel, cores, 0.0),
        # a cancellation changed the machine (cores freed, row possibly
        # resubmitted at this instant): the scheduler runs again before
        # any further hook of the lane fires
        repass=s.repass | do_cancel,
    )


def _chain_hook(s: ScenarioState, now: torch.Tensor, bins: torch.Tensor,
                greedy: bool | torch.Tensor,
                live: torch.Tensor | None = None, params=None,
                rl_mode: str = "sample") -> ScenarioState:
    """Process ONE pending stage admission per lane (in ``live`` lanes,
    when given): the §3.2 cascade.

    Stage y first admitted at s_y ⇒ (stage 0 only) draw a_0, fix
    E_y = max(s_y + a_y, E_{y−1}) + t_y, draw the successor's a_{y+1} from
    the live estimator and schedule it for max(now, E_y − a_{y+1}).

    With ``params``, lanes of policy id 4 draw a_0 and a_{y+1} from the
    policy head instead (``_rl_draws``) and record both observations and
    actions; their estimator draws are computed and dropped, as the
    reference's ``lax.cond`` under ``vmap`` selects."""
    n = s.status.shape[1]
    pending = s.chain_pending
    any_p = pending.any(dim=1)
    if live is not None:
        any_p = any_p & live
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

    if params is not None:
        s, est, a0, a1 = _rl_draws(s, est, a0, a1, now, bins, live, params,
                                   rl_mode, y, row, sc, prev_ee, need_a0,
                                   has_succ)

    pw_row, ee = _cascade(s, row, need_a0, a0, now, prev_ee)
    pred_wait = _put(s.pred_wait, row, pw_row)
    pred_wait = _put(pred_wait, sc,
                     torch.where(has_succ, a1, _take(pred_wait, sc)))
    return s._replace(
        est=est,
        chain_pending=(_clear(pending, y) if live is None
                       else _clear(pending, y, any_p)),
        pred_wait=pred_wait,
        expected_end=_put(s.expected_end, row, torch.where(
            any_p, ee, _take(s.expected_end, row))),
        submit=_put(s.submit, sc, torch.where(
            has_succ, torch.maximum(now, ee - a1), _take(s.submit, sc))),
    )


def _cascade(s: ScenarioState, row: torch.Tensor, need_a0: torch.Tensor,
             a0: torch.Tensor, now: torch.Tensor, prev_ee: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage y's settled a_y (a_0 where it is drawn now) and its expected
    end E_y = max(now + a_y, E_{y−1}) + t_y: ``now`` is the admission
    instant (a same-instant naive cancel may already have rewritten the
    stage's own submit entry)."""
    pw_row = torch.where(need_a0, a0, _take(s.pred_wait, row))
    return pw_row, torch.maximum(now + pw_row, prev_ee) + _take(s.duration,
                                                                 row)


def _rl_draws(s: ScenarioState, est: asa.ASAState, a0: torch.Tensor,
              a1: torch.Tensor, now: torch.Tensor, bins: torch.Tensor,
              live: torch.Tensor | None, params, rl_mode: str,
              y: torch.Tensor, row: torch.Tensor, sc: torch.Tensor,
              prev_ee: torch.Tensor, need_a0: torch.Tensor,
              has_succ: torch.Tensor):
    """The learned policy's leads in lanes of policy id 4, in place of the
    estimator's ``est``, ``a0`` and ``a1``; returns the state with the
    observations and actions recorded, and the lanes' est, a0, a1.

    ``"sample"``: a lane's key splits in three (the first kept, the others
    drawing a_0 and a_{y+1}) in every drain iteration the lane is in
    (``live``), as the reference's loop body splits it whether or not a
    chain hook is pending; ``"greedy"``: argmax, no key consumed. The
    buffer writes are out of place, stage y first, then y + 1 (clamped),
    which reads the first write where the two coincide."""
    from repro_torch.rl import features as rl_features
    from repro_torch.rl import policy as rl_policy

    rl = s.policy == RL
    est_rl, k0, k1 = s.est, None, None
    if rl_mode == "sample":
        ks = prng.split(s.est.key, 3)
        k0, k1 = ks[:, 1], ks[:, 2]
        moved = rl if live is None else rl & live
        est_rl = est_rl._replace(key=torch.where(
            moved.unsqueeze(1), ks[:, 0], s.est.key))

    def act(obs: torch.Tensor, key: torch.Tensor | None) -> torch.Tensor:
        if key is None:
            return rl_policy.act_greedy(params, obs).to(torch.int32)
        return rl_policy.act_sample(params, obs, key).to(torch.int32)

    obs0 = rl_features.observe(s, y, row, prev_ee, now, bins)
    i0 = act(obs0, k0)
    a0_rl = torch.where(need_a0, bins[i0], 0.0)
    _, ee = _cascade(s, row, need_a0, a0_rl, now, prev_ee)
    obs1 = rl_features.observe(s, y + 1, sc, ee, now, bins)
    i1 = act(obs1, k1)
    a1_rl = torch.where(has_succ, bins[i1], 0.0)

    rec0, rec1 = rl & need_a0, rl & has_succ
    y1 = (y + 1).clamp_max(s.wf_rows.shape[1] - 1)
    rl_obs = _put_row(s.rl_obs, y, torch.where(
        rec0.unsqueeze(1), obs0, _take_row(s.rl_obs, y)))
    rl_obs = _put_row(rl_obs, y1, torch.where(
        rec1.unsqueeze(1), obs1, _take_row(rl_obs, y1)))
    rl_act = _put(s.rl_act, y, torch.where(rec0, i0, _take(s.rl_act, y)))
    rl_act = _put(rl_act, y1, torch.where(rec1, i1, _take(rl_act, y1)))
    return (s._replace(rl_obs=rl_obs, rl_act=rl_act),
            asa.select(rl, est_rl, est), torch.where(rl, a0_rl, a0),
            torch.where(rl, a1_rl, a1))


def _drain_hooks(s: ScenarioState, now: torch.Tensor, bins: torch.Tensor,
                 greedy: bool | torch.Tensor, naive: bool,
                 hook_pairs: int | None = None, params=None,
                 rl_mode: str = "sample"
                 ) -> tuple[ScenarioState, torch.Tensor | None]:
    """Drain the step's pending hooks, learning before predicting, as the
    event-driven simulator does.

    Without the naive world: one (start, chain) pair a lane; returns the
    state and a () bool tensor, True if any hook is still pending (the
    one-pair bound of the module docstring was exceeded).

    ``naive``: the reference's drain loop, ``max_stages`` iterations (or
    the first ``hook_pairs``). An iteration's lane mask (no cancel yet, a
    hook pending) is taken before its start hook, so a cancel there still
    lets the same iteration's chain hook run and stops the lane from the
    next one. A lane once out of the loop stays out, so an iteration with
    no lane in it changes nothing, and neither does any after it. Returns
    the state and, when cut at ``hook_pairs``, a () bool tensor, True if
    some lane would run a further iteration (None for the whole drain,
    whose bound holds by construction).

    ``params``/``rl_mode`` feed the chain hook's learned-policy branch,
    whose key split needs the iteration's lane mask in both programs."""
    def live_lanes(s: ScenarioState) -> torch.Tensor:
        return ~s.repass & (s.start_pending | s.chain_pending).any(dim=1)

    if not naive:
        live = None if params is None else live_lanes(s)
        s = _start_hook(s, now, bins)
        s = _chain_hook(s, now, bins, greedy, live, params, rl_mode)
        return s, (s.start_pending | s.chain_pending).any()

    n_stages = s.wf_rows.shape[1]
    pairs = n_stages if hook_pairs is None else min(hook_pairs, n_stages)
    for _ in range(pairs):
        live = live_lanes(s)
        s = _start_hook(s, now, bins, live)
        s = _chain_hook(s, now, bins, greedy, live, params, rl_mode)
    return s, (None if pairs == n_stages else live_lanes(s).any())


def sim_step(s: ScenarioState, bins: torch.Tensor, *,
             bf_passes: int = backfill.BF_PASSES, freed_mode: str = "auto",
             pred_mode: str | None = None, naive: bool = False, params=None,
             rl_mode: str = "sample", faults: bool = False,
             hook_pairs: int | None = None
             ) -> tuple[ScenarioState, torch.Tensor | None]:
    """One event step for every lane. ``pred_mode`` None reads each lane's
    ``pred_greedy`` flag; ``"greedy"``/``"sample"`` fix the rule for the
    batch. ``naive=False`` asserts that no lane runs ASA-Naive or the
    learned policy, eliding the cancel/resubmit world; ``faults=False``
    that no lane carries capacity-fault events, eliding the fault
    machinery. ``params``/``rl_mode`` feed the learned-policy branch of
    the chain hook (``params=None`` elides it); ``rl_mode`` picks sampled
    (training) or argmax (evaluation) actions. ``hook_pairs`` cuts the
    naive drain short (``simulate``'s speculative chunks). Returns the
    state and the flag of ``_drain_hooks``: the hook overflow without the
    naive world, a cut drain's unfinished work, else None."""
    check_rl_mode(rl_mode)
    greedy = {None: s.pred_greedy, "greedy": True,
              "sample": False}[pred_mode]
    nxt = next_event_time(s, naive, faults)
    live = torch.isfinite(nxt)
    now = torch.where(live, torch.maximum(nxt, s.t), s.t)
    # utilization integral over (t, now] at the pre-event allocation
    busy_cs = s.busy_cs + (s.total - s.free) * (now - s.t)
    s = s._replace(t=now, busy_cs=busy_cs,
                   repass=torch.zeros_like(s.repass),
                   steps=s.steps + live.to(torch.int32))
    s, newly_done = complete_jobs(s, now, faults)
    s = _release_per_stage(s, newly_done, now)
    if naive:
        s, resub_fire, resub_succ = _release_naive_resubmit(
            s, newly_done, now)
    if faults:
        # after completions (a job ending at the fault instant finished),
        # before admissions and scheduling (which see post-fault capacity)
        s = _apply_faults(s, now)
    s, newly_admitted = admit_jobs(s, now, naive)
    # first admissions of ASA stages queue a chain-hook event (the -inf
    # expected_end sentinel keeps resubmissions from re-firing)
    rows = s.wf_rows.clamp(0, s.status.shape[1] - 1).long()
    stage_ok = (s.wf_rows >= 0) & _asa_like(s).unsqueeze(1)
    s = s._replace(chain_pending=s.chain_pending | (
        stage_ok & torch.gather(newly_admitted, 1, rows)
        & torch.isneginf(torch.gather(s.expected_end, 1, rows))))
    pre_start = s.start
    s = backfill.schedule_pass(s, bf_passes=bf_passes, freed_mode=freed_mode)
    started = (s.status == RUNNING) & torch.isinf(pre_start)
    if s.trace is not None:
        # one fused ring write a step, in event order: finishes, naive
        # resubmissions, admissions, starts (cancels are appended by the
        # start hook itself, inside the drain)
        row_i = torch.arange(s.status.shape[1], dtype=torch.int32,
                             device=now.device).expand_as(s.status)
        stg = _job_stage(s)
        segs = [(newly_done, obs_trace.EV_FINISH, row_i, stg, s.cores)]
        if naive:
            segs.append((resub_fire, obs_trace.EV_RESUBMIT, resub_succ,
                         torch.gather(stg, 1, resub_succ),
                         torch.gather(s.cores, 1, resub_succ)))
        segs.append((newly_admitted, obs_trace.EV_SUBMIT, row_i, stg,
                     s.cores))
        segs.append((started, obs_trace.EV_START, row_i, stg, s.cores))
        s = s._replace(trace=obs_trace.append_segments(
            s.trace, segs, t=now, policy=s.policy, step=s.steps))
    s = s._replace(start_pending=s.start_pending | (
        stage_ok & torch.gather(started, 1, rows)))
    return _drain_hooks(s, now, bins, greedy, naive, hook_pairs, params,
                        rl_mode)


def _bins_for(s: ScenarioState) -> torch.Tensor:
    m = s.est.log_p.shape[-1]
    return torch.as_tensor(make_bins(m), dtype=torch.float32,
                           device=s.status.device)


def simulate(s: ScenarioState, *, n_steps: int,
             chunk_steps: int = CHUNK_STEPS,
             bf_passes: int = backfill.BF_PASSES, freed_mode: str = "auto",
             pred_mode: str | None = None, naive: bool = False, params=None,
             rl_mode: str = "sample", faults: bool = False) -> ScenarioState:
    """Run a batch for up to ``n_steps`` event steps, leaving early once
    every lane is drained.

    A static ``n_steps % chunk_steps`` remainder runs first, then
    ``chunk_steps``-step chunks while any lane has an event left (one
    host sync a chunk). Drained steps are exact no-ops, so the result
    equals the unchunked run for every chunk size; at most ``n_steps``
    steps ever run. ``chunk_steps=0`` runs exactly ``n_steps`` steps.

    The naive program runs each chunk with its hook drain cut at
    ``SPEC_HOOK_PAIRS`` iterations, and again from the chunk's first state
    with the whole drain if any step of it left a lane with a further
    iteration to run (read at the chunk's host sync). The iterations it
    cut change nothing when no lane needs them, so the result is the
    whole drain's, bit for bit; states are never written in place, so
    keeping the first state costs nothing. ``params``/``rl_mode``: see
    ``sim_step``."""
    bins = _bins_for(s)
    spec = SPEC_HOOK_PAIRS if naive and chunk_steps > 0 else None

    def run(s: ScenarioState, k: int, pairs: int | None):
        flag = torch.zeros((), dtype=torch.bool, device=s.status.device)
        for _ in range(k):
            s, left = sim_step(s, bins, bf_passes=bf_passes,
                               freed_mode=freed_mode, pred_mode=pred_mode,
                               naive=naive, params=params, rl_mode=rl_mode,
                               faults=faults, hook_pairs=pairs)
            if left is not None:
                flag = flag | left
        return s, flag

    def overflow() -> RuntimeError:
        return RuntimeError(
            "repro_torch.xsim: a step left a stage hook pending after its "
            "(start, chain) drain; this program needs the multi-iteration "
            "drain of the naive world (naive=True)")

    def events_left(s: ScenarioState) -> torch.Tensor:
        return torch.isfinite(next_event_time(s, naive, faults)).any()

    if chunk_steps <= 0:
        s, flag = run(s, n_steps, None)
        if bool(flag):
            raise overflow()
        return s
    n_chunks, rem = divmod(n_steps, chunk_steps)
    first, k = s, rem
    s, flag = run(s, rem, spec)
    for i in range(n_chunks + 1):
        more, redo = torch.stack([events_left(s), flag]).cpu().tolist()
        if redo:
            if spec is None:
                raise overflow()
            s, _ = run(first, k, None)   # the whole drain
            more = bool(events_left(s))
        if not more or i == n_chunks:
            return s
        first, k = s, chunk_steps
        s, flag = run(s, chunk_steps, spec)


def sweep(batched: ScenarioState, *, n_steps: int,
          chunk_steps: int = CHUNK_STEPS,
          bf_passes: int = backfill.BF_PASSES, freed_mode: str = "auto",
          pred_mode: str | None = None, naive: bool = False, params=None,
          rl_mode: str = "sample", faults: bool = False,
          device: str | torch.device = DEFAULT_DEVICE) -> ScenarioState:
    """The fleet program: ``simulate`` over a batch that lies on
    ``device``. With the default ``freed_mode="auto"`` the reservation
    scan runs as the ``freed_scan`` kernel on CUDA. ``params`` (the policy
    head's weights, broadcast to every lane) must lie on ``device`` too."""
    dev = resolve_device(device)
    check_device(batched.status, dev, "the scenario batch")
    for p in params or ():
        check_device(p, dev, "the policy head's params")
    return simulate(batched, n_steps=n_steps, chunk_steps=chunk_steps,
                    bf_passes=bf_passes, freed_mode=freed_mode,
                    pred_mode=pred_mode, naive=naive, params=params,
                    rl_mode=rl_mode, faults=faults)


def sharded_sweep(batched: ScenarioState, *, mesh, n_steps: int,
                  chunk_steps: int = CHUNK_STEPS,
                  bf_passes: int = backfill.BF_PASSES,
                  freed_mode: str = "auto", pred_mode: str | None = None,
                  naive: bool = False, params=None, rl_mode: str = "sample",
                  faults: bool = False) -> ScenarioState:
    """``sweep`` split over the blocks of a ``scenarios`` mesh
    (``launch.mesh.ScenariosMesh``).

    The batch is padded to a multiple of the mesh's blocks with copies of
    scenario 0 (a valid row, so the pad lanes run the same program), cut
    into contiguous blocks, and block ``i`` is moved to the mesh's device
    ``i`` with a copy of ``params`` (replicated). Each block runs the
    plain ``sweep`` with its own chunked drain exit (and, in the naive
    world, its own choice to run a chunk again with the whole drain): a
    block whose scenarios drain early stops stepping while busier blocks
    run on, and because drained steps are exact no-ops the blocks,
    gathered in mesh order onto the batch's device and unpadded, equal
    the single-device ``sweep`` bit for bit. One process runs the blocks
    one after another; on a process group's mesh (``mesh.groups``) each
    rank sweeps its own block at once with the others and the blocks are
    all-gathered, so every rank returns the whole batch."""
    n_shards = mesh.shape[pfleet.SCENARIO_AXIS]
    b = pfleet.batch_size(batched)
    padded, _mask = pfleet.pad_batch(batched, n_shards)
    outs = []
    for (_i, dev), block in zip(pfleet.blocks(mesh),
                                pfleet.split(padded, mesh)):
        outs.append(sweep(
            block, n_steps=n_steps, chunk_steps=chunk_steps,
            bf_passes=bf_passes, freed_mode=freed_mode, pred_mode=pred_mode,
            naive=naive, params=pfleet.replicate(params, dev),
            rl_mode=rl_mode, faults=faults, device=dev))
    return pfleet.unpad(pfleet.gather(outs, batched.status.device, mesh), b)

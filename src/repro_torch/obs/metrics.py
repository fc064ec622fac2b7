"""Counters and histograms over finished sweeps (port of
``repro.obs.metrics``).

``scenario_summary`` reduces a batched final ``ScenarioState`` to a flat
dict of ``(B,)`` per-scenario counters (event steps against the budget,
the drain flag, naive misses and cancels, backfill hits, over-allocation
core-hours, trace event counts) plus a ``(B, M)`` wait-time histogram over
the §4.5 bins. ``sweep_summary`` reduces the batch axis on the state's
device (the reference ``vmap``s the first and sums). Counter columns are
integer sums, so they are exact; the two float columns
(``oh_core_hours``, ``steps_frac``) match the reference's to reduction
order. ``sharded_sweep_summary`` reduces each block of a ``scenarios``
mesh on its device, the pad rows masked out, and sums the blocks' raw
sums: its counters equal ``sweep_summary``'s exactly, its float columns
to reduction order (on a process group's mesh each rank sums its own
block). ``replay_chain_waits`` reconstructs the ASA chain's
perceived waits from one scenario's ring on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bins import M_DEFAULT, make_bins
from repro_torch.obs import trace as obtrace
from repro_torch.parallel import fleet as pfleet
from repro_torch.xsim.state import (ASA_NAIVE, DONE, QUEUED, RL,
                                    ScenarioState)

# histogram domain: the same m=53 wait alternatives ASA discretizes over
HIST_BINS = M_DEFAULT

# ``backfill_hits`` compares every pair of rows of a scenario: it takes
# scenarios in blocks of at most this many (row, row) pairs, so its
# boolean intermediates stay near 64 MB each whatever the batch
PAIR_BLOCK = 1 << 26


def wait_histogram(s: ScenarioState, bins: torch.Tensor) -> torch.Tensor:
    """(B, M) i32 counts of observed stage waits, log-nearest-bin
    bucketed (argmin in log space, first bin on ties, as
    ``core.bins.nearest_bin``), over the workflow rows that started."""
    valid = s.is_wf & torch.isfinite(s.start)
    w = torch.maximum(s.start - s.submit,
                      torch.full((), 1e-9, device=s.start.device))
    d = torch.abs(torch.log(bins) - torch.log(w).unsqueeze(2))
    idx = torch.argmin(d, dim=2)
    hist = torch.zeros((s.start.shape[0], bins.shape[0]), dtype=torch.int32,
                       device=s.start.device)
    return hist.scatter_add(1, idx, valid.to(torch.int32))


def backfill_hits(s: ScenarioState) -> torch.Tensor:
    """(B,) i32 count of FCFS overtakes: job i started while an
    earlier-submitted job j was still waiting (j submitted before i,
    already in the queue at i's start, started later); each such i is
    one backfill placement the sorted-reservation pass admitted early.

    The pairwise mask is ``(N, N)`` a scenario: scenarios go in blocks of
    ``PAIR_BLOCK`` pairs, so the peak memory does not grow with B."""
    b, n = s.start.shape
    block = max(1, PAIR_BLOCK // max(n * n, 1))
    started = torch.isfinite(s.start) & (s.status != QUEUED)
    live = s.cores > 0.0
    out = []
    for lo in range(0, b, block):
        sl = slice(lo, lo + block)
        sub, st = s.submit[sl], s.start[sl]
        overtaken = (live[sl].unsqueeze(1)
                     & (sub.unsqueeze(1) < sub.unsqueeze(2))
                     & (sub.unsqueeze(1) <= st.unsqueeze(2))
                     & (st.unsqueeze(1) > st.unsqueeze(2)))
        hit = started[sl] & live[sl] & overtaken.any(dim=2)
        out.append(hit.sum(dim=1, dtype=torch.int32))
    return torch.cat(out)


def scenario_summary(s: ScenarioState, n_steps: int
                     ) -> dict[str, torch.Tensor]:
    """Per-scenario observability counters of a batch, each ``(B,)``
    (``wait_hist`` ``(B, M)``).

    ``n_steps`` is the sweep's step budget (``XSimConfig.n_steps``):
    ``drained`` means the scenario ran out of events before the budget ran
    out of steps. Trace-derived columns appear only when the state carries
    an event ring."""
    dev = s.start.device
    bins = torch.as_tensor(make_bins(HIST_BINS), dtype=torch.float32,
                           device=dev)
    wf = s.is_wf
    b = s.steps.shape[0]
    out = {
        "steps": s.steps,
        "step_budget": torch.full((b,), n_steps, dtype=torch.int32,
                                  device=dev),
        "drained": (s.steps < n_steps).to(torch.int32),
        "wf_done": (wf & (s.status == DONE)).sum(dim=1, dtype=torch.int32),
        "wf_total": wf.sum(dim=1, dtype=torch.int32),
        "misses": s.misses,
        "cancels": torch.isfinite(s.canc_start).sum(dim=1,
                                                    dtype=torch.int32),
        "holds": (s.hold > 0.0).sum(dim=1, dtype=torch.int32),
        "oh_core_hours": s.oh_cs / 3600.0,
        "backfill_hits": backfill_hits(s),
        "wait_hist": wait_histogram(s, bins),
    }
    if s.trace is not None:
        c = obtrace.capacity(s.trace)
        out["trace_events"] = s.trace.head
        out["trace_dropped"] = torch.clamp_min(s.trace.head - c, 0)
        out["trace_overflowed"] = obtrace.overflowed(s.trace).to(torch.int32)
        kinds = obtrace.column(s.trace, "kind")
        for ev, name in obtrace.EVENT_NAMES.items():
            # surviving (post-overflow) events per kind
            out[f"ev_{name}"] = (kinds == ev).sum(dim=1, dtype=torch.int32)
    return out


def _sums(per: dict[str, torch.Tensor], mask: torch.Tensor | None = None
          ) -> dict[str, torch.Tensor]:
    """Batch-axis sums of per-scenario columns (rows where ``mask`` is
    False count as zero)."""
    if mask is not None:
        per = {k: torch.where(mask.view((-1,) + (1,) * (v.dim() - 1)), v,
                              torch.zeros((), dtype=v.dtype,
                                          device=v.device))
               for k, v in per.items()}
    return {k: v.sum(dim=0, dtype=v.dtype) for k, v in per.items()}


def _fleet(out: dict[str, torch.Tensor], b: int, n_steps: int
           ) -> dict[str, torch.Tensor]:
    """The fleet's columns from the raw sums over ``b`` scenarios."""
    dev = out["steps"].device
    n = torch.full((), float(b), dtype=torch.float32, device=dev)
    out["n_scenarios"] = torch.full((), b, dtype=torch.int32, device=dev)
    out["step_budget"] = torch.full((), n_steps, dtype=torch.int32,
                                    device=dev)
    out["drain_frac"] = out.pop("drained").to(torch.float32) \
        / torch.clamp_min(n, 1.0)
    out["steps_frac"] = out["steps"].to(torch.float32) \
        / torch.clamp_min(n * n_steps, 1.0)
    return out


def sweep_summary(final: ScenarioState, *, n_steps: int
                  ) -> dict[str, torch.Tensor]:
    """Fleet-level summary of a batched final state, reduced over the
    batch on its device: integer columns are sums, ``drain_frac`` and
    ``steps_frac`` fractions of the scenarios and of their step budget."""
    return _fleet(_sums(scenario_summary(final, n_steps)),
                  final.steps.shape[0], n_steps)


def sharded_sweep_summary(final: ScenarioState, mesh, *, n_steps: int
                          ) -> dict[str, torch.Tensor]:
    """``sweep_summary`` reduced block by block over a ``scenarios`` mesh
    (``launch.mesh.ScenariosMesh``): each block of the padded batch is
    summarised and summed on its device with the pad rows (copies of
    scenario 0, ``parallel.fleet.pad_batch``) masked out, only the
    blocks' raw sums come back to ``final``'s device, where they are added
    in mesh order and the fractions are taken once. Counter columns equal
    ``sweep_summary``'s exactly; float columns to reduction order. On a
    process group's mesh each rank sums its own block, the raw sums are
    all-gathered, and every rank adds them in mesh order as one process
    does, so both routes give the same bits."""
    b = pfleet.batch_size(final)
    padded, mask = pfleet.pad_batch(final, mesh.shape[pfleet.SCENARIO_AXIS])
    home = final.steps.device
    sums = [_sums(scenario_summary(block, n_steps), m)
            for block, m in pfleet.split((padded, mask), mesh)]
    if getattr(mesh, "groups", None) is not None:
        sums = pfleet.all_gather_tree(sums[0], mesh.groups)
    out = None
    for local in sums:
        local = pfleet.replicate(local, home)
        out = local if out is None else {k: out[k] + v
                                         for k, v in local.items()}
    return _fleet(out, b, n_steps)


def replay_chain_waits(s: ScenarioState, lane: int = 0
                       ) -> tuple[np.ndarray, np.ndarray, np.float32]:
    """Reconstruct the ASA chain's perceived stage waits of scenario
    ``lane`` from its event ring (host numpy).

    Replays the decoded ring (submit, start, cancel order) through the
    f32 recurrences ``events._start_hook`` and ``compare.metrics`` use,
    op for op: the predecessor's logical end ``start + hold + duration``,
    the naive hold-or-cancel rule, then the settled-timeline chain
    ``le_y = max(start_y + hold_y, le_{y-1}) + t_y``, from the ring's
    timestamps and the static job table (durations, stage chain) only.
    Returns ``(pwt, valid, twt)``: per-stage perceived waits, their
    validity mask and their f32 running sum, equal bit for bit to
    ``compare.metrics(s)["twt_s"][lane]`` for ASA-like scenarios."""
    from repro_torch.sched.strategies import NAIVE_IDLE_THRESHOLD_S

    if s.trace is None:
        raise ValueError("scenario carries no trace buffer")
    events, meta = obtrace.decode(s.trace, lane)
    if meta["dropped"]:
        raise ValueError(f"ring overflowed ({meta['dropped']} events "
                         "dropped); waits are not reconstructible")
    # the miss machinery only runs for dependency-free policies
    # (events._naive_like); other policies take every start as settled
    naive_like = int(s.policy[lane]) in (ASA_NAIVE, RL)
    wf_rows = s.wf_rows[lane].cpu().numpy()
    dur = s.duration[lane].cpu().numpy().astype(np.float32)
    n_stages = wf_rows.shape[0]
    stage_of = {int(r): y for y, r in enumerate(wf_rows) if r >= 0}
    f32 = np.float32
    start = np.full(n_stages, np.inf, f32)
    hold = np.zeros(n_stages, f32)
    canc = np.full(n_stages, np.inf, f32)
    cancelled = np.zeros(n_stages, bool)
    submit0 = f32(np.nan)
    thr = f32(NAIVE_IDLE_THRESHOLD_S)

    for i in range(len(events["kind"])):
        r = int(events["job"][i])
        if r not in stage_of:
            continue
        k = int(events["kind"][i])
        y = stage_of[r]
        t = f32(events["t"][i])
        if k == obtrace.EV_SUBMIT and y == 0 and np.isnan(submit0):
            submit0 = t
        elif k == obtrace.EV_START:
            if y == 0 or not naive_like:
                start[y] = t
                continue
            yp, rp = y - 1, int(wf_rows[y - 1])
            # _start_hook's prev_logical, f32 op for op
            if np.isfinite(start[yp]):
                prev_logical = f32(f32(start[yp] + hold[yp]) + dur[rp])
            elif cancelled[yp] and np.isfinite(canc[yp]):
                prev_logical = f32(canc[yp] + dur[rp])
            else:
                prev_logical = f32(np.inf)
            early = f32(prev_logical - t)
            if early > thr:         # long gap: cancelled at this instant
                cancelled[y] = True  # (EV_CANCEL follows in the ring)
                canc[y] = t
            else:
                start[y] = t
                cancelled[y] = False
                if early > f32(0.0):
                    hold[y] = early

    # compare.metrics' settled-timeline chain, f32 op for op
    le = f32(-np.inf)
    twt = f32(0.0)
    pwt = np.zeros(n_stages, f32)
    valid = np.zeros(n_stages, bool)
    for y in range(n_stages):
        r = int(wf_rows[y])
        if r < 0 or not np.isfinite(start[y]):
            continue
        valid[y] = True
        start_l = f32(start[y] + hold[y])
        if y == 0:
            pwt[y] = f32(start[y] - submit0)
            le = f32(start_l + dur[r])
        else:
            pwt[y] = (f32(0.0) if np.isneginf(le)
                      else np.maximum(f32(start[y] - le), f32(0.0)))
            le = f32(np.maximum(start_l, le) + dur[r])
        twt = f32(twt + pwt[y])
    return pwt, valid, twt


def to_host(summary: dict) -> dict:
    """JSON-safe Python view of a (fleet or per-scenario) summary."""
    out = {}
    for k, v in summary.items():
        a = (v.cpu().numpy() if isinstance(v, torch.Tensor)
             else np.asarray(v))
        out[k] = a.item() if a.ndim == 0 else a.tolist()
    return out

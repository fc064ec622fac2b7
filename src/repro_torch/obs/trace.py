"""Device-resident, fixed-capacity event rings, one per scenario (port of
``repro.obs.trace``).

A ``TraceBuffer`` records scheduling events (admissions, starts,
completions, naive cancels and resubmits, fault kills) inside the event
loop. Like every other column of the port's ``ScenarioState`` it is batch
major: ``data`` is one f32 ``(B, capacity, NF)`` tensor and ``head`` an
i32 ``(B,)`` count of the events ever appended to each scenario's ring.
``trace=None`` on the state skips every append at the Python level: the
untraced program launches what it launched before tracing existed and
stays bitwise what it was.

Ring semantics, the reference's exactly: a *sliding window*, not a modulo
ring. Each scenario's ring holds its newest ``min(head, capacity)``
events, oldest first, right-aligned (rows ``[capacity - kept,
capacity)``); rows in front of them are the zeros ``init`` wrote (kind 0 =
empty). An append compacts its masked lanes to a dense, lane-ordered
prefix (cumsum, then ``searchsorted`` of the ranks ``1..L``, then a
gather) and slides the window left by each scenario's event count: with
``ext = cat(data, dense)`` the new window is ``ext[cnt + arange(C)]``,
gathered with an index tensor, so the per-scenario counts never leave the
device. Once ``head > capacity`` the oldest events fall off the front;
``overflowed`` is derived, not stored. Decoding (on the host) is a tail
slice: the window is already chronological.

All seven event fields are f32 columns, in ``FIELDS`` order; the integer
fields (kind, job, stage, policy, step) are exact in f32 because their
values stay far below 2**24:

  kind   col 0  event kind (EV_*; 0 = empty slot)
  t      col 1  simulation time of the event
  job    col 2  job-table row
  stage  col 3  workflow stage index, -1 for background jobs
  cores  col 4  the job's core width
  policy col 5  scenario policy id
  step   col 6  ``ScenarioState.steps`` when appended (1-based)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device

# --- event kinds (0 is reserved for "empty slot") ---------------------------
EV_SUBMIT = 1     # job admitted into the FCFS queue (incl. resubmissions)
EV_START = 2      # job started running (scheduling pass)
EV_FINISH = 3     # running job completed
EV_CANCEL = 4     # naive early allocation cancelled at its start instant
EV_RESUBMIT = 5   # cancelled successor released by predecessor completion
EV_KILL = 6       # running job killed by a node failure, requeued in place

EVENT_NAMES = {
    EV_SUBMIT: "submit",
    EV_START: "start",
    EV_FINISH: "finish",
    EV_CANCEL: "cancel",
    EV_RESUBMIT: "resubmit",
    EV_KILL: "kill",
}

FIELDS = ("kind", "t", "job", "stage", "cores", "policy", "step")
NF = len(FIELDS)
_COL = {f: i for i, f in enumerate(FIELDS)}
_INT_FIELDS = ("kind", "job", "stage", "policy", "step")


class TraceBuffer(NamedTuple):
    """A batch of event windows (batch-major, like ``ScenarioState``)."""

    data: torch.Tensor     # f32 (B, C, NF) newest events right-aligned
    head: torch.Tensor     # i32 (B,) events ever appended


def init(capacity: int, batch: int,
         device: str | torch.device = DEFAULT_DEVICE) -> TraceBuffer:
    """``batch`` empty rings of ``capacity`` event slots on ``device``."""
    if capacity < 1:
        raise ValueError(f"trace capacity must be >= 1, got {capacity}")
    dev = resolve_device(device)
    return TraceBuffer(
        data=torch.zeros((batch, capacity, NF), dtype=torch.float32,
                         device=dev),
        head=torch.zeros((batch,), dtype=torch.int32, device=dev))


def capacity(tr: TraceBuffer) -> int:
    return int(tr.data.shape[-2])


def overflowed(tr: TraceBuffer) -> torch.Tensor:
    """(B,) True once a scenario dropped an event (window slid past)."""
    return tr.head > tr.data.shape[-2]


def column(tr: TraceBuffer, field: str) -> torch.Tensor:
    """One field's (B, C) column (f32; cast on the host if needed)."""
    return tr.data[..., _COL[field]]


def _rows(lanes: tuple, scen: tuple, length: int) -> torch.Tensor:
    """(B, L, NF) f32 event rows in FIELDS order. ``lanes`` holds kind,
    job, stage and cores, each (B, L) (or an int kind); ``scen`` holds t,
    policy and step, each (B,)."""
    kind, job, stage, cores = lanes
    t, policy, step = scen
    b = t.shape[0]

    def lane(v) -> torch.Tensor:
        if isinstance(v, int):   # a fill, not a copy from the host
            return torch.full((b, length), float(v), dtype=torch.float32,
                              device=t.device)
        return v.to(torch.float32).expand(b, length)

    def per_scenario(v: torch.Tensor) -> torch.Tensor:
        return v.to(torch.float32).unsqueeze(1).expand(b, length)

    return torch.stack([lane(kind), per_scenario(t), lane(job), lane(stage),
                        lane(cores), per_scenario(policy),
                        per_scenario(step)], dim=2)


def _slide(data: torch.Tensor, dense: torch.Tensor,
           cnt: torch.Tensor) -> torch.Tensor:
    """Append each scenario's ``dense[b, :cnt[b]]`` rows, dropping its
    oldest ``cnt[b]`` rows.

    ``dense`` rows at index >= cnt are garbage and never enter the window:
    with ``ext = cat(data, dense)`` the rows ``ext[cnt : cnt + C]`` cover
    ``data[cnt:]`` and then ``dense[:cnt]``."""
    b, c, nf = data.shape
    ext = torch.cat([data, dense], dim=1)
    idx = cnt.long().unsqueeze(1) + torch.arange(c, device=data.device)
    return torch.gather(ext, 1, idx.unsqueeze(2).expand(b, c, nf))


def _append(tr: TraceBuffer, mask: torch.Tensor, lanes: tuple,
            scen: tuple) -> TraceBuffer:
    """Masked multi-event window write (``mask`` (B, L))."""
    b, length = mask.shape
    m32 = mask.to(torch.int32)
    cnt = m32.sum(dim=1, dtype=torch.int32)
    # dense lane-ordered prefix: row k = the (k+1)-th True lane. cumsum is
    # strictly increasing on True lanes, so searchsorted(cs, k+1) finds
    # exactly that lane; ranks past cnt clamp to a garbage row that _slide
    # never exposes
    cs = torch.cumsum(m32, dim=1, dtype=torch.int32)
    ranks = torch.arange(1, length + 1, dtype=torch.int32,
                         device=mask.device).expand(b, length).contiguous()
    src = torch.searchsorted(cs, ranks, side="left").clamp_max(length - 1)
    rows = _rows(lanes, scen, length)
    dense = torch.gather(rows, 1, src.unsqueeze(2).expand(b, length, NF))
    return TraceBuffer(data=_slide(tr.data, dense, cnt), head=tr.head + cnt)


def append_masked(tr: TraceBuffer, mask: torch.Tensor, *, kind: int,
                  t: torch.Tensor, job: torch.Tensor, stage: torch.Tensor,
                  cores: torch.Tensor, policy: torch.Tensor,
                  step: torch.Tensor) -> TraceBuffer:
    """Append one event per True lane of ``mask`` (B, L), in lane order.

    ``job``/``stage``/``cores`` are per-lane (B, L), ``t``/``policy``/
    ``step`` per scenario (B,). ``head`` advances by the full masked
    count even when it exceeds the capacity; in that (pathological: more
    events in ONE append than the whole ring holds) case the window lands
    entirely inside the new batch and only its newest ``capacity`` lanes
    survive: the drop order stays deterministic."""
    return _append(tr, mask, (kind, job, stage, cores), (t, policy, step))


def append_segments(tr: TraceBuffer, segments, *, t: torch.Tensor,
                    policy: torch.Tensor, step: torch.Tensor
                    ) -> TraceBuffer:
    """Fuse several same-instant masked appends into ONE window write.

    ``segments`` is a sequence of ``(mask, kind, job, stage, cores)``
    tuples (each (B, L_i), ``kind`` an int); events land in segment order,
    then lane order within a segment: exactly the order the equivalent
    ``append_masked`` chain would give, for one cumsum and slide instead
    of one a segment."""
    masks, kinds, jobs, stages, widths = [], [], [], [], []
    for mask, kind, job, stage, cores in segments:
        masks.append(mask)
        kinds.append(torch.full(mask.shape, kind, dtype=torch.int32,
                                device=mask.device))
        jobs.append(job)
        stages.append(stage)
        widths.append(cores)
    return _append(tr, torch.cat(masks, dim=1),
                   (torch.cat(kinds, dim=1), torch.cat(jobs, dim=1),
                    torch.cat(stages, dim=1), torch.cat(widths, dim=1)),
                   (t, policy, step))


def append_if(tr: TraceBuffer, flag: torch.Tensor, *, kind: int,
              t: torch.Tensor, job: torch.Tensor, stage: torch.Tensor,
              cores: torch.Tensor, policy: torch.Tensor,
              step: torch.Tensor) -> TraceBuffer:
    """Append a single event in each scenario whose ``flag`` (B,) holds;
    every field is per scenario (B,)."""
    row = _rows((kind, job.unsqueeze(1), stage.unsqueeze(1),
                 cores.unsqueeze(1)), (t, policy, step), 1)
    cnt = flag.to(torch.int32)
    return TraceBuffer(data=_slide(tr.data, row, cnt), head=tr.head + cnt)


# ------------------------------------------------------- host-side decoding


def _decode_host(data: np.ndarray, total: int
                 ) -> tuple[dict[str, np.ndarray], dict]:
    c = data.shape[0]
    kept = min(total, c)
    window = data[c - kept:]  # already chronological (window invariant)
    events = {}
    for f, col in _COL.items():
        v = window[:, col]
        events[f] = (v.astype(np.int32) if f in _INT_FIELDS
                     else v.astype(np.float32))
    meta = {"capacity": c, "total": total, "kept": kept,
            "dropped": total - kept, "overflowed": total > c}
    return events, meta


def decode(tr: TraceBuffer, lane: int = 0
           ) -> tuple[dict[str, np.ndarray], dict]:
    """Decode ONE scenario's ring (lane ``lane`` of the batch) into
    chronological order, on the host.

    Returns ``(events, meta)``: ``events`` maps each field name to an
    oldest-first array of the surviving events (int32 for the integer
    fields, float32 for ``t`` and ``cores``); ``meta`` records
    ``capacity``, ``total`` (events ever appended), ``kept``, ``dropped``
    and the ``overflowed`` flag."""
    return _decode_host(tr.data[lane].cpu().numpy(), int(tr.head[lane]))


def decode_batch(tr: TraceBuffer
                 ) -> list[tuple[dict[str, np.ndarray], dict]]:
    """``decode`` every scenario of the batch (one copy to the host)."""
    data, head = tr.data.cpu().numpy(), tr.head.cpu().numpy()
    return [_decode_host(data[i], int(head[i]))
            for i in range(head.shape[0])]

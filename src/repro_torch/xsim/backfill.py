"""Batched FCFS + EASY-backfill scheduling pass (port of
``repro.xsim.backfill``).

Every function takes the whole fleet: job-table tensors are ``(B, N)``.

1. FCFS prefix start: eligible queued jobs sorted by (submit, row); the
   maximal prefix whose core cumsum fits the free cores starts.
2. Reservation: when the queue head does not fit, its earliest feasible
   start (shadow time) and the spare cores then. The hot quantity is
   freed[i] = Σ cores of running jobs ending ≤ end_i, the EASY
   reservation scan. On a CUDA tensor it runs as the hand-written kernel
   ``csrc/freed_scan.cu`` (``freed_matrix``), in one of two designs
   picked by the row length alone (``freed_design``): "fused", one
   launch on the raw tables (mask, in-block sort of the running jobs,
   scan, slot-order store), for rows of up to 16384 slots; "presorted",
   the scan on rows sorted by ``torch.sort`` outside the kernel (the TPU
   kernel's contract), for longer rows. Neither stands in for the other:
   a failed build or launch raises. Its plain versions are the sorted
   ``_freed_sorted`` and the O(n²) ``_freed_math``.
3. Backfill loop: ``bf_passes`` passes, each starting the first queued
   job (FCFS order) that fits now and either drains before the shadow
   time or fits in the reservation's spare cores.

Sorts are stable everywhere (``torch.sort(stable=True)``), as
``jnp.argsort`` is, and ``argmin`` takes the first index on ties: equal
submit times are broken by row index, as in the reference.
"""

from __future__ import annotations

import functools

import torch

from repro_torch import cuda_build
from repro_torch.xsim.state import DONE, QUEUED, RUNNING, ScenarioState

BF_PASSES = 16  # backfill starts per scheduling pass (QueueSim: unbounded)

# "auto": the kernel on CUDA tensors, the sorted plain version on CPU
# tensors. "kernel": the kernel, raising on CPU tensors. "ref": the sorted
# plain version. "ref_n2": the O(n²) plain version.
FREED_MODES = ("auto", "kernel", "ref", "ref_n2")

# launches of the hand-written kernel, counted by its wrappers: in all,
# and by design
KERNEL_LAUNCHES = {"freed_scan": 0}
DESIGN_LAUNCHES = {"fused": 0, "presorted": 0}

FUSED_MAX_N = 16384       # "fused" holds a row in shared memory
PRESORTED_MAX_N = 29056   # "presorted" holds a row's ends and cumsum

_INF = float("inf")


# ---------------------------------------------------------------- helpers
def eligible_mask(s: ScenarioState) -> torch.Tensor:
    """Queued jobs whose afterok dependency (if any) has completed."""
    n = s.status.shape[1]
    dep = s.start_dep.clamp(0, n - 1).long()
    dep_done = (s.start_dep < 0) | (torch.gather(s.status, 1, dep) == DONE)
    return (s.status == QUEUED) & dep_done


def fcfs_order(s: ScenarioState, mask: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable FCFS ordering of ``mask`` jobs by (submit, row index).

    Returns (order, rank), both int64 ``(B, N)``: ``order`` lists rows
    FCFS-first (masked-out rows at the back), ``rank[b, j]`` is row j's
    queue position."""
    key = torch.where(mask, s.submit, _INF)
    order = torch.sort(key, dim=1, stable=True).indices
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(order.shape[1], device=order.device)
        .expand_as(order))
    return order, rank


# ------------------------------------------------- reservation (the scan)
def _masked(ends, cores, running):
    return (torch.where(running, ends, _INF).to(torch.float32),
            torch.where(running, cores, 0.0).to(torch.float32))


def _freed_math(ends: torch.Tensor, cores: torch.Tensor,
                running: torch.Tensor) -> torch.Tensor:
    """O(N²) plain version: freed[b, i] = Σ_j [running_j ∧ e_j ≤ e_i] c_j.
    Memory is (B, N, N): for tests and small tables."""
    e, c = _masked(ends, cores, running)
    before = (e.unsqueeze(1) <= e.unsqueeze(2)) & running.unsqueeze(1)
    return torch.where(before, c.unsqueeze(1), 0.0).sum(dim=2)


def _freed_sorted(ends: torch.Tensor, cores: torch.Tensor,
                  running: torch.Tensor) -> torch.Tensor:
    """O(N log N) plain version: stable sort by end, cores cumsum, and
    the cumsum at the last sorted index whose end ≤ end_i
    (``searchsorted(right=True) − 1``, ties included). Exact for the
    integer core counts every grid uses (sums below 2**24)."""
    e, c = _masked(ends, cores, running)
    e_s, order = torch.sort(e, dim=1, stable=True)
    csum = torch.cumsum(torch.gather(c, 1, order), dim=1)
    cnt = torch.searchsorted(e_s, e, right=True)   # ≥ 1: e_i is present
    return torch.gather(csum, 1, cnt - 1)


def freed_design(n: int) -> str:
    """The design ``freed_matrix`` runs on CUDA rows of ``n`` slots:
    "fused" for 1 <= n <= ``FUSED_MAX_N``, else "presorted"
    (``freed_design`` in ``csrc/freed_scan.cu``)."""
    return "fused" if 1 <= n <= FUSED_MAX_N else "presorted"


@functools.cache
def _launcher(symbol: str):
    """The typed C launcher ``symbol`` of the kernel library, resolved
    once: four device pointers, rows, n, the stream."""
    return cuda_build.function("freed_scan", symbol, 4, 2)


def _launch(symbol: str, ptrs: tuple[int, ...], rows: int, n: int,
            device: torch.device) -> None:
    """Launch on PyTorch's current stream of ``device`` (its raw handle,
    which ``torch.cuda.current_stream().cuda_stream`` also gives, without
    building a Stream object), without a synchronise; raises if the launch
    fails."""
    index = device.index
    if index == torch.cuda.current_device():
        rc = _launcher(symbol)(*ptrs, rows, n,
                               torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(device):
            rc = _launcher(symbol)(*ptrs, rows, n,
                                   torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"freed_scan launch failed: cudaError {rc}")


def _check_cuda(ts: tuple[torch.Tensor, ...], what: str) -> None:
    if not all(t.is_cuda for t in ts):
        raise ValueError(f"{what} runs on CUDA tensors only")
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"{what} inputs lie on different devices")
    if ts[0].dim() != 2 or any(t.shape != ts[0].shape for t in ts):
        raise ValueError(f"{what} wants three equal (B, N) shapes, got "
                         f"{[tuple(t.shape) for t in ts]}")


def freed_fused(ends: torch.Tensor, cores: torch.Tensor,
                running: torch.Tensor) -> torch.Tensor:
    """Launch the "fused" design: the whole reservation scan in one launch
    on the raw tables.

    ``ends``/``cores`` are contiguous float32 ``(B, N)`` and ``running`` a
    contiguous bool ``(B, N)``, all on one CUDA device, N at most
    ``FUSED_MAX_N``. Returns freed float32 ``(B, N)`` in slot order.
    Allocates only the output and never synchronises, so it may be
    captured in a CUDA graph (a replay counts no launch). Raises on
    anything else, and if the launch fails. Valid inputs pass the checks
    with one comparison each; ``_check_cuda`` names what is wrong."""
    device = ends.device
    shape = ends.shape
    if not (ends.is_cuda and cores.device == device
            and running.device == device and len(shape) == 2
            and cores.shape == shape and running.shape == shape):
        _check_cuda((ends, cores, running), "freed_fused")   # raises
    if (ends.dtype != torch.float32 or cores.dtype != torch.float32
            or running.dtype != torch.bool):
        raise TypeError("freed_fused wants float32 ends/cores, bool running")
    if not (ends.is_contiguous() and cores.is_contiguous()
            and running.is_contiguous()):
        raise ValueError("freed_fused wants contiguous tensors")
    rows, n = shape
    if n > FUSED_MAX_N:
        raise ValueError(f"freed_fused holds at most {FUSED_MAX_N} slots a "
                         f"row, got {n}")
    out = torch.empty_like(ends)
    if out.numel():
        _launch("freed_fused_launch", (ends.data_ptr(), cores.data_ptr(),
                                       running.data_ptr(), out.data_ptr()),
                rows, n, device)
        KERNEL_LAUNCHES["freed_scan"] += 1
        DESIGN_LAUNCHES["fused"] += 1
    return out


def freed_scan(ends_sorted: torch.Tensor, cores_sorted: torch.Tensor,
               order: torch.Tensor) -> torch.Tensor:
    """Launch the "presorted" design on end-sorted rows (the TPU kernel's
    contract).

    ``ends_sorted``/``cores_sorted`` are contiguous float32 ``(B, N)`` on
    one CUDA device, masked (non-running slots: end=+inf, cores=0) and
    sorted by end; ``order`` is the int64 sort permutation. Returns freed
    scattered back to the original slot order. Raises on anything else,
    and if the launch fails."""
    ts = (ends_sorted, cores_sorted, order)
    _check_cuda(ts, "freed_scan")
    if (ends_sorted.dtype != torch.float32
            or cores_sorted.dtype != torch.float32
            or order.dtype != torch.int64):
        raise TypeError("freed_scan wants float32 ends/cores, int64 order")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("freed_scan wants contiguous tensors")
    rows, n = ends_sorted.shape
    if n > PRESORTED_MAX_N:
        raise ValueError(f"freed_scan holds at most {PRESORTED_MAX_N} slots, "
                         f"got {n}")
    out = torch.empty_like(ends_sorted)
    if out.numel():
        _launch("freed_scan_launch", (ends_sorted.data_ptr(),
                                      cores_sorted.data_ptr(),
                                      order.data_ptr(), out.data_ptr()),
                rows, n, ends_sorted.device)
        KERNEL_LAUNCHES["freed_scan"] += 1
        DESIGN_LAUNCHES["presorted"] += 1
    return out


def freed_presorted(ends: torch.Tensor, cores: torch.Tensor,
                    running: torch.Tensor) -> torch.Tensor:
    """The "presorted" design at any N it holds: mask, stable row sort
    (outside the kernel, as the reference leaves its sort to XLA), then
    ``freed_scan``, which stores through the permutation."""
    e, c = _masked(ends, cores, running)
    e_s, order = torch.sort(e, dim=1, stable=True)
    c_s = torch.gather(c, 1, order)
    return freed_scan(e_s.contiguous(), c_s.contiguous(), order.contiguous())


def freed_matrix(ends: torch.Tensor, cores: torch.Tensor,
                 running: torch.Tensor) -> torch.Tensor:
    """The reservation scan over (B, N) tables → (B, N) float32.

    On CUDA tensors: the design ``freed_design(N)`` names, "fused" (one
    launch on the raw tables) or, for longer rows, "presorted". On CPU
    tensors: the plain ``_freed_sorted``. Bitwise equal to both plain
    versions on integer core counts."""
    if ends.dim() != 2 or cores.shape != ends.shape \
            or running.shape != ends.shape:
        raise ValueError("freed_matrix wants three equal (B, N) shapes")
    if running.dtype != torch.bool:
        raise TypeError("freed_matrix wants a bool running mask")
    if not ends.is_cuda:
        return _freed_sorted(ends, cores, running)
    if freed_design(ends.shape[1]) == "fused":
        return freed_fused(_f32(ends), _f32(cores), running.contiguous())
    return freed_presorted(ends, cores, running)


def _f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a contiguous float32 tensor (itself when it is one)."""
    if x.dtype == torch.float32 and x.is_contiguous():
        return x
    return x.float().contiguous()


def freed_vector(ends: torch.Tensor, cores: torch.Tensor,
                 running: torch.Tensor, *, mode: str = "auto"
                 ) -> torch.Tensor:
    """Dispatch the freed-cores scan (see ``FREED_MODES``)."""
    if mode == "auto":
        return freed_matrix(ends, cores, running)
    if mode == "kernel":
        if not ends.is_cuda:
            raise ValueError("freed_mode='kernel' needs CUDA tensors; the "
                             "kernel has no CPU version")
        return freed_matrix(ends, cores, running)
    if mode == "ref":
        return _freed_sorted(ends, cores, running)
    if mode == "ref_n2":
        return _freed_math(ends, cores, running)
    raise ValueError(f"unknown freed mode {mode!r} (want one of "
                     f"{FREED_MODES})")


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b]] for a (B, N) table and (B,) indices."""
    return torch.gather(x, 1, idx.unsqueeze(1)).squeeze(1)


def reservation(ends, cores, running, free, head_cores, freed=None):
    """EASY reservation: (shadow_time, spare_cores_at_shadow) per lane.

    Walk running jobs by end time until the head fits; no feasible point
    → +inf. ``freed`` may be precomputed (the kernel); otherwise the
    sorted plain version is used."""
    if freed is None:
        freed = _freed_sorted(ends, cores, running)
    e = torch.where(running, ends, _INF)
    ok = running & (free.unsqueeze(1) + freed >= head_cores.unsqueeze(1))
    pick = torch.argmin(torch.where(ok, e, _INF), dim=1)
    any_ok = ok.any(dim=1)
    shadow = torch.where(any_ok, _take(e, pick), _INF)
    extra = torch.where(any_ok, free + _take(freed, pick) - head_cores, 0.0)
    return shadow, extra


# ------------------------------------------------------- scheduling pass
def _start_rows(s: ScenarioState, mask: torch.Tensor, now: torch.Tensor
                ) -> ScenarioState:
    started_cores = torch.where(mask, s.cores, 0.0).sum(dim=1)
    free = s.free - started_cores
    return s._replace(
        status=torch.where(mask, RUNNING, s.status).to(torch.int32),
        start=torch.where(mask, now.unsqueeze(1), s.start),
        end=torch.where(mask, now.unsqueeze(1) + s.duration, s.end),
        free=free,
        min_free=torch.minimum(s.min_free, free),
    )


def schedule_pass(s: ScenarioState, *, bf_passes: int = BF_PASSES,
                  freed_mode: str = "auto") -> ScenarioState:
    """One FCFS + EASY-backfill pass at each lane's current time ``s.t``."""
    now = s.t
    n = s.status.shape[1]
    rows = torch.arange(n, device=s.status.device)

    # 1. maximal FCFS prefix that fits --------------------------------------
    elig = eligible_mask(s)
    order, rank = fcfs_order(s, elig)
    sorted_elig = torch.gather(elig, 1, order)
    sorted_cores = torch.where(sorted_elig, torch.gather(s.cores, 1, order),
                               0.0)
    csum = torch.cumsum(sorted_cores, dim=1)
    fits = sorted_elig & (csum <= s.free.unsqueeze(1))
    # cores > 0 ⇒ csum monotone ⇒ `fits` is a prefix
    start_mask = torch.zeros_like(elig).scatter_(1, order, fits)
    s = _start_rows(s, start_mask, now)

    # 2. reservation for the head (first eligible job that did not fit) ----
    elig = eligible_mask(s)
    has_head = elig.any(dim=1)
    head = torch.argmin(torch.where(elig, rank, n), dim=1)
    running = s.status == RUNNING
    freed = freed_vector(s.end, s.cores, running, mode=freed_mode)
    shadow, extra = reservation(
        s.end, s.cores, running, s.free,
        torch.where(has_head, _take(s.cores, head), 0.0), freed=freed)

    # 3. bounded backfill loop ---------------------------------------------
    not_head = rows != head.unsqueeze(1)
    for _ in range(bf_passes):
        elig = eligible_mask(s)
        cand = (elig & not_head & (s.cores <= s.free.unsqueeze(1))
                & ((now.unsqueeze(1) + s.duration <= shadow.unsqueeze(1))
                   | (s.cores <= extra.unsqueeze(1))))
        pick = torch.argmin(torch.where(cand, rank, n), dim=1)
        do = cand.any(dim=1) & has_head
        pick_mask = (rows == pick.unsqueeze(1)) & do.unsqueeze(1)
        # the reservation's spare shrinks only when the job rode in on it
        c_pick = _take(s.cores, pick)
        used_extra = torch.where(do & (c_pick <= extra), c_pick, 0.0)
        s = _start_rows(s, pick_mask, now)
        extra = extra - used_extra
    return s

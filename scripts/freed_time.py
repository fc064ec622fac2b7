"""Time the reservation scan's designs at the shapes the sweeps give it.

    python scripts/freed_time.py [--reps N]

Builds ``csrc/freed_scan.cu``, and a copy of it with one more C entry
point that launches the "fused" design in the row layout the caller
names (a warp a row, some rows a block; or a block a row of about N / s
threads, s slots a thread), and a copy with the sort taken out (its
output is wrong: it shows what the sort costs), then at the
repository's grid shapes (B, N) = (1026, 53), (1026, 73), (1026, 153)
and (108, 2313), on tables drawn as ``chip_smoke.py`` phase 2 draws them
(60% running) and, at (108, 2313), also at the main path's running share
(11%), prints for each:

- ``freed_matrix`` ("fused"): the mean CUDA-event time of back-to-back
  calls (what a caller waits, the wrapper's host time included), the
  device time of one call by ``torch.profiler`` and its launches, the
  host time a call (the host clock over calls that do not wait for the
  card), and the same two event and host times for the bare C launcher
  (no Python checks);
- the "presorted" design by name (``freed_presorted``: mask, sort,
  gather, scan), the same three readings;
- the plain ``_freed_sorted``'s event time;
- the device time of "fused" in each row layout it can take (a warp a
  row at 4 or 8 rows a block for N <= 128; a block a row at 2, 4 or 8
  slots a thread), and without its sort;
- the bound: 13 bytes a slot over 3.35 TB/s.

Every output is checked bitwise against ``_freed_sorted``. Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

SRC = Path(__file__).resolve().parents[1] / "src"
sys.path.insert(0, str(SRC))

from repro_torch import cuda_build  # noqa: E402
from repro_torch.xsim import backfill  # noqa: E402

H100_BYTES_PER_S = 3.35e12
# (B, N, running share)
CASES = ((1026, 53, 0.6), (1026, 73, 0.6), (1026, 153, 0.6),
         (108, 2313, 0.6), (108, 2313, 0.11))
# (warp rows?, rows a block, slots a thread) of each layout timed
LAYOUTS = ((1, 4, 0), (1, 8, 0), (0, 1, 2), (0, 1, 4), (0, 1, 8))
ENTRY = """
extern "C" int freed_fused_layout(const float* ends, const float* cores,
                                  const unsigned char* running, float* freed,
                                  int rows, int n, int warp_rows,
                                  int rows_per_block, int slots_per_thread,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (warp_rows)
    return fused_launch<true>(ends, cores, running, freed, rows, n, st,
                              rows_per_block);
  return fused_launch<false>(ends, cores, running, freed, rows, n, st, 1,
                             slots_per_thread);
}
"""
SORT_LOOP = "for (int k = 64; k <= P; k <<= 1)"


def build_variant(name: str, no_sort: bool):
    """The source with the entry point above (which must see the anonymous
    namespace's launchers), optionally without the sort, built as the
    kernels are."""
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    text = (cuda_build.CSRC / "freed_scan.cu").read_text()
    if no_sort:
        assert SORT_LOOP in text
        text = text.replace(SORT_LOOP, "for (int k = 64; k <= 0; k <<= 1)")
    src = cuda_build.BUILD_DIR / f"{name}.cu"
    src.write_text(text + ENTRY)
    lib = cuda_build.BUILD_DIR / f"lib{name}.so"
    subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o",
                    str(lib), str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).freed_fused_layout
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def host_us(fn, calls: int = 200) -> float:
    """Host time a call over ``calls`` calls that do not wait for the card
    (fewer than the launch queue holds)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def event_ms(fn, reps: int) -> float:
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_us(fn, calls: int = 20, tries: int = 4
              ) -> tuple[float, float, dict]:
    """(device us a call, launches a call, {kernel: us a call}) over
    ``calls`` calls by torch.profiler. The trace can lose some launches of
    a window: one that kept no whole number of launches a call is taken
    again, up to ``tries`` times, and the last is scaled (its mean a
    launch times the nearest whole number of launches a call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = {}
        launches = 0
        for ev in prof.key_averages():
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total:
                name = (re.findall(r"(\w+)[<(]", ev.key) or [ev.key])[0]
                rows[name] = rows.get(name, 0.0) + ev.self_device_time_total
                launches += ev.count
        if launches and launches % calls == 0:
            break
    scale = (max(1, round(launches / calls)) / launches if launches
             else 0.0)
    return (sum(rows.values()) * scale, launches * scale,
            {k: v * scale for k, v in rows.items()})


def tables(b: int, n: int, share: float, gen: torch.Generator, dev):
    """As chip_smoke.py phase 2: forced end-time ties, one all-idle row,
    integer core counts; ``share`` of the slots running."""
    ends = torch.rand(b, n, generator=gen) * 1e4
    ends[:, ::4] = 5000.0
    cores = torch.randint(1, 64, (b, n), generator=gen).float()
    running = torch.rand(b, n, generator=gen) < share
    running[0] = False
    return ends.to(dev), cores.to(dev), running.to(dev)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("freed_time: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    cuda_build.build(["freed_scan"])
    layout = build_variant("freed_layouts", no_sort=False)
    no_sort = build_variant("freed_no_sort", no_sort=True)
    fused_c = cuda_build.function("freed_scan", "freed_fused_launch", 4, 2)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(11)
    for b, n, share in CASES:
        e, c, r = tables(b, n, share, gen, dev)
        want = backfill._freed_sorted(e, c, r)
        out = torch.empty_like(e)
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (e.data_ptr(), c.data_ptr(), r.data_ptr(), out.data_ptr())
        assert torch.equal(backfill.freed_matrix(e, c, r), want)
        assert torch.equal(backfill.freed_presorted(e, c, r), want)
        runs = r.sum(dim=1).float()
        line = (f"freed B={b} N={n} running_share={share} R_mean="
                f"{float(runs.mean()):.1f} R_max={int(runs.max())} "
                f"design={backfill.freed_design(n)} bound_ms="
                f"{b * n * 13 / H100_BYTES_PER_S * 1e3:.6f}")
        bare = lambda: fused_c(*ptrs, b, n, stream)  # noqa: E731
        for name, fn in (("fused", lambda: backfill.freed_matrix(e, c, r)),
                         ("presorted",
                          lambda: backfill.freed_presorted(e, c, r)),
                         ("fused_bare", bare)):
            line += f" {name}_ms={event_ms(fn, args.reps):.6f}"
            line += f" {name}_host_us={host_us(fn):.3f}"
            if name != "fused_bare":
                us, launches, by = device_us(fn)
                line += (f" {name}_device_us={us:.3f} {name}_launches="
                         f"{launches:g}")
            if name == "presorted":
                line += f" presorted_kernels={by}"
        line += (" plain_ms="
                 f"{event_ms(lambda: backfill._freed_sorted(e, c, r), args.reps):.6f}")
        print(line, flush=True)
        for warp_rows, per_block, per_thread in LAYOUTS:
            if warp_rows and n > 128:
                continue
            args_ = (*ptrs, b, n, warp_rows, per_block, per_thread, stream)
            out.zero_()
            assert layout(*args_) == 0
            torch.cuda.synchronize()
            assert torch.equal(out, want)
            us, _, _ = device_us(lambda: layout(*args_))
            us_ns, _, _ = device_us(lambda: no_sort(*args_))
            print(f"freed B={b} N={n} share={share} layout="
                  f"{'warp_rows' if warp_rows else 'block_rows'} "
                  f"rows_per_block={per_block} slots_per_thread="
                  f"{per_thread} device_us={us:.3f} "
                  f"no_sort_device_us={us_ns:.3f}", flush=True)

if __name__ == "__main__":
    main()

"""Time the wkv6 kernel's designs at rwkv6-3b's prefill shape.

    python scripts/wkv6_time.py [--reps N]

Builds ``csrc/wkv6.cu``, then, at (B, S, H, K) = (8, 2048, 40, 64) in
bfloat16 with chunk 128 (``chip_smoke.py`` phase 2's serve shape, its
inputs drawn the same way), prints the card, the registers and spills
``ptxas`` reports for each kernel, the mean CUDA-event time of the design
``wkv6_design`` picks and of the CUDA-core design (``wkv6_simt``), and
the device time of each kernel of one call by ``torch.profiler``. Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import math
import re
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

SHAPE = (8, 2048, 40, 64)
CHUNK = 128


def cuda_ms(fn, reps: int) -> float:
    for _ in range(3):
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("wkv6_time: needs a CUDA card")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import cuda_build
    from repro_torch.kernels.rwkv6_scan import ops

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    cuda_build.build(["wkv6"])
    log = cuda_build.BUILD_INFO["wkv6"]["log"]
    for part in log.split("Compiling entry function")[1:]:
        mangled = re.search(r"'(\w+)'", part).group(1)
        design = "mma" if "2tc" in mangled else "simt"
        name = re.search(r"\d+(wkv6\w*?_kernel)(\w*)", mangled)
        name = name.group(1) + name.group(2)[:24]
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores", part)
        print(f"ptxas: {design} {name} registers="
              f"{regs.group(1) if regs else '?'} spill_stores="
              f"{spill.group(1) if spill else '?'}")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(14)
    r, k, v = (torch.randn(SHAPE, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    z_lo, z_hi = math.log(-math.log(0.999)), math.log(-math.log(1e-4))
    w = torch.exp(-torch.exp(z_lo + (z_hi - z_lo) * torch.rand(
        SHAPE, generator=gen, device=dev)))
    u = torch.randn((SHAPE[2], SHAPE[3]), generator=gen, device=dev) * 0.5
    design = ops.wkv6_design(r.dtype, SHAPE[3], CHUNK)
    ms = cuda_ms(lambda: ops.wkv6(r, k, v, w, u, chunk=CHUNK), args.reps)
    simt_ms = cuda_ms(lambda: ops.wkv6_simt(r, k, v, w, u, chunk=CHUNK),
                      max(1, args.reps // 4))
    print(f"wkv6 {'x'.join(map(str, SHAPE))} c{CHUNK} bf16: design={design} "
          f"ms={ms:.6f} simt_ms={simt_ms:.6f}")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ops.wkv6(r, k, v, w, u, chunk=CHUNK)
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total:
            name = (re.findall(r"(\w+)\(", ev.key) or [ev.key])[0]
            print(f"kernel {name}: {ev.self_device_time_total:.1f} us")


if __name__ == "__main__":
    main()

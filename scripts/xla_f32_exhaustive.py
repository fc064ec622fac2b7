"""Hold ``repro_torch.core.xla_f32``'s ``exp``, ``log`` and ``log1p``
against jax's float32 ``exp``, ``log`` and ``log1p`` under ``jit`` on
every one of the 2^32 float32 bit patterns, on the CPU (a check of the
port against the JAX reference, like the tests; it does not run on the
card):

    JAX_PLATFORMS=cpu PYTHONPATH=src python scripts/xla_f32_exhaustive.py \\
        exp --threads 3

Walks the patterns in 256 blocks of 2^24, prints the progress every 32
blocks and every block that differs (NaN counts equal to NaN), and ends
with the count of differing inputs; it exits 1 if any differ. About 8
minutes a function with 3 threads on a recent x86 CPU (``log1p``, whose
multiply-adds round to odd, about 45 minutes).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import xla_f32  # noqa: E402

BLOCK = 1 << 24


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("fn", choices=["exp", "log", "log1p"])
    ap.add_argument("--threads", type=int, default=3)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    port = getattr(xla_f32, args.fn)
    ref = jax.jit(getattr(jnp, args.fn))
    bad, t0 = 0, time.perf_counter()
    for i in range((1 << 32) // BLOCK):
        x = np.arange(i * BLOCK, (i + 1) * BLOCK,
                      dtype=np.uint64).astype(np.uint32).view(np.float32)
        got = port(torch.from_numpy(x)).numpy()
        want = np.asarray(ref(x))
        differ = (got.view(np.uint32) != want.view(np.uint32)) \
            & ~(np.isnan(got) & np.isnan(want))
        if differ.any():
            bad += int(differ.sum())
            print(f"block {i}: {int(differ.sum())} differ, e.g. x="
                  f"{x[differ][:4]} port={got[differ][:4]} "
                  f"jax={want[differ][:4]}", flush=True)
        if i % 32 == 0:
            print(f"block {i}: {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"{args.fn}: {bad} of 2^32 float32 inputs differ from jax "
          f"({time.perf_counter() - t0:.1f} s)")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Run ``chip_smoke.py``'s phase 18 (the hybrid family on the card) alone.

    python3 scripts/hybrid_phase.py

Builds the flash-attention kernel, holds it against its plain version at
zamba2-1.2b's prefill shape (phase 2's row), then runs phase 18 with its
checks, as the smoke runs it: (a) zamba2-1.2b served at its published
size in bfloat16 through the flash kernel; (b) the kernel route against
its twin (each shared-attention call and block; float32 end to end at
full depth); (c) the block prefill against the token-by-token route at
12 layers in float32; (d) training at published size (batch 2, sequence
1024), the loss through the kernel against the plain route, a step
through it refused; (e) threefry draws past flat index 2^32, card
against CPU. Prints the card, each part's seconds and the launches.
About 3 minutes on an H100; a failed check exits non-zero. Needs a CUDA
card.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this script needs a "
                "GPU")
    from repro_torch import cuda_build

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    cuda_build.build(["flash_attention"])
    t1 = time.perf_counter()
    shapes = cs.FLASH_SHAPES
    cs.FLASH_SHAPES = tuple(x for x in shapes if x[2] == 32)
    try:
        row = cs.flash_vs_plain(dev)[cs.FLASH_HYBRID_KEY]
    finally:
        cs.FLASH_SHAPES = shapes
    t2 = time.perf_counter()
    out = cs.hybrid_on_card(dev)
    t3 = time.perf_counter()
    print(json.dumps({"flash_attention": row,
                      "launches": {"serve/hybrid": out["served"]["launches"],
                                   "train/hybrid_kernel_loss": out["train"]}}))
    print(f"hybrid_phase: build_s={t1 - t0:.3f} kernel_s={t2 - t1:.3f} "
          f"phase18_s={t3 - t2:.3f}")


if __name__ == "__main__":
    main()

"""Run ``chip_smoke.py``'s phase 19 (the audio family on the card) alone.

    python3 scripts/audio_phase.py

Builds the flash-attention kernel, then runs phase 19 with its checks, as
the smoke runs it: flash at whisper-tiny's three prefill shapes against
its plain version, timed beside SDPA (row 2d); (a) whisper-tiny served at
its published size in bfloat16 through the flash kernel; (b) the kernel
route against its twin (each flash call; float32 end to end at full
depth, greedy tokens equal); (c) training at published size (batch 4,
sequence 1024), the loss through the kernel against the plain route, a
step through it refused, and ``launch.train`` restarted from its step-2
checkpoint, bitwise; (d) the batches' frames on the card against the CPU
route, bitwise. Prints the card, each part's seconds and the launches.
A failed check exits non-zero. Needs a CUDA card.
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
    out = cs.audio_on_card(dev)
    t2 = time.perf_counter()
    print(json.dumps({"flash_attention_whisper": out["flash_rows"],
                      "launches": {"serve/audio": out["served"]["launches"],
                                   "train/audio_kernel_loss": out["train"]}}))
    print(f"audio_phase: build_s={t1 - t0:.3f} phase19_s={t2 - t1:.3f}")


if __name__ == "__main__":
    main()

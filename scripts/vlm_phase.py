"""Run ``chip_smoke.py``'s phase 20 (the VLM prefix on the card) alone.

    python3 scripts/vlm_phase.py

Builds the flash-attention kernel, then runs phase 20 with its checks, as
the smoke runs it: (a) pixtral-12b served at its published size in
bfloat16 through the flash kernel (8 patches a request, decode from the
reference's empty cache); (b) the prefill step at 1024 patches and a
1024-token prompt, and flash at that shape (4, 2048, 32, 128) against
its plain version, timed beside SDPA (row 2e); (c) the kernel route
against its twin (each flash call; float32 at 4 layers, greedy tokens
equal); (d) training at published width cut to 4 layers (batch 2, 1024
patches and 1024 tokens), the loss through the kernel against the plain
route, a step through it refused, and ``launch.train`` at 1 layer
restarted from its step-2 checkpoint, bitwise; (e) the batches' patch
embeddings on the card against the CPU route; (f) ``core.xla_f32`` on
the card against the CPU; (g) the dry run's argument bytes against the
card. Prints the card, each part's seconds and the launches. A failed
check exits non-zero. Needs a CUDA card.
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
    out = cs.vlm_on_card(dev)
    t2 = time.perf_counter()
    print(json.dumps({"flash_attention_pixtral": out["flash_row"],
                      "launches": {"serve/vlm": out["served"]["launches"],
                                   "train/vlm_kernel_loss": out["train"]}}))
    print(f"vlm_phase: build_s={t1 - t0:.3f} phase20_s={t2 - t1:.3f}")


if __name__ == "__main__":
    main()

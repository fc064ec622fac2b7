"""Run ``chip_smoke.py``'s phase 17 (training on the card) alone.

    python3 scripts/train_phase.py

Builds the three model kernels (``flash_attention``, ``moe_gmm``,
``wkv6``), then runs phase 17 with its checks, as the smoke runs it: (a)
``launch.train.train`` at qwen2-0.5b's published size, checkpointed,
resumed and held bitwise to the uninterrupted run; (b) training steps of
qwen2 (timed, one profiled), moonshot-v1-16b-a3b at 2 layers and
rwkv6-3b at 4 layers, each family's loss through its kernels against the
plain route; (c) a step through the flash kernel refused. Prints the
card, each part's seconds and the kernels' launches. About 2 minutes on
an H100; a failed check exits non-zero. Needs a CUDA card.
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
    cuda_build.build(["flash_attention", "moe_gmm", "wkv6"])
    t1 = time.perf_counter()
    paths = cs.training_on_card(dev)
    t2 = time.perf_counter()
    print(json.dumps({"launches_by_path": paths}))
    print(f"train_phase: build_s={t1 - t0:.3f} phase17_s={t2 - t1:.3f}")


if __name__ == "__main__":
    main()

"""Run ``chip_smoke.py``'s phase 21 (training with parameters split over
a (data, model) mesh of the card) alone.

    python3 scripts/sharded_train_phase.py

Runs phase 21 with its checks, as the smoke runs it: (a) XLA's float32
``log1p`` on the card against the CPU over 2^24 bit patterns, and a
``normal`` and an ``exponential`` draw; (b) qwen2-0.5b at published size
and phase 17's batch, 3 steps on a (2, 2) mesh of the one card, each
layer's compute split over ``model``, against 3 steps of
``make_train_step(accum=2)``: losses and grad norms within 2^-9
relative, the parameter, m and v differences printed; (c) a (1, 2) mesh
against the unsplit step likewise; each split route's peak at most the other route's plus
the shards that repeat a block and the largest layer's and top-level
gathers, and at most the other route's less the split leaves in their
use type plus those two; on (2, 2) two rounds of one more step of the
``accum`` route, the split route and the split route with its
gathers-again hooks off (wall and CPU seconds), then one profiled step
of each (launches, device ms, the gathers counted); (d) ``launch.train`` at 2 layers saved on (2, 2), resumed onto
(4, 1) and (1, 1), each bitwise the ``accum=4`` / ``accum=1`` steps from
the same checkpoint; (e) ``apply_resize`` (2, 2) → (4, 1) bitwise; (f)
a (2, 1) mesh at 4 layers, no compute split, bitwise ``accum=2``.
Prints the card, each part's seconds, the steps' seconds, each route's
peak bytes, those counts and the launches.
Builds no kernel (training takes the plain route). About a minute on an
H100; a failed check exits non-zero. Needs a CUDA card.
"""

from __future__ import annotations

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
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    cs.sharded_training_on_card(dev)
    print(f"sharded_train_phase: phase21_s={time.perf_counter() - t0:.3f}")


if __name__ == "__main__":
    main()

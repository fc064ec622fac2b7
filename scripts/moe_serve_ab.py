"""Compare source trees of the port on moonshot-v1-16b-a3b's serve path.

Each tree (a directory holding ``repro_torch``) runs in its own process,
in the order given, so that two commits are compared on one card in
turns (parent, change, change, parent):

    python scripts/moe_serve_ab.py _archive/parent/src src src \\
        _archive/parent/src

For each tree it prints one line: the steady prefill ms and decode ms a
step of ``launch.serve.generate`` through the kernels (moonshot at full
width, ``--layers`` deep; batch 4, prompt 1024, 16 new tokens, as
``chip_smoke.py`` phase 6 serves it), and the host time of one
``grouped_matmul`` call at a tiny bfloat16 shape, where the host and not
the card sets the pace. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time


def one(tree: str, layers: int) -> None:
    sys.path.insert(0, tree)
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels.moe_gmm import ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models.transformer import init_lm

    dev = torch.device("cuda")
    x = torch.randn((1, 8, 64), device=dev).bfloat16()
    w = torch.randn((1, 64, 64), device=dev).bfloat16()
    for _ in range(50):
        ops.grouped_matmul(x, w)
    torch.cuda.synchronize()
    n = 2000
    t0 = time.perf_counter()
    for _ in range(n):
        ops.grouped_matmul(x, w)
    torch.cuda.synchronize()
    host_us = (time.perf_counter() - t0) / n * 1e6

    cfg = dataclasses.replace(get_arch("moonshot-v1-16b-a3b"),
                              n_layers=layers)
    params = init_lm(cfg, seed=0, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (4, 1024), device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(0))
    gen = 16
    launch_serve.generate(params, prompts, cfg, gen, use_kernels=True)
    res = launch_serve.generate(params, prompts, cfg, gen, use_kernels=True)
    print(f"tree={tree} layers={layers} "
          f"prefill_ms={res['prefill_s'] * 1e3:.3f} "
          f"decode_ms_per_step={res['decode_s'] * 1e3 / gen:.3f} "
          f"gmm_host_us_per_call={host_us:.3f} "
          f"card={torch.cuda.get_device_name(0)}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--layers", type=int, default=48)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        one(args.trees[0], args.layers)
        return
    for tree in args.trees:
        subprocess.run([sys.executable, __file__, "--one", tree,
                        "--layers", str(args.layers)], check=True,
                       timeout=900)


if __name__ == "__main__":
    main()

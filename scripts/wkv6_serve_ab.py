"""Compare source trees of the port on the prefill of the RWKV-6 serve
path, where the wkv6 kernel runs in every layer.

Each tree (a directory holding ``repro_torch``) runs in its own process,
in the order given, so that two commits are compared on one card in
turns (parent, change, change, parent):

    python scripts/wkv6_serve_ab.py _archive/parent/src src src \\
        _archive/parent/src

For each tree it prints one line: the steady prefill ms of
``launch.serve.generate`` through the kernels (the median of three runs
after a warm-up) for rwkv6-3b at full size (batch 8, prompt 2048, as
``chip_smoke.py`` phase 8 serves it), ``--layers`` deep, and the wkv6
launches of one prefill, by design where the tree counts designs. Needs
a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import subprocess
import sys

# arch, batch, prompt length
MODEL = ("rwkv6-3b", 8, 2048)


def one(tree: str, layers: int) -> None:
    sys.path.insert(0, tree)
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels.rwkv6_scan import ops
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import rwkv6 as R

    dev = torch.device("cuda")
    arch, batch, prompt_len = MODEL
    cfg = get_arch(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    params = R.init_lm(cfg, seed=0, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            device=dev, generator=torch.Generator(
                                device=dev).manual_seed(0))
    launch_serve.generate(params, prompts, cfg, 1, use_kernels=True)
    before = ops.KERNEL_LAUNCHES["wkv6"]
    designs = dict(getattr(ops, "DESIGN_LAUNCHES", {}))
    times = [launch_serve.generate(params, prompts, cfg, 1,
                                   use_kernels=True)["prefill_s"] * 1e3
             for _ in range(3)]
    launches = (ops.KERNEL_LAUNCHES["wkv6"] - before) // 3
    by_design = {d: (n - designs[d]) // 3
                 for d, n in getattr(ops, "DESIGN_LAUNCHES", {}).items()}
    print(f"tree={tree} {arch}(L{cfg.n_layers}) prefill_ms="
          f"{statistics.median(times):.3f} "
          f"(runs {', '.join(f'{t:.3f}' for t in times)}) "
          f"wkv6_launches={launches} by_design={by_design or 'n/a'}",
          flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--layers", type=int, default=0,
                    help="depth (default: the full 32 layers)")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        one(args.trees[0], args.layers)
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for tree in args.trees:
        subprocess.run([sys.executable, __file__, "--one", tree,
                        "--layers", str(args.layers)], check=True)


if __name__ == "__main__":
    main()

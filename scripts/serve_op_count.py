"""Count the ATen operations of one ASA decision step on the CPU.

    PYTHONPATH=src python scripts/serve_op_count.py [--slots 1536]
        [--batch 256] [--live 256] [--obs-frac 0.9]

A query batch of ``--live`` rows (a share ``--obs-frac`` of them carrying
an observation, on distinct slots) padded to ``--batch`` goes through
``serve.asa.query_to``, ``serve_step`` and ``decisions_to_host`` on a
``--slots``-slot table; a dispatch-mode counter tallies the operations of
each part by name. On the card each operation that touches a tensor is
about one kernel launch (a view is none), so the count grounds the
prediction of a step's launches and of its host time; a CPU run gives no
device time.
"""

from __future__ import annotations

import argparse
from collections import Counter

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.parallel import fleet
from repro_torch.serve import asa as serve_asa

VIEWS = {"view", "_unsafe_view", "slice", "select", "expand", "unsqueeze",
         "squeeze", "t", "transpose", "reshape", "alias", "as_strided",
         "detach", "lift_fresh", "numpy_T", "unbind", "view_as"}


class OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


def batch(rng, slots: int, live: int, obs_frac: float, size: int):
    slot = rng.permutation(slots)[:live].astype(np.int32)
    has = rng.random(live) < obs_frac
    wait = np.exp(rng.uniform(np.log(5.0), np.log(9e4), live))
    q = serve_asa.QueryBatch(slot=torch.from_numpy(slot),
                             observed_wait=torch.from_numpy(
                                 wait.astype(np.float32)),
                             has_obs=torch.from_numpy(has))
    return fleet.pad_batch(q, size)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--slots", type=int, default=1536)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--live", type=int, default=256)
    ap.add_argument("--obs-frac", type=float, default=0.9)
    args = ap.parse_args()
    torch.set_num_threads(1)
    rng = np.random.default_rng(0)
    table = serve_asa.init_table(args.slots, device="cpu")
    q, mask = batch(rng, args.slots, args.live, args.obs_frac, args.batch)
    serve_asa.wait_bins(53, torch.device("cpu"))
    parts = {}
    with OpCounter() as c:
        qd, md = serve_asa.query_to(q, mask, torch.device("cpu"))
    parts["query_to"] = c.ops
    with OpCounter() as c:
        table, dec = serve_asa.serve_step(table, qd, md)
    parts["serve_step"] = c.ops
    with OpCounter() as c:
        serve_asa.decisions_to_host(dec)
    parts["decisions_to_host"] = c.ops
    total = tot_launch = 0
    for name, ops in parts.items():
        n = sum(ops.values())
        launching = sum(v for k, v in ops.items() if k not in VIEWS)
        total += n
        tot_launch += launching
        top = ", ".join(f"{k} {v}" for k, v in ops.most_common(8))
        print(f"{name}: {n} operations, {launching} not views ({top})")
    print(f"step: {total} operations, {tot_launch} not views, "
          f"slots={args.slots} batch={args.batch} live={args.live} "
          f"obs_frac={args.obs_frac}")


if __name__ == "__main__":
    main()

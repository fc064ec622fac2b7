"""Count the ATen operations of one learned-policy event step and of one
REINFORCE step on the CPU.

    PYTHONPATH=src python scripts/rl_op_count.py [--seeds 8]
        [--rl-mode sample]

The grid is ``rl.train.TrainConfig()``'s: both centers at 1/64 size,
their three scales, three workflows, ``--seeds`` seeds a cell
(B = 18 · seeds) and ``XSimConfig(n_warm=24, n_backlog=16, n_arrivals=24,
max_stages=9, t0=3600)`` (N = 73). One step of the program a training
rollout runs (policy id 4, the naive world, the hook drain cut at
``events.SPEC_HOOK_PAIRS`` as ``simulate``'s first try at a chunk runs it,
and whole as a chunk run again runs it) is counted against the same step
of ASA-Naive lanes without ``params``; the learned-policy branch of the
chain hook (``events._rl_draws``) is also counted alone, a call. Then one
``train.reinforce_step`` on a (B, 9, 12) buffer (forward, autograd's
backward, the update and the entropy). On the card each operation that
touches a tensor is about one kernel launch (a view is none), so the
counts ground the prediction of launches a step; a CPU run gives no
device time.
"""

from __future__ import annotations

import argparse
from collections import Counter

import torch
from serve_op_count import VIEWS, OpCounter

from repro_torch.core import prng
from repro_torch.core.bins import make_bins
from repro_torch.rl import policy as rl_policy
from repro_torch.rl import train as rl_train
from repro_torch.xsim import events, families, policies
from repro_torch.xsim.state import ASA_NAIVE, RL

def launching(ops: Counter) -> int:
    return sum(v for k, v in ops.items() if k not in VIEWS)


def state(cfg: rl_train.TrainConfig, policy: int, n_seeds: int):
    grid = families.family_grid(cfg.sim, cfg.family,
                                center_names=cfg.center_names,
                                workflows=cfg.workflows, policy_ids=(policy,),
                                n_seeds=n_seeds, shrink=cfg.shrink,
                                device="cpu")
    fleet = policies.init_fleet(int(grid.geo_idx.max()) + 1, device="cpu")
    return grid, grid.build(policies.scenario_estimators(
        fleet, torch.as_tensor(grid.geo_idx), 1))


def count_step(s, bins, hook_pairs, **kw) -> tuple[Counter, Counter]:
    """(the whole step's operations, those inside ``_rl_draws``)."""
    inner: Counter = Counter()
    rl_draws = events._rl_draws

    def spy(*a, **k):
        with OpCounter() as c:
            out = rl_draws(*a, **k)
        inner.update(c.ops)
        return out
    events._rl_draws = spy
    try:
        with OpCounter() as c:
            events.sim_step(s, bins, naive=True, hook_pairs=hook_pairs,
                            **kw)
    finally:
        events._rl_draws = rl_draws
    return c.ops, inner   # the outer counter sees the inner's operations


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--rl-mode", default="sample",
                    choices=events.RL_MODES)
    args = ap.parse_args()
    torch.set_num_threads(1)
    cfg = rl_train.TrainConfig(n_seeds=args.seeds)
    bins = torch.as_tensor(make_bins(53), dtype=torch.float32)
    params = rl_policy.init_params(prng.PRNGKey(0), device="cpu")
    grid, s_rl = state(cfg, RL, args.seeds)
    _, s_naive = state(cfg, ASA_NAIVE, args.seeds)
    b, n = s_rl.status.shape
    print(f"grid: B={b} N={n} n_steps={grid.cfg.n_steps} "
          f"rl_mode={args.rl_mode}")
    for pairs in (events.SPEC_HOOK_PAIRS, None):
        tag = f"pairs={pairs or s_rl.wf_rows.shape[1]}"
        base, _ = count_step(s_naive, bins, pairs, pred_mode="greedy")
        rl, inner = count_step(s_rl, bins, pairs, pred_mode="greedy",
                               params=params, rl_mode=args.rl_mode)
        calls = pairs or s_rl.wf_rows.shape[1]
        top = ", ".join(f"{k} {v}" for k, v in inner.most_common(6))
        extra = launching(rl) - launching(base)
        print(f"step {tag}: asa_naive {sum(base.values())} operations, "
              f"{launching(base)} not views; rl {sum(rl.values())} "
              f"operations, {launching(rl)} not views (+{extra}); "
              f"_rl_draws {launching(inner)} not views in {calls} calls, "
              f"{launching(inner) / calls:.1f} a call ({top})")
    obs = prng.normal(prng.PRNGKey(1), (b, 9, 12))
    act = torch.randint(-1, 53, (b, 9), generator=torch.Generator()
                        .manual_seed(0)).to(torch.int32)
    reward = prng.normal(prng.PRNGKey(2), (b,))
    with OpCounter() as c:
        rl_train.reinforce_step(params, obs, act, reward, cfg.lr)
    top = ", ".join(f"{k} {v}" for k, v in c.ops.most_common(8))
    print(f"reinforce_step: {sum(c.ops.values())} operations, "
          f"{launching(c.ops)} not views ({top})")


if __name__ == "__main__":
    main()

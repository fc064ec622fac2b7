"""Fig.-5 convergence simulation (paper §4.4), port of
``repro.core.convergence``.

1000 iterations; the true waiting time step-changes at iterations
0/200/400/600/800; three sampling policies are compared: greedy,
default, and tuned (repetition = 50). The reference's ``lax.scan`` is a
Python loop over one ASA step per iteration.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import asa, prng
from repro_torch.core.bins import make_bins
from repro_torch.core.losses import zero_one
from repro_torch.device import DEFAULT_DEVICE, resolve_device


class ConvergenceResult(NamedTuple):
    true_wait: np.ndarray      # (T,)
    estimate: np.ndarray       # (T,) MAP wait estimate per iteration
    expected: np.ndarray       # (T,) posterior-mean estimate
    hit: np.ndarray            # (T,) 1 where the chosen action was optimal
    regret: np.ndarray         # (T,) cumulative chosen-loss − best-fixed loss
    rounds: np.ndarray         # (T,) η(t) trajectory


def default_truth_schedule(key: torch.Tensor, T: int = 1000,
                           n_changes: int = 5) -> torch.Tensor:
    """True wait step-changes at iterations 0, T/5, 2T/5, …; values drawn
    log-uniformly over the bin range."""
    lo = float(np.log(np.float32(10.0)))
    hi = float(np.log(np.float32(100_000.0)))
    vals = torch.exp(prng.uniform(key, (n_changes,), lo, hi))
    seg = T // n_changes
    out = vals.repeat_interleave(seg)
    if out.shape[0] < T:       # jnp.repeat's total_repeat_length pads
        out = torch.cat([out, out[-1:].expand(T - out.shape[0])])
    return out[:T]


def simulate(policy: str = "default", *, T: int = 1000, m: int = 53,
             gamma: float = 1.0, repetitions: int = 50, seed: int = 0,
             truth: np.ndarray | None = None,
             device: str | torch.device = DEFAULT_DEVICE
             ) -> ConvergenceResult:
    """Run one policy for ``T`` iterations against a step-changing truth."""
    dev = resolve_device(device)
    keys = prng.split(prng.PRNGKey(seed, dev))
    if truth is None:
        truth_t = default_truth_schedule(keys[0], T)
    else:
        truth_t = torch.as_tensor(truth, dtype=torch.float32, device=dev)
    bins = torch.as_tensor(make_bins(m), dtype=torch.float32, device=dev)
    state = asa.init(m, keys[1])
    g = torch.tensor(gamma, dtype=torch.float32, device=dev)
    est, exp_est, chosen, rounds = [], [], [], []
    for i in range(T):
        lv = zero_one(bins, truth_t[i])
        state, a = asa.step(state, lv, g, policy=policy,
                            repetitions=repetitions)
        est.append(asa.map_wait(state, bins))
        exp_est.append(asa.expected_wait(state, bins))
        chosen.append(lv[a])
        rounds.append(state.rounds)
    chosen_loss = torch.stack(chosen)
    # best fixed action in hindsight (Theorem 1's comparator θ̄)
    all_losses = zero_one(bins, truth_t)                  # (T, m)
    best_fixed = torch.cumsum(all_losses, dim=0).amin(dim=1)
    regret = torch.cumsum(chosen_loss, dim=0) - best_fixed
    return ConvergenceResult(
        true_wait=truth_t.cpu().numpy(),
        estimate=torch.stack(est).cpu().numpy(),
        expected=torch.stack(exp_est).cpu().numpy(),
        hit=(1.0 - chosen_loss).cpu().numpy(),
        regret=regret.cpu().numpy(),
        rounds=torch.stack(rounds).cpu().numpy(),
    )

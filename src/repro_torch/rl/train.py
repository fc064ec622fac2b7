"""REINFORCE-with-baseline training of the submission-policy head (port of
``repro.rl.train``).

Plain SGD: each iteration sweeps a fresh ``ScenarioGrid`` resample (new
background draws, the same cell structure) with stochastic actions; the
batch-mean reward is the baseline, advantages are normalized, and the
policy gradient

    ∇ E[R] ≈ mean_b [ Â_b · Σ_y ∇ log π(a_by | o_by) ]

is taken by torch autograd through a replayed log-prob pass over the
recorded ``(obs, act)`` buffers. The simulator itself is never
differentiated (actions are discrete; REINFORCE needs no environment
gradients), so the update is a small dense computation whatever the
simulator's depth. Each update builds new tensors: the initial head is
never written over.

``evaluate`` reruns a held-out grid with all five strategies (BigJob,
Per-Stage, ASA, ASA-Naive and the learned head, greedy actions) on
identical per-seed machines, the Table-1 comparison setting.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.obs import metrics as obs_metrics
from repro_torch.rl import policy as P
from repro_torch.rl import rollout
from repro_torch.xsim import policies as xpolicies
from repro_torch.xsim.families import FAMILIES, family_grid
from repro_torch.xsim.grid import XSimConfig, warm_fleet
from repro_torch.xsim.state import ASA, ASA_NAIVE, BIGJOB, PER_STAGE, RL


@dataclass(frozen=True)
class TrainConfig:
    """Knobs of one training run (defaults: the full 30-iteration recipe;
    the repository's acceptance recipe is ``benchmarks/rl_train.py``'s
    ``SMOKE``)."""

    iters: int = 30
    lr: float = 0.3
    n_seeds: int = 8            # episodes per cell per iteration
    hidden: int = P.HIDDEN_DEFAULT
    seed: int = 0
    oh_weight: float = rollout.OH_WEIGHT_DEFAULT
    warm_rounds: int = 3        # §4.3 estimator warm-up before training
    center_names: Sequence[str] = ("hpc2n", "uppmax")
    workflows: Sequence[str] = ("montage", "blast", "statistics")
    shrink: float = 1.0 / 64.0
    n_shards: int | None = None  # sharded rollouts (None: one device)
    family: str = "clean"       # robustness family of every grid the run
    #   touches (xsim.families): training rollouts, estimator warm-up and
    #   the held-out evaluation all see the same capacity-fault regime
    sim: XSimConfig = field(default_factory=lambda: XSimConfig(
        n_warm=24, n_backlog=16, n_arrivals=24, max_stages=9, t0=3600.0))

    def __post_init__(self) -> None:
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}; expected "
                             f"one of {FAMILIES}")


@dataclass
class TrainResult:
    params: P.PolicyParams
    init_params: P.PolicyParams
    rewards: list[float]        # batch-mean reward per iteration
    entropies: list[float]      # mean action entropy per iteration (nats)
    # per-iteration fleet summaries (obs.metrics over each rollout's final
    # states, JSON-safe dicts)
    telemetry: list[dict] = field(default_factory=list)


def _surrogate(params: P.PolicyParams, obs: torch.Tensor, act: torch.Tensor,
               adv: torch.Tensor) -> torch.Tensor:
    """-mean_b( Â_b · Σ_y log π(a_by|o_by) ); act == -1 slots masked."""
    mask = act >= 0
    lp = P.log_prob(params, obs, torch.clamp_min(act, 0))
    per_ep = torch.where(mask, lp, 0.0).sum(dim=-1)
    return -torch.mean(adv * per_ep)


def reinforce_step(params: P.PolicyParams, obs: torch.Tensor,
                   act: torch.Tensor, reward: torch.Tensor, lr: float
                   ) -> tuple[P.PolicyParams, torch.Tensor]:
    """One SGD step on the REINFORCE surrogate; returns (new params, mean
    entropy of the old head over the visited observations).

    The baseline is the batch-mean reward; advantages are normalized to
    unit variance (the population standard deviation, as ``jnp.std``), so
    ``lr`` is scale-free across reward regimes. The buffers are detached:
    only the four leaves carry a gradient."""
    obs, act, reward = obs.detach(), act.detach(), reward.detach()
    adv = reward - torch.mean(reward)
    adv = adv / (torch.std(adv, correction=0) + 1e-6)
    leaves = [p.detach().requires_grad_(True) for p in params]
    with torch.enable_grad():
        loss = _surrogate(P.PolicyParams(*leaves), obs, act, adv)
        grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        new = P.PolicyParams(*(p.detach() - lr * g
                               for p, g in zip(params, grads)))
        lp = torch.log_softmax(P.logits(params, obs), dim=-1)
        ent = -torch.sum(torch.exp(lp) * lp, dim=-1)
        mask = act >= 0
        ent = torch.where(mask, ent, 0.0).sum() \
            / torch.clamp_min(mask.sum(), 1)
    return new, ent


def warmed_fleet(cfg: TrainConfig, grid_seed: int, *,
                 device: str | torch.device = DEFAULT_DEVICE):
    """A §4.3-warmed per-geometry estimator fleet on ``device`` (the head
    reads the live posterior as features, so training starts from the
    informed state the hand-designed ASA enjoys)."""
    dev = resolve_device(device)
    warm_grid = family_grid(cfg.sim, cfg.family,
                            center_names=cfg.center_names,
                            workflows=cfg.workflows,
                            policy_ids=(PER_STAGE, ASA), n_seeds=2,
                            shrink=cfg.shrink, seed=grid_seed, device=dev)
    fleet = xpolicies.init_fleet(int(warm_grid.geo_idx.max()) + 1,
                                 device=dev)
    return warm_fleet(fleet, warm_grid, rounds=cfg.warm_rounds,
                      n_shards=cfg.n_shards, device=dev)


def train(cfg: TrainConfig = TrainConfig(), *,
          device: str | torch.device = DEFAULT_DEVICE) -> TrainResult:
    """REINFORCE over ``cfg.iters`` grid resamples on ``device``; returns
    the curve."""
    dev = resolve_device(device)
    key = prng.PRNGKey(cfg.seed, dev)
    params = init_params = P.init_params(key, hidden=cfg.hidden, device=dev)
    fleet = warmed_fleet(cfg, grid_seed=cfg.seed, device=dev)

    rewards: list[float] = []
    entropies: list[float] = []
    telemetry: list[dict] = []
    for i in range(cfg.iters):
        grid = family_grid(cfg.sim, cfg.family,
                           center_names=cfg.center_names,
                           workflows=cfg.workflows,
                           policy_ids=(RL,), n_seeds=cfg.n_seeds,
                           shrink=cfg.shrink,
                           seed=cfg.seed * 10_000 + i + 1, device=dev)
        final, _, traj = rollout.collect(grid, params, fleet,
                                         pred_seed=i + 1, rl_mode="sample",
                                         oh_weight=cfg.oh_weight,
                                         n_shards=cfg.n_shards, device=dev)
        rewards.append(float(torch.mean(traj.reward)))
        telemetry.append(obs_metrics.to_host(obs_metrics.sweep_summary(
            final, n_steps=grid.cfg.n_steps)))
        params, ent = reinforce_step(params, traj.obs, traj.act,
                                     traj.reward, cfg.lr)
        entropies.append(float(ent))
    return TrainResult(params=params, init_params=init_params,
                       rewards=rewards, entropies=entropies,
                       telemetry=telemetry)


def evaluate(params: P.PolicyParams, cfg: TrainConfig = TrainConfig(), *,
             eval_seed: int = 777, n_seeds: int = 8,
             oh_weight: float | None = None, fleet=None,
             device: str | torch.device = DEFAULT_DEVICE
             ) -> dict[str, dict[str, float]]:
    """Held-out strategy comparison on ``device``: all five policies,
    greedy actions.

    ``eval_seed`` keys background draws never seen in training (training
    grids use ``cfg.seed·10000 + i + 1``). ``fleet`` lets callers reuse
    one ``warmed_fleet(cfg, grid_seed=eval_seed)`` across evaluations of
    several heads on the same held-out grid. Returns ``{strategy: {twt_s,
    makespan_s, core_hours, oh_hours, reward, n}}`` means over the
    grid."""
    dev = resolve_device(device)
    w = cfg.oh_weight if oh_weight is None else oh_weight
    if fleet is None:
        fleet = warmed_fleet(cfg, grid_seed=eval_seed, device=dev)
    grid = family_grid(cfg.sim, cfg.family,
                       center_names=cfg.center_names,
                       workflows=cfg.workflows,
                       policy_ids=(BIGJOB, PER_STAGE, ASA, ASA_NAIVE, RL),
                       n_seeds=n_seeds, shrink=cfg.shrink, seed=eval_seed,
                       device=dev)
    _, m, traj = rollout.collect(grid, params, fleet, pred_seed=eval_seed,
                                 rl_mode="greedy", oh_weight=w,
                                 n_shards=cfg.n_shards, device=dev)
    reward = traj.reward.cpu().numpy()
    m = {k: v.cpu().numpy() for k, v in m.items()}

    by: dict[str, list[int]] = {}
    for i, lab in enumerate(grid.labels):
        by.setdefault(lab["strategy"], []).append(i)
    out: dict[str, dict[str, float]] = {}
    for strat, idx in sorted(by.items()):
        out[strat] = {k: float(np.mean(m[k][idx]))
                      for k in ("twt_s", "makespan_s", "core_hours",
                                "oh_hours")}
        out[strat]["reward"] = float(np.mean(reward[idx]))
        out[strat]["n"] = len(idx)
    return out

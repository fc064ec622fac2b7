"""Batched episode collection on the fleet simulator (port of
``repro.rl.rollout``).

One ``collect`` call sweeps a whole ``ScenarioGrid`` of learned-policy
scenarios as one batch (policy id 4 in ``xsim.events``) and reads the
trajectory out of the final states: the chain hook recorded every
observation/action pair in the ``rl_obs``/``rl_act`` buffers, so the
rollout needs no Python-side stepping. The sweep runs under
``torch.no_grad``: REINFORCE never differentiates the simulator.

The per-scenario reward mirrors ``compare.metrics``: the negative
perceived inter-stage waiting time (hours) minus an over-allocation
penalty on the OH core-hours the no-dependency world charges for early
starts (idle holds and cancel latencies).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.device import DEFAULT_DEVICE
from repro_torch.xsim.grid import ScenarioGrid, run_grid
from repro_torch.xsim.state import ScenarioState

# One wasted core-hour costs as much reward as one hour of perceived
# wait: the exchange rate compare.metrics' core_hours column uses when it
# folds oh_hours into the total.
OH_WEIGHT_DEFAULT = 1.0


class Trajectory(NamedTuple):
    """REINFORCE batch: (B, S, F) obs, (B, S) actions, (B,) rewards.

    ``act == -1`` marks unused stage slots (shorter workflows, or stages
    the step budget never admitted); mask with ``act >= 0``."""

    obs: torch.Tensor
    act: torch.Tensor
    reward: torch.Tensor


def episode_rewards(metrics: dict[str, torch.Tensor],
                    oh_weight: float = OH_WEIGHT_DEFAULT) -> torch.Tensor:
    """(B,) rewards from a batched metrics dict (higher is better)."""
    return -(metrics["twt_s"] / 3600.0 + oh_weight * metrics["oh_hours"])


def trajectory(final: ScenarioState, metrics: dict[str, torch.Tensor],
               oh_weight: float = OH_WEIGHT_DEFAULT) -> Trajectory:
    """Read the recorded (obs, act, reward) batch out of a finished sweep."""
    return Trajectory(obs=final.rl_obs, act=final.rl_act,
                      reward=episode_rewards(metrics, oh_weight))


def collect(grid: ScenarioGrid, params, fleet=None, *, pred_seed: int = 1,
            rl_mode: str = "sample", oh_weight: float = OH_WEIGHT_DEFAULT,
            freed_mode: str = "auto", n_shards: int | None = None,
            mesh=None, device: str | torch.device = DEFAULT_DEVICE):
    """Sweep the grid under ``params`` on ``device``; returns (final,
    metrics, trajectory).

    ``rl_mode="sample"`` draws stochastic actions (training);
    ``"greedy"`` takes the argmax bin (evaluation). ``pred_seed``
    decorrelates the per-scenario action streams between iterations.
    ``freed_mode`` selects the reservation scan (the default runs the
    ``freed_scan`` kernel on CUDA). ``n_shards``/``mesh`` split the
    episode batch over a ``scenarios`` mesh (params replicated,
    trajectories gathered), bitwise the single-device rollout, so
    training curves do not depend on the device count; on a process
    group's mesh every rank holds the gathered trajectory, so each rank's
    ``rl.train.reinforce_step`` gives the same head."""
    with torch.no_grad():
        final, m = run_grid(grid, fleet, pred_seed=pred_seed,
                            freed_mode=freed_mode, params=params,
                            rl_mode=rl_mode, n_shards=n_shards, mesh=mesh,
                            device=device)
        return final, m, trajectory(final, m, oh_weight)

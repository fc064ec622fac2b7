"""Loss functions scored against the true queue waiting time (port of
``repro.core.losses``).

Eq. (3) of the paper: ℓ_y(a) = 0 for the candidate closest to the true
wait (in log space), 1 otherwise. The shaped losses are beyond-paper
variants for the sensitivity study. ``true_wait`` may carry leading batch
dims; the loss vector then has shape ``true_wait.shape + (m,)``.
"""

from __future__ import annotations

import torch

from repro_torch.core import xla_f32


def _log_dist(bins: torch.Tensor, true_wait: torch.Tensor) -> torch.Tensor:
    w = torch.clamp_min(true_wait, 1e-9).to(torch.float32)
    # one call takes both logs (elementwise: the same bits, half the
    # launches)
    logs = xla_f32.log(torch.cat([bins.to(torch.float32).reshape(-1),
                                  w.reshape(-1)]))
    logb = logs[:bins.numel()].view(bins.shape)
    return logb - logs[bins.numel():].view(w.shape).unsqueeze(-1)


def zero_one(bins: torch.Tensor, true_wait: torch.Tensor) -> torch.Tensor:
    """Eq. (3): (…, m) vector, 0 at the closest-to-truth bin (the first on
    a tie), 1 elsewhere."""
    best = torch.argmin(torch.abs(_log_dist(bins, true_wait)), dim=-1)
    idx = torch.arange(bins.shape[-1], device=bins.device)
    one = torch.ones((), dtype=torch.float32, device=bins.device)
    return torch.where(idx == best.unsqueeze(-1), 0.0 * one, one)


def log_distance(bins: torch.Tensor, true_wait: torch.Tensor
                 ) -> torch.Tensor:
    """Shaped loss in [0,1]: normalized |log a − log w|. Beyond-paper."""
    d = torch.abs(_log_dist(bins, true_wait))
    return torch.clamp(d / xla_f32.log(bins[-1] / bins[0]), 0.0, 1.0)


def asymmetric(bins: torch.Tensor, true_wait: torch.Tensor,
               under_weight: float = 1.0, over_weight: float = 0.5
               ) -> torch.Tensor:
    """Beyond-paper: under-estimation weighted above over-estimation."""
    d = _log_dist(bins, true_wait)
    scale = xla_f32.log(bins[-1] / bins[0])
    shaped = torch.where(d < 0, under_weight * (-d) / scale,
                         over_weight * d / scale)
    return torch.clamp(shaped, 0.0, 1.0)


LOSSES = {
    "zero_one": zero_one,
    "log_distance": log_distance,
    "asymmetric": asymmetric,
}

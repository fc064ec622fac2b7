"""Observation featurizer of the learned submission policy (port of
``repro.rl.features``).

``observe`` reads one stage's slice of every lane of a batched
``ScenarioState``, with each lane's live Algorithm-1 posterior, into a
``(B, N_FEATURES)`` float32 tensor. The fleet simulator's chain hook
calls it (policy id 4) at the instants ASA would draw a wait estimate.
Everything is indexing and reduction over a lane's own row, so the
features of a lane depend on nothing else in the batch.

Times and durations are log-compressed to the §4.3 wait-bin range
(``log1p(x)/log1p(1e5)``), fractions are already in [0, 1], and the
posterior entropy is normalized by ``log m``: every feature is O(1), so
the policy head needs no input whitening.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import asa
from repro_torch.core.bins import MAX_WAIT_SECONDS
from repro_torch.xsim.state import QUEUED, RL_FEATURES, RUNNING, ScenarioState

N_FEATURES = RL_FEATURES

FEATURE_NAMES = (
    "bias",              # constant 1
    "free_frac",         # free cores / machine size
    "queue_depth",       # queued jobs / table size
    "queued_work",       # queued core demand / machine size (capped at 4x)
    "running_frac",      # running jobs / table size
    "stage_cores",       # this stage's width / machine size
    "stage_duration",    # log1p(t_y) / log1p(1e5)
    "stage_index",       # y / max_stages
    "pred_eta",          # log1p(max(E_prev - now, 0)) / log1p(1e5)
    "map_wait",          # log1p(posterior MAP wait) / log1p(1e5)
    "expected_wait",     # log1p(posterior mean wait) / log1p(1e5)
    "entropy",           # posterior entropy / log m
)
assert len(FEATURE_NAMES) == N_FEATURES

# log1p(1e5) rounded to float32, as the reference computes it
_LOG_SCALE = float(np.log1p(np.float32(MAX_WAIT_SECONDS)))


def _logt(x: torch.Tensor) -> torch.Tensor:
    """Compress a nonnegative time or duration to about [0, 1]."""
    return torch.log1p(torch.clamp_min(x, 0.0)) / _LOG_SCALE


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b]] for a (B, K) tensor and (B,) indices."""
    return torch.gather(x, 1, idx.long().unsqueeze(1)).squeeze(1)


def observe(s: ScenarioState, stage: torch.Tensor, row: torch.Tensor,
            pred_ee: torch.Tensor, now: torch.Tensor,
            bins: torch.Tensor) -> torch.Tensor:
    """Featurize stage ``stage`` (job-table row ``row``) of every lane at
    time ``now``; all four are ``(B,)``.

    ``pred_ee`` is the predecessor chain's expected end E_{y-1} (-inf for
    stage 0, where the time-to-predecessor feature reads 0). ``row`` must
    be clipped to the table already."""
    queued = s.status == QUEUED
    running = s.status == RUNNING
    n = float(s.status.shape[1])
    m = s.est.log_p.shape[-1]
    post = asa.posterior_features(s.est, bins)
    log_m = float(np.log(np.float32(m)))   # log m in float32
    return torch.stack([
        torch.ones_like(s.free),
        s.free / s.total,
        queued.sum(dim=1, dtype=torch.int32) / n,
        torch.clamp_max(torch.where(queued, s.cores, 0.0).sum(dim=1)
                        / s.total, 4.0),
        running.sum(dim=1, dtype=torch.int32) / n,
        _take(s.cores, row) / s.total,
        _logt(_take(s.duration, row)),
        stage.to(torch.float32) / s.wf_rows.shape[1],
        _logt(pred_ee - now),
        _logt(post[:, 0]),
        _logt(post[:, 1]),
        post[:, 2] / log_m,
    ], dim=1)


"""The learned submission-policy head: a small MLP (port of
``repro.rl.policy``).

Maps ``(..., N_FEATURES)`` observations (``features.py``) to logits over
the m §4.3 wait bins; the sampled or greedy bin's value is the stage's
submit-lead-time a_y, used by the fleet simulator's §3.2 cascade where
ASA's estimator draw would be (``xsim.events._chain_hook``, policy id 4).

``PolicyParams`` is a NamedTuple of float32 tensors. Its draws come from
the port's threefry stream (``core.prng``) under an explicit key, never
from the global torch generator. The products are plain ``torch.matmul``:
the reference computes them outside any Pallas kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import prng
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.rl.features import N_FEATURES
from repro_torch.xsim.state import M_BINS

HIDDEN_DEFAULT = 32


class PolicyParams(NamedTuple):
    """MLP weights: obs -> tanh hidden -> wait-bin logits."""

    w1: torch.Tensor  # f32 (n_features, hidden)
    b1: torch.Tensor  # f32 (hidden,)
    w2: torch.Tensor  # f32 (hidden, m)
    b2: torch.Tensor  # f32 (m,)


def init_params(key: torch.Tensor, n_features: int = N_FEATURES,
                hidden: int = HIDDEN_DEFAULT, m: int = M_BINS,
                scale: float = 0.1, *,
                device: str | torch.device = DEFAULT_DEVICE) -> PolicyParams:
    """Small-random init on ``device``; the zero output bias starts the
    head near the uniform distribution over bins (maximum-entropy
    exploration)."""
    dev = resolve_device(device)
    k1, k2 = prng.split(key.to(dev)).unbind(0)
    return PolicyParams(
        w1=scale * prng.normal(k1, (n_features, hidden)),
        b1=torch.zeros(hidden, dtype=torch.float32, device=dev),
        w2=scale * prng.normal(k2, (hidden, m)),
        b2=torch.zeros(m, dtype=torch.float32, device=dev),
    )


def n_params(params: PolicyParams) -> int:
    return sum(p.numel() for p in params)


def logits(params: PolicyParams, obs: torch.Tensor) -> torch.Tensor:
    """(.., n_features) observations -> (.., m) wait-bin logits."""
    h = torch.tanh(obs @ params.w1 + params.b1)
    return h @ params.w2 + params.b2


def act_sample(params: PolicyParams, obs: torch.Tensor,
               key: torch.Tensor) -> torch.Tensor:
    """Stochastic action (training rollouts): a ~ softmax(logits).

    A single ``(2,)`` key draws every row's Gumbel noise from one stream,
    as ``jax.random.categorical`` does for batched logits; a ``(B, 2)``
    batch of keys draws row b from key b, as the reference does under
    ``vmap`` (the fleet simulator's lanes)."""
    lg = logits(params, obs)
    if key.dim() == 1:
        return torch.argmax(prng.gumbel(key, tuple(lg.shape)) + lg, dim=-1)
    return prng.categorical(key, lg)


def act_greedy(params: PolicyParams, obs: torch.Tensor) -> torch.Tensor:
    """Deterministic action (evaluation): argmax of the logits."""
    return torch.argmax(logits(params, obs), dim=-1)


def log_prob(params: PolicyParams, obs: torch.Tensor,
             action: torch.Tensor) -> torch.Tensor:
    """log pi(action | obs) for (.., n_features) obs and (..,) actions."""
    lp = torch.log_softmax(logits(params, obs), dim=-1)
    return torch.gather(lp, -1, action.long().unsqueeze(-1)).squeeze(-1)

"""ASA — Algorithm 1 (paper §3.2) on torch tensors (port of
``repro.core.asa``).

The estimator keeps a distribution ``p ∈ Δ^m`` over ``m`` candidate
queue waits, in log space. A round accumulates the per-action loss
vector ``ℓ``; once ``max_a ℓ_a > 1`` the multiplicative update
``p ∝ exp(−γ ℓ) · p`` closes the round.

Every function takes a state whose fields carry any leading batch dims
(``log_p`` is ``(..., m)``, ``key`` is ``(..., 2)``, the counters
``(...)``): where the reference ``vmap``s, the port passes a batch. Each
``lax.cond`` of the reference is a masked update here: both branches are
computed and a lane takes the new value, its PRNG key included, only
where its predicate holds, so the key-consumption order per lane is the
reference's call for call.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import prng, xla_f32
from repro_torch.core.losses import zero_one


class ASAState(NamedTuple):
    """Functional state of one ASA estimator (or a batch of them)."""

    log_p: torch.Tensor       # f32 (..., m) log of the action distribution
    round_loss: torch.Tensor  # f32 (..., m) ℓ_t accumulated this round
    rounds: torch.Tensor      # i32 (...)  η(t): completed rounds
    t: torch.Tensor           # i32 (...)  total number of cases seen
    key: torch.Tensor         # i64 (..., 2) uint32-valued PRNG key

    @property
    def p(self) -> torch.Tensor:
        return xla_f32.exp(self.log_p)


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a float32 tensor on ``like``'s device. A Python number is
    written by a fill kernel: a copy from host memory would synchronise
    the stream inside every event step."""
    if isinstance(x, torch.Tensor):
        return x.to(device=like.device, dtype=torch.float32)
    return torch.full((), x, dtype=torch.float32, device=like.device)


def _over_50(g: torch.Tensor) -> torch.Tensor:
    """γ/50 as the reference's jitted step computes it: XLA rewrites the
    division by a constant as a product with its float32 reciprocal."""
    return g * _f32(1 / 50, g)


def select(pred: torch.Tensor, new: ASAState, old: ASAState) -> ASAState:
    """Per-lane ``where(pred, new, old)`` over every field (``pred`` has the
    state's batch shape)."""
    def pick(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        p = pred.reshape(pred.shape + (1,) * (a.dim() - pred.dim()))
        return torch.where(p, a, b)
    return ASAState(*(pick(a, b) for a, b in zip(new, old)))


def init(m: int, key: torch.Tensor) -> ASAState:
    """Initialise ``p_0 = 1/m`` (Algorithm 1, Require line); the batch
    shape is the key's leading shape."""
    batch = key.shape[:-1]
    dev = key.device
    log_m = xla_f32.log(torch.full((), float(m), dtype=torch.float32,
                                   device=dev))
    return ASAState(
        log_p=(-log_m).expand(batch + (m,)).clone(),
        round_loss=torch.zeros(batch + (m,), dtype=torch.float32, device=dev),
        rounds=torch.zeros(batch, dtype=torch.int32, device=dev),
        t=torch.zeros(batch, dtype=torch.int32, device=dev),
        key=key.clone(),
    )


def sample_action(state: ASAState) -> tuple[ASAState, torch.Tensor]:
    """Line 4: sample an action index ``a ~ p_t`` (splits the key)."""
    ks = prng.split(state.key)
    a = prng.categorical(ks[..., 1, :], state.log_p)
    return state._replace(key=ks[..., 0, :]), a


def gamma_constant(t, value: float = 1.0) -> torch.Tensor:
    """γ_t = ``value``: a float32 0-d tensor (on ``t``'s device when ``t``
    is a tensor)."""
    dev = t.device if isinstance(t, torch.Tensor) else None
    return torch.full((), value, dtype=torch.float32, device=dev)


def gamma_sqrt(t, m: int, scale: float = 1.0) -> torch.Tensor:
    """Non-increasing γ_t = scale · sqrt(ln m / (t+1)), in float32 —
    Appendix-A friendly. ln m is XLA's float32 value (``xla_f32.log``);
    the quotient, root and product are float32 on ``t``'s device, each
    correctly rounded as XLA rounds them (the root is taken in float64
    and rounded once: torch's float32 ``sqrt`` on the CPU is not
    correctly rounded)."""
    t = torch.as_tensor(t).to(torch.float32)
    log_m = xla_f32.log(torch.full((), float(m), dtype=torch.float32,
                                   device=t.device))
    return scale * torch.sqrt((log_m / (t + 1.0)).double()).float()


def greedy_action(state: ASAState) -> torch.Tensor:
    """The current best action (the first on a tie)."""
    return torch.argmax(state.log_p, dim=-1)


def _renormalize(log_p: torch.Tensor) -> torch.Tensor:
    """log_p − logsumexp(log_p), with the bits of the reference's."""
    return log_p - xla_f32.logsumexp(log_p, dim=-1, keepdim=True)


def apply_round_update(state: ASAState, gamma) -> ASAState:
    """Line 7: p ← e^{−γ ℓ} p / N, reset ℓ, close the round. log_p − γ·ℓ
    is one rounding, as XLA fuses it (a plain subtraction where ``gamma``
    is the number 1)."""
    if isinstance(gamma, (int, float)) and gamma == 1:
        log_p = state.log_p - state.round_loss
    else:
        log_p = xla_f32.fma(-_f32(gamma, state.log_p), state.round_loss,
                            state.log_p)
    return state._replace(
        log_p=_renormalize(log_p),
        round_loss=torch.zeros_like(state.round_loss),
        rounds=state.rounds + 1,
    )


def observe(state: ASAState, action: torch.Tensor, loss: torch.Tensor,
            gamma) -> ASAState:
    """Lines 5–7: ℓ_a += loss; close the round once ``max ℓ > 1``."""
    loss = torch.as_tensor(loss, dtype=torch.float32,
                           device=state.log_p.device)
    round_loss = state.round_loss.scatter_add(
        -1, action.unsqueeze(-1),
        loss.expand(action.shape).unsqueeze(-1))
    state = state._replace(round_loss=round_loss, t=state.t + 1)
    round_over = torch.amax(round_loss, dim=-1) > 1.0
    return select(round_over, apply_round_update(state, gamma), state)


def observe_full(state: ASAState, loss_vector: torch.Tensor, gamma,
                 repetitions: int = 1) -> ASAState:
    """Tuned policy (§4.5): apply the full-information loss vector
    ``repetitions`` times in one multiplicative update. log_p −
    (γ·ℓ)·repetitions rounds once after γ·ℓ, as XLA fuses it (a plain
    subtraction for one repetition, where the product is exact)."""
    g = _f32(gamma, state.log_p)
    gl = g * loss_vector.to(torch.float32)
    log_p = (state.log_p - gl if repetitions == 1
             else xla_f32.fma(-gl, float(repetitions), state.log_p))
    return state._replace(
        log_p=_renormalize(log_p),
        t=state.t + 1,
        rounds=state.rounds + 1,
    )


def expected_wait(state: ASAState, bins: torch.Tensor) -> torch.Tensor:
    """Posterior-mean waiting-time estimate ⟨p, θ⟩."""
    return torch.sum(state.p * bins.to(torch.float32), dim=-1)


def map_wait(state: ASAState, bins: torch.Tensor) -> torch.Tensor:
    """Maximum-a-posteriori estimate (the bin ASA acts on greedily)."""
    return bins[torch.argmax(state.log_p, dim=-1)]


def posterior_features(state: ASAState, bins: torch.Tensor) -> torch.Tensor:
    """``[map_wait, expected_wait, entropy]`` of the live posterior."""
    p = xla_f32.exp(state.log_p)
    entropy = -torch.sum(p * state.log_p, dim=-1)
    b = bins.to(torch.float32)
    return torch.stack([map_wait(state, b), expected_wait(state, b),
                        entropy], dim=-1)


def step(state: ASAState, loss_vector: torch.Tensor, gamma, *,
         policy: str = "default", repetitions: int = 50
         ) -> tuple[ASAState, torch.Tensor]:
    """One ASA decision: pick an action, incur its loss, learn."""
    def chosen(a: torch.Tensor) -> torch.Tensor:
        return torch.gather(loss_vector, -1, a.unsqueeze(-1)).squeeze(-1)

    if policy == "greedy":
        a = greedy_action(state)
        state = observe(state, a, chosen(a), gamma)
    elif policy == "default":
        state, a = sample_action(state)
        state = observe(state, a, chosen(a), gamma)
    elif policy == "tuned":
        state, a = sample_action(state)
        state = observe(state, a, chosen(a), gamma)
        state = observe_full(state, loss_vector,
                             _over_50(_f32(gamma, state.log_p)), repetitions)
    else:
        raise ValueError(f"unknown policy {policy!r}")
    return state, a


def sample_wait_if(state: ASAState, bins: torch.Tensor, do: torch.Tensor,
                   greedy: torch.Tensor | bool = False
                   ) -> tuple[ASAState, torch.Tensor]:
    """Draw a waiting-time estimate where ``do`` holds, 0 elsewhere.

    ``greedy=False``: the line-4 categorical draw; the key advances only
    in lanes where ``do`` holds. ``greedy=True``: the current MAP wait, no
    key consumed. A tensor ``greedy`` selects per lane."""
    b = bins.to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=b.device)
    w_map = b[greedy_action(state)]
    if greedy is True:
        return state, torch.where(do, w_map, zero)
    drawn, a = sample_action(state)
    if greedy is False:
        take, w = do, b[a]
    else:
        take, w = do & ~greedy, torch.where(greedy, w_map, b[a])
    return select(take, drawn, state), torch.where(do, w, zero)


def learn_wait_if(state: ASAState, bins: torch.Tensor,
                  true_wait: torch.Tensor, do: torch.Tensor,
                  gamma: float = 1.0) -> ASAState:
    """One within-run learning event (the tuned §4.5 ``step``) where
    ``do`` holds: sample, observe the chosen entry of the eq.-(3) loss at
    the observed wait, then the full-information sharpening pass."""
    b = bins.to(torch.float32)
    lv = zero_one(b, torch.clamp_min(true_wait.to(torch.float32), 1.0))
    g = _f32(gamma, b)
    s, a = sample_action(state)
    s = observe(s, a, torch.gather(lv, -1, a.unsqueeze(-1)).squeeze(-1),
                gamma)
    # the reference's γ is a constant of its jitted program, so XLA folds
    # (γ/50)·50 into one factor before the update
    s = observe_full(s, lv, _over_50(g) * 50.0, 1)
    return select(do, s, state)


def init_batch(m: int, n: int, key: torch.Tensor) -> ASAState:
    """A fleet of ``n`` independent estimators (one per job geometry)."""
    return init(m, prng.split(key, n))


def batched_step(state: ASAState, loss_vector: torch.Tensor, gamma
                 ) -> tuple[ASAState, torch.Tensor]:
    """``step`` (default policy) over a batch of estimators."""
    return step(state, loss_vector, gamma)

"""Theorem 1 (Appendix A): the regret bound ASA provably satisfies (the
port's own copy of ``repro.core.regret``, numpy only).

    Σ_{s≤t} ℓ_s(θ^{s−1}) − Σ_{s≤t} ℓ_s(θ̄)
        ≤ 4 η(t) + ln(m) + sqrt(2 t ln(m/δ))      w.p. ≥ 1 − δ

where η(t) is the number of adaptive mini-batches (rounds) the algorithm
created by time t. Property tests assert empirical regret stays under this
bound across random loss sequences.
"""

from __future__ import annotations

import numpy as np


def theorem1_bound(t: int, m: int, eta_t: int, delta: float = 0.05) -> float:
    if not (0.0 < delta < 1.0):
        raise ValueError("delta must be in (0, 1)")
    return 4.0 * eta_t + np.log(m) + np.sqrt(2.0 * t * np.log(m / delta))


def empirical_regret(chosen_losses: np.ndarray,
                     all_losses: np.ndarray) -> float:
    """Regret vs the best *fixed* action in hindsight.

    chosen_losses: (T,) losses the algorithm actually incurred.
    all_losses:    (T, m) loss every action would have incurred per step.
    """
    best_fixed = float(np.min(np.sum(all_losses, axis=0)))
    return float(np.sum(chosen_losses)) - best_fixed

"""Wait-time discretization grid (paper §4.3). Own copy of the reference
module (numpy only), so the port imports nothing of ``repro``.

The paper sets ``m = 53`` alternatives covering queue waiting times up to
~28 hours (100k seconds): "multiples of 10's, 100's, 1k's, 10k's, and 100k
time intervals (in seconds), with higher number of alternatives assigned to
values 10's and 100's due to the higher queue waiting times variability
usually faced by smaller jobs".

We realize that as the grid

    10..90   step 10   (9 bins)       "10's"   — dense low range
    100..975 step 25   (36 bins)      "100's"  — densest range (small jobs)
    1k..9k   step 2k   (5 bins)       "1k's"
    10k..50k step 20k  (3 bins)       wait, see below

plus ``{10_000, 50_000, 100_000}`` for the heavy tail — 53 bins total.
Exact placement inside each decade is not specified by the paper; what the
paper pins down is (a) m == 53, (b) coverage to 1e5 s, (c) density skewed to
the 10s/100s decades. The grid below satisfies all three and is what every
experiment in this repo uses.
"""

from __future__ import annotations

import numpy as np

MAX_WAIT_SECONDS = 100_000.0  # ~28 h, max observed wait in both centers
M_DEFAULT = 53


def make_bins(m: int = M_DEFAULT) -> np.ndarray:
    """Return the ``m``-vector of candidate waiting times, in seconds.

    For the paper-default ``m == 53`` the grid is hand-shaped per §4.3.
    Other values of m use a log-spaced grid over [10, 1e5] (used by
    sensitivity tests and the hypothesis sweeps).
    """
    if m == 53:
        tens = np.arange(10.0, 100.0, 10.0)          # 9 bins:  10..90
        hundreds = np.arange(100.0, 1000.0, 25.0)    # 36 bins: 100..975
        thousands = np.array([1e3, 2e3, 4e3, 7e3])   # 4 bins
        tenk = np.array([1e4, 2e4, 5e4])             # 3 bins
        tail = np.array([1e5])                       # 1 bin
        grid = np.concatenate([tens, hundreds, thousands, tenk, tail])
        assert grid.shape == (53,), grid.shape
        return grid
    if m < 2:
        raise ValueError("need at least 2 alternatives")
    return np.logspace(np.log10(10.0), np.log10(MAX_WAIT_SECONDS), m)


def nearest_bin(bins: np.ndarray, wait_seconds) -> np.ndarray:
    """Index of the alternative closest (in log space) to a true wait."""
    w = np.maximum(np.asarray(wait_seconds, dtype=np.float64), 1e-9)
    d = np.abs(np.log(bins)[None, ...] - np.log(w)[..., None])
    return np.argmin(d, axis=-1)

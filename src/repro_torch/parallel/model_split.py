"""The ``model`` axis's compute split: where the positions' shares of a
layer meet (ROADMAP Queue 1 item 12(d)).

Under the reference's mesh every compute dimension (heads, d_ff,
experts, d_inner, the vocabulary) is split over ``model``, so each device
computes its share of a layer and collectives join the shares. The
port's training step does the same over a (data, model) mesh that one
process drives: a leaf that a spec splits over ``model`` reaches the
layers as ``Blocks`` (``parallel.sharding.SplitAtUse``), and a layer
computes each position's share from position j's blocks
(``shares``/``at``), position after position. The shares meet here:

* ``psum``: partial outputs (of ``wo``, ``w_down``, an expert's rows, a
  sum of squares) added across positions in position order, so the
  rounding is fixed and runs, restarts and ``remat`` policies stay
  bitwise among themselves; its backward hands each position the
  output's gradient;
* ``vocab_lookup`` and ``vocab_xent``: the embedding lookup over a table
  split over its vocabulary (zeros outside a position's range, summed)
  and the cross-entropy over logits split the same way (the max and the
  sum of exponentials across positions).

This module is the one place where positions exchange values: copies
between cards (item 12(e)) and one process a position (item 12(f)) turn
these sums into peer copies or ``torch.distributed`` collectives.
"""

from __future__ import annotations

from typing import Callable

import torch


class Blocks:
    """A leaf split over ``model`` as a layer uses it: ``block(j)`` is
    position j's block (its slice of dimension ``dim``, whole on every
    other axis) in ``dtype``, of ``n`` positions; ``whole()`` the leaf."""

    def __init__(self, n: int, dim: int, dtype: torch.dtype,
                 block: Callable[[int], torch.Tensor],
                 whole: Callable[[], torch.Tensor] | None = None):
        self.n, self.dim, self.dtype = n, dim, dtype
        self._block, self._whole = block, whole

    def block(self, j: int) -> torch.Tensor:
        return self._block(j)

    def whole(self) -> torch.Tensor:
        if self._whole is not None:
            return self._whole()
        return torch.cat([self.block(j) for j in range(self.n)], self.dim)

    def to(self, dtype: torch.dtype) -> "Blocks":
        """Itself: its blocks are in their use type already."""
        if dtype != self.dtype:
            raise ValueError(f"a leaf split at use in {self.dtype} was "
                             f"asked for in {dtype}")
        return self


def positions(leaf) -> int:
    """The positions ``leaf`` is split over (1 if it is a tensor)."""
    return leaf.n if isinstance(leaf, Blocks) else 1


def at(p: dict, j: int) -> dict:
    """Position j's parameters of a layer: each ``Blocks`` leaf's block j,
    gathered now; the other leaves as they are."""
    return {k: v.block(j) if isinstance(v, Blocks) else v
            for k, v in p.items()}


def whole(p: dict) -> dict:
    """``p`` with each ``Blocks`` leaf whole (a layer whose split leaves
    do not line up with its heads is computed whole)."""
    return {k: v.whole() if isinstance(v, Blocks) else v
            for k, v in p.items()}


def shares(n: int, share: Callable[[int], object]) -> list:
    """``[share(0), ..., share(n - 1)]``: the positions' shares, computed
    one after another in this process (one process a position, item
    12(f), runs each on its own)."""
    return [share(j) for j in range(n)]


def psum(parts: list) -> torch.Tensor:
    """The positions' partial values added in position order, ``((p0 +
    p1) + p2) + ...``; one part is returned as it is. The backward gives
    every part the sum's gradient."""
    if len(parts) == 1:
        return parts[0]
    return _Sum.apply(*parts)


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *parts):
        ctx.n_parts = len(parts)
        out = parts[0] + parts[1]
        for x in parts[2:]:
            out = out + x
        return out

    @staticmethod
    def backward(ctx, grad):
        return (grad,) * ctx.n_parts


def vocab_lookup(table: Blocks, tokens: torch.Tensor) -> torch.Tensor:
    """Rows ``tokens`` of an embedding table split over its vocabulary
    (dimension 0): position j looks up the tokens in its range and gives
    zeros for the others; the positions' rows are summed. Each row has
    one nonzero share, so the lookup is exact."""
    def share(j):
        t = table.block(j)
        v = t.shape[0]
        local = tokens - j * v
        inside = (local >= 0) & (local < v)
        rows = t[local.clamp(0, v - 1)]
        return torch.where(inside[..., None], rows, rows.new_zeros(()))

    return psum(shares(table.n, share))


def vocab_xent(blocks: list, labels: torch.Tensor) -> torch.Tensor:
    """The mean cross-entropy of ``labels`` under logits split over the
    vocabulary: ``blocks[j]`` (..., V_j) is position j's range, in order,
    its padding already masked, in the activation type. As
    ``log_softmax`` of the float32 logits: the max across positions
    (detached, as it cancels), each position's sum of exp(logit − max)
    added in position order, and the label's logit from the position
    that holds it; log p = (logit − max) − log(sum). Each block is taken
    to float32 inside its position's share, so no position's float32
    copy outlives it."""
    with torch.no_grad():
        m = blocks[0].amax(-1)
        for b in blocks[1:]:
            m = torch.maximum(m, b.amax(-1))
        m = m.float()[..., None]

    def sum_exp(j):
        return torch.exp(blocks[j].float() - m).sum(-1)

    def label_logit(j):
        lo = sum(b.shape[-1] for b in blocks[:j])
        v = blocks[j].shape[-1]
        local = labels.long() - lo
        inside = (local >= 0) & (local < v)
        got = torch.gather(blocks[j], -1,
                           local.clamp(0, v - 1)[..., None]).float() - m
        return torch.where(inside, got[..., 0], got.new_zeros(()))

    n = len(blocks)
    total = psum(shares(n, sum_exp))
    picked = psum(shares(n, label_logit))
    return -torch.mean(picked - torch.log(total))

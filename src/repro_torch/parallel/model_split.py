"""The ``model`` axis's compute split: where the positions' shares of a
layer meet (ROADMAP Queue 1 item 12(d)).

Under the reference's mesh every compute dimension (heads, d_ff,
experts, d_inner, the vocabulary) is split over ``model``, so each device
computes its share of a layer and collectives join the shares. The
port's training step does the same over a (data, model) mesh: a leaf
that a spec splits over ``model`` reaches the layers as ``Blocks``
(``parallel.sharding.SplitAtUse``), and a layer computes each position's
share from position j's blocks (``shares``/``at``). One process may
compute every position's share, one after another; on the mesh of a
process group (item 12(f), ``parallel.dist``) each process computes its
own position's alone (``on``). The shares meet here:

* ``shares`` hands the replicated values a share reads (its arguments)
  to the positions through one fan-out, whose backward adds the
  positions' gradients in position order: across processes that sum is
  an all-gather of the gradients, and in one process the same sum
  replaces autograd's own, so the two routes are bitwise by
  construction;
* ``psum``: partial outputs (of ``wo``, ``w_down``, an expert's rows, a
  sum of squares) added across positions in position order, so the
  rounding is fixed and runs, restarts and ``remat`` policies stay
  bitwise among themselves; its backward hands each position the
  output's gradient;
* ``cat``: per-position pieces (a scan's state, over heads) joined in
  position order;
* ``vocab_lookup`` and ``vocab_xent``: the embedding lookup over a table
  split over its vocabulary (zeros outside a position's range, summed)
  and the cross-entropy over logits split the same way (the max and the
  sum of exponentials across positions).

This module is the one place where ``model`` positions exchange values:
across processes each sum is ``dist.all_gather`` over the ``model``
subgroup followed by the same ordered sum; copies between cards (item
12(e)) would turn them into peer copies.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Callable

import torch

from repro_torch.parallel import dist

# the mesh groups (``dist.MeshGroups``) of this process while a step's
# loss and its backward run on a process group's mesh (``on``); None
# where one process computes every position
_HERE = None


@contextmanager
def on(groups):
    """Within: this process computes the shares of its own ``model``
    position (``groups.col``) alone, and the shares meet through
    ``groups.model`` (None: every position, in this process)."""
    global _HERE
    before, _HERE = _HERE, groups
    try:
        yield
    finally:
        _HERE = before


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


def shares(n: int, share: Callable, *args) -> list:
    """``[share(0, *args), ..., share(n - 1, *args)]``: the positions'
    shares. ``args`` are the replicated values a share reads (trees of
    dicts, tuples and tensors; ``Blocks`` and other leaves pass as they
    are): each tensor that autograd differentiates reaches the positions
    through one fan-out (``_FanOut``), whose backward adds their
    gradients in position order, so a share reads every such value
    through its arguments. Under ``on`` this process computes its own
    position's share alone, its tensors fanned out by ``_Replicated``
    (whose backward all-gathers the positions' gradients and adds them
    in the same order), and the other entries are None (a tuple of Nones
    where a share returns a tuple)."""
    ts: list = []
    _tensors(args, ts)
    ts = [t for t in ts if t.requires_grad] if torch.is_grad_enabled() \
        else []
    if _HERE is None:
        outs = _FanOut.apply(n, *ts) if ts else ()
        k = len(ts)
        return [share(j, *_swap(args, ts, outs[j * k:(j + 1) * k]))
                for j in range(n)]
    j = _HERE.col
    outs = _Replicated.apply(_HERE.model, *ts) if ts else ()
    mine = share(j, *_swap(args, ts, outs))
    return [mine if i == j else _absent(mine) for i in range(n)]


def _tensors(tree, out: list) -> None:
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tensors(v, out)


def _swap(tree, old: list, new):
    """``tree`` with each tensor of ``old`` (by identity) replaced by its
    counterpart in ``new``."""
    by_id = {id(t): u for t, u in zip(old, new)}

    def go(x):
        if isinstance(x, torch.Tensor):
            return by_id.get(id(x), x)
        if isinstance(x, dict):
            return {k: go(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(go(v) for v in x)
        return x

    return go(tree)


def _absent(share):
    """What stands for another process's share: None, or a tuple of them
    shaped as ``share``."""
    if isinstance(share, tuple):
        return tuple(_absent(x) for x in share)
    return None


def _ordered_sum(parts):
    out = parts[0]
    for x in parts[1:]:
        out = out + x
    return out


class _FanOut(torch.autograd.Function):
    """``_FanOut.apply(n, *xs)``: each x handed to n positions (views of
    it, position-major); the backward adds an x's n gradients in
    position order."""

    @staticmethod
    def forward(ctx, n, *xs):
        ctx.n, ctx.k = n, len(xs)
        return tuple(x.view_as(x) for _ in range(n) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        k = ctx.k
        return (None, *(_ordered_sum(grads[i::k]) for i in range(k)))


class _Replicated(torch.autograd.Function):
    """``_Replicated.apply(group, *xs)``: the fan-out of one process of a
    process group's mesh. The forward hands each x to its own position
    (a view); the backward all-gathers each gradient over the ``model``
    subgroup ``group`` and adds the positions' in position order, as
    ``_FanOut`` does in one process."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *(_ordered_sum(dist.all_gather(g, ctx.group))
                        for g in grads))


def own(parts: list):
    """The part of ``parts`` (a list in position order, as ``shares``
    returns it) that this process computed: its own position's under
    ``on``, else position 0's."""
    return parts[0 if _HERE is None else _HERE.col]


def each(parts: list, fn: Callable) -> list:
    """``fn`` over each part this process holds (None stays None)."""
    return [None if x is None else fn(x) for x in parts]


def psum(parts: list) -> torch.Tensor:
    """The positions' partial values added in position order, ``((p0 +
    p1) + p2) + ...``; one part is returned as it is. The backward gives
    every part the sum's gradient. Under ``on``: the own part
    all-gathered over the ``model`` subgroup, then the same sum."""
    if _HERE is not None:
        return _DistSum.apply(_HERE.model, own(parts))
    if len(parts) == 1:
        return parts[0]
    return _Sum.apply(*parts)


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *parts):
        ctx.n_parts = len(parts)
        return _ordered_sum(parts)

    @staticmethod
    def backward(ctx, grad):
        return (grad,) * ctx.n_parts


class _DistSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, part):
        return _ordered_sum(dist.all_gather(part, group))

    @staticmethod
    def backward(ctx, grad):
        return None, grad


def cat(parts: list, dim: int) -> torch.Tensor:
    """The positions' pieces joined along ``dim`` in position order.
    Under ``on``: the own piece all-gathered over the ``model``
    subgroup; the backward hands it its slice of the gradient."""
    if _HERE is None:
        return torch.cat(parts, dim)
    return _DistCat.apply(_HERE.model, dim, own(parts))


class _DistCat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, dim, piece):
        ctx.dim, ctx.index, ctx.width = dim, group.index, piece.shape[dim]
        return torch.cat(dist.all_gather(piece, group), dim)

    @staticmethod
    def backward(ctx, grad):
        return None, None, grad.narrow(ctx.dim, ctx.index * ctx.width,
                                       ctx.width)


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
    vocabulary: ``blocks[j]`` (..., V_j) is position j's range, in order
    and of equal widths, its padding already masked, in the activation
    type (under ``on``, the own position's alone). As ``log_softmax`` of
    the float32 logits: the max across positions (detached, as it
    cancels; under ``on`` the positions' maxima all-gathered), each
    position's sum of exp(logit − max) added in position order, and the
    label's logit from the position that holds it; log p = (logit − max)
    − log(sum). Each block is taken to float32 inside its position's
    share, so no position's float32 copy outlives it."""
    with torch.no_grad():
        maxes = ([b.amax(-1) for b in blocks] if _HERE is None
                 else dist.all_gather(own(blocks).amax(-1), _HERE.model))
        m = maxes[0]
        for x in maxes[1:]:
            m = torch.maximum(m, x)
        m = m.float()[..., None]

    def sum_exp(j):
        return torch.exp(blocks[j].float() - m).sum(-1)

    def label_logit(j):
        v = blocks[j].shape[-1]
        local = labels.long() - j * v
        inside = (local >= 0) & (local < v)
        got = torch.gather(blocks[j], -1,
                           local.clamp(0, v - 1)[..., None]).float() - m
        return torch.where(inside, got[..., 0], got.new_zeros(()))

    n = len(blocks)
    total = psum(shares(n, sum_exp))
    picked = psum(shares(n, label_logit))
    return -torch.mean(picked - torch.log(total))

"""AdamW + gradient clipping + cosine LR schedule (port of
``repro.train.optimizer``).

The state's m and v are float32 trees shaped like the parameters and
``step`` is an int32 0-d tensor, as the reference's (the checkpoint codec
stores int32 as it is). Everything the reference computes in float32 is
computed in float32 here: the bias corrections from a float32 step, the
cosine, the update; decoupled weight decay applies to leaves with
``ndim >= 2`` only. The global norm sums the leaves in the reference's
order (``jax.tree.leaves``: dict keys sorted).

``update`` writes the parameters, m and v IN PLACE under
``torch.no_grad()`` (the reference donates ``params`` and ``opt_state``
to its jitted step) and returns the same trees; its values are the
reference's. Nothing here reads a tensor back to the host.

A leaf may be a ``parallel.sharding.ShardedTensor`` (parameters split
over a mesh): ``init`` gives it m and v split the same way, and
``update`` takes its gradient split the same way (the step's block
accumulators, ``ShardedTensor.block_zeros``) and updates each shard in
place from its block's gradient. The update is elementwise once the clip
scale is known, so each shard's values are those of the unsplit leaf's
update, bit for bit; the global norm assembles one split gradient at a
time whole, so its sum is the unsplit leaf's too.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.parallel.sharding import ShardedTensor


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32, 0-d
    m: dict              # tree like params, float32
    v: dict


def leaves(tree) -> list[torch.Tensor]:
    """The tensors of a tree of dicts, lists and tuples, in the
    reference's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of trees shaped like it)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def init(params) -> AdamWState:
    def zeros(p):
        if isinstance(p, ShardedTensor):
            return p.map_shards(lambda x: torch.zeros_like(
                x, dtype=torch.float32))
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def cosine_lr(step: torch.Tensor, *, peak: float = 3e-4, warmup: int = 100,
              total: int = 10_000, floor: float = 3e-5) -> torch.Tensor:
    step = step.float()
    warm = peak * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + 0.5 * (peak - floor) * (1.0 + torch.cos(math.pi * prog))
    return torch.where(step < warmup, warm, cos)


def global_norm(tree) -> torch.Tensor:
    """The square root of the leaves' float32 sums of squares, added in
    tree order. A split leaf is assembled whole in float32 first, in one
    buffer that every split leaf reuses (one leaf is whole at a time): a
    sum over its blocks would round in another order."""
    xs = leaves(tree)
    split = [x for x in xs if isinstance(x, ShardedTensor)]
    if split:
        buf = torch.empty(max(x.numel() for x in split),
                          dtype=torch.float32, device=split[0].device)
    total = 0
    for x in xs:
        if isinstance(x, ShardedTensor):
            x = x.gather(out=buf[:x.numel()].view(x.shape))
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """-> (grads scaled to a global norm of at most ``max_norm``, the
    norm before). The scaled leaves are float32, as the reference's
    ``g * scale`` promotes a bfloat16 leaf."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), norm


@torch.no_grad()
def update(
    params,
    grads,
    state: AdamWState,
    *,
    lr=None,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    max_grad_norm: float = 1.0,
):
    """One AdamW step -> (params, AdamWState, grad norm before clipping);
    params, m and v are written in place."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, max_grad_norm)
    step = state.step + 1
    lr_t = cosine_lr(step) if lr is None else lr
    sf = step.float()
    bc1, bc2 = 1 - b1 ** sf, 1 - b2 ** sf
    hyper = dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    consts = {}     # the step's scalars on each device that a shard is on
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.m),
                          leaves(state.v)):
        if not isinstance(p, ShardedTensor):
            _adamw(p, g, m, v, scale, lr_t, bc1, bc2, **hyper)
            continue
        for gs, ps, ms, vs in zip(g.shards, p.shards, m.shards, v.shards):
            dev = ps.device
            if dev not in consts:
                consts[dev] = tuple(
                    c.to(dev) if isinstance(c, torch.Tensor) else c
                    for c in (scale, lr_t, bc1, bc2))
            _adamw(ps, gs.to(dev), ms, vs, *consts[dev], **hyper)
    return params, AdamWState(step=step, m=state.m, v=state.v), gnorm


def _adamw(p, g, m, v, scale, lr_t, bc1, bc2, *, b1, b2, eps,
           weight_decay) -> None:
    """One leaf's (or one shard's) AdamW update, in place."""
    g = g.float() * scale
    m.copy_(b1 * m + (1 - b1) * g)
    v.copy_(b2 * v + (1 - b2) * torch.square(g))
    delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
    # decoupled weight decay on matrices only (ndim >= 2)
    if p.dim() >= 2:
        delta = delta + weight_decay * p.float()
    p.copy_(p.float() - lr_t * delta)

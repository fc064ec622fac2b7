"""Batch-axis padding for batched states and query batches (port of
``repro.parallel.fleet``'s ``batch_size``, ``pad_batch`` and ``unpad``).

A batched tree is a tensor, or a tuple (NamedTuples included), list or
dict of batched trees, every tensor carrying the batch on its leading
axis; ``None`` leaves pass through. ``pad_batch`` pads the leading axis up
to a multiple of ``n_shards`` with copies of row 0 (a real, runnable row,
so pad rows never take another control path) and returns the validity
mask, a bool tensor on the batch's device. The serving loop pads each
query batch to its one dispatched shape this way.

``shard_spec``/``replicated_spec`` (the reference's ``PartitionSpec``s)
wait for the sharded paths, ROADMAP Queue 1 item 8(b).
"""

from __future__ import annotations

import torch


def _leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return []


def _tree_map(fn, tree):
    """``fn`` applied to every tensor of ``tree``, its containers kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def batch_size(tree) -> int:
    """Leading-axis length of a batched tree (it must hold a tensor)."""
    leaves = _leaves(tree)
    if not leaves:
        raise ValueError("batch_size: tree has no tensor leaves")
    return int(leaves[0].shape[0])


def pad_batch(tree, n_shards: int):
    """Pad ``tree``'s leading axis to a multiple of ``n_shards``.

    Pad rows are copies of row 0. Returns ``(padded_tree, mask)``, where
    ``mask`` is a ``(B_padded,)`` bool tensor on the batch's device marking
    the real rows; when no padding is needed the tree is returned as it
    is."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    b = batch_size(tree)
    pad = (-b) % n_shards
    dev = _leaves(tree)[0].device
    mask = torch.arange(b + pad, device=dev) < b
    if pad == 0:
        return tree, mask
    padded = _tree_map(
        lambda x: torch.cat([x, x[:1].expand((pad,) + x.shape[1:])]), tree)
    return padded, mask


def unpad(tree, n_real: int):
    """Slice a (possibly padded) batched tree back to ``n_real`` rows."""
    return _tree_map(lambda x: x[:n_real], tree)

"""Scenario-axis (fleet) data parallelism helpers (port of
``repro.parallel.fleet``).

A batched tree is a tensor, or a tuple (NamedTuples included), list or
dict of batched trees, every tensor carrying the batch on its leading
axis; ``None`` leaves pass through. ``pad_batch`` pads the leading axis up
to a multiple of ``n_shards`` with copies of row 0 (a real, runnable row,
so pad rows never take another control path) and returns the validity
mask, a bool tensor on the batch's device. The serving loop pads each
query batch to its one dispatched shape this way, and every sharded path
(``xsim.events.sharded_sweep``, ``xsim.compare.sharded_batched_metrics``,
``obs.metrics.sharded_sweep_summary``, ``serve.asa.serve_step(mesh=)``)
pads its batch to a multiple of the mesh's blocks. The pad rows land on
the last block; drained lanes step as exact no-ops, so they can lengthen
that block's sweep but never change its results.

``shard_spec``/``replicated_spec`` are the two ``PartitionSpec``s a fleet
sweep ever needs: the leading axis over the ``scenarios`` mesh axis, and
everything replicated (the policy head's weights, the tenant table).
"""

from __future__ import annotations

import torch

from repro_torch.parallel.sharding import PartitionSpec

SCENARIO_AXIS = "scenarios"


def shard_spec() -> PartitionSpec:
    """Leading axis on the ``scenarios`` mesh axis, rest replicated."""
    return PartitionSpec(SCENARIO_AXIS)


def replicated_spec() -> PartitionSpec:
    """Fully replicated (RL params, the serving table)."""
    return PartitionSpec()


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


def split(tree, devices) -> list:
    """A batched tree whose leading axis divides ``len(devices)`` cut into
    that many contiguous blocks, block ``i`` moved to ``devices[i]`` (the
    scatter of the reference's ``shard_spec``)."""
    b = batch_size(tree)
    k = len(devices)
    if b % k:
        raise ValueError(f"batch of {b} does not split into {k} blocks; "
                         "pad it first (pad_batch)")
    per = b // k
    return [_tree_map(lambda x, i=i, d=d: x[i * per:(i + 1) * per].to(d),
                      tree) for i, d in enumerate(devices)]


def replicate(tree, device: torch.device):
    """``tree`` on ``device`` (the reference's ``replicated_spec``): its
    tensors copied there, or the tree as it is where they lie there."""
    return _tree_map(lambda x: x.to(device), tree)


def gather(blocks: list, device: torch.device):
    """The blocks' trees joined along the leading axis in mesh order, on
    ``device`` (the gather of the reference's ``shard_spec`` output)."""
    first = blocks[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([x.to(device) for x in blocks])
    if isinstance(first, dict):
        return {k: gather([x[k] for x in blocks], device) for k in first}
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(gather(list(xs), device)
                             for xs in zip(*blocks)))
    if isinstance(first, (tuple, list)):
        return type(first)(gather(list(xs), device) for xs in zip(*blocks))
    return first

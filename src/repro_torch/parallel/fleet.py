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

``split`` and ``gather`` take a ``launch.mesh.ScenariosMesh`` (or a
sequence of devices). On the mesh of a process group (``mesh.groups``)
``split`` hands this rank its own block alone and ``gather``
all-gathers the ranks' blocks (``all_gather_tree``) and
joins them in mesh order, so every rank holds the whole result, as the
one-process route's gather would; a caller runs the blocks that
``blocks`` names, each on its device.

``shard_spec``/``replicated_spec`` are the two ``PartitionSpec``s a fleet
sweep ever needs: the leading axis over the ``scenarios`` mesh axis, and
everything replicated (the policy head's weights, the tenant table).
"""

from __future__ import annotations

import torch

from repro_torch.parallel import dist
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


def blocks(where) -> list[tuple[int, torch.device]]:
    """(index, device) of each block this process runs: every block of a
    mesh (or of a sequence of devices), or on a process group's mesh its
    own block alone."""
    devices = getattr(where, "devices", where)
    group = getattr(where, "groups", None)
    ids = range(len(devices)) if group is None else (group.index,)
    return [(i, torch.device(devices[i])) for i in ids]


def split(tree, where) -> list:
    """A batched tree whose leading axis divides the number of blocks of
    ``where`` (a ``ScenariosMesh`` or a sequence of devices) cut into that
    many contiguous blocks, block ``i`` moved to device ``i`` (the scatter
    of the reference's ``shard_spec``): those of ``blocks(where)``, in
    order."""
    b = batch_size(tree)
    k = len(getattr(where, "devices", where))
    if b % k:
        raise ValueError(f"batch of {b} does not split into {k} blocks; "
                         "pad it first (pad_batch)")
    per = b // k
    return [_tree_map(lambda x, i=i, d=d: x[i * per:(i + 1) * per].to(d),
                      tree) for i, d in blocks(where)]


def replicate(tree, device: torch.device):
    """``tree`` on ``device`` (the reference's ``replicated_spec``): its
    tensors copied there, or the tree as it is where they lie there."""
    return _tree_map(lambda x: x.to(device), tree)


def gather(outs: list, device: torch.device, mesh=None):
    """The blocks' trees joined along the leading axis in mesh order, on
    ``device`` (the gather of the reference's ``shard_spec`` output). On a
    process group's ``mesh`` ``outs`` is this rank's block alone, and
    every rank's block comes from an all-gather."""
    group = getattr(mesh, "groups", None)
    if group is not None:
        (own,) = outs
        outs = all_gather_tree(own, group)
    return _join(outs, device)


def all_gather_tree(tree, group) -> list:
    """Every member's ``tree`` (of one structure, shapes and dtypes on
    each), in position order, on the devices of ``tree``'s tensors: one
    all-gather of all its tensors (``parallel.dist.all_gather_many``)."""
    leaves: list = []
    _tree_map(leaves.append, tree)
    return [_tree_map(lambda _, it=iter(got): next(it), tree)
            for got in dist.all_gather_many(leaves, group)]


def _join(outs: list, device: torch.device):
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([x.to(device) for x in outs])
    if isinstance(first, dict):
        return {k: _join([x[k] for x in outs], device) for k in first}
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_join(list(xs), device) for xs in zip(*outs)))
    if isinstance(first, (tuple, list)):
        return type(first)(_join(list(xs), device) for xs in zip(*outs))
    return first

"""Divisibility-aware FSDP × TP × EP sharding rules, the spec side (port
of ``repro.parallel.sharding``).

Mesh axes:
  * ``model``          — tensor/expert parallel (16-way on the target pod)
  * ``data``           — data + ZeRO-3 (FSDP) parameter sharding
  * ``pod`` (optional) — multi-pod extension of the data/FSDP dimension

Every parameter shards its *compute* dim (heads / d_ff / experts / d_inner)
over ``model`` and its d_model (or vocab) dim over the FSDP axes — each only
when divisible, else that dim is replicated (e.g. gemma-2b's 8 heads on a
16-way model axis fall back to replicated heads, TP then comes from its
16384-wide d_ff). Stacked-layer params get a leading ``None`` for the L dim.

The rules are name-pattern driven over the parameter tree's paths, with a
size-checked fallback. A mesh here is anything with ``axis_names`` and a
``shape`` dict (axis name → extent); the specs are the port's own
``PartitionSpec``, which prints, compares and iterates as the
reference's.

Placement: ``tree_shardings`` pairs each leaf's spec with the mesh
(``NamedSharding``) and ``device_put`` places a tensor by it. Where every
mesh axis that the spec names has extent 1 (a one-device mesh: one card,
or the CPU), the leaf moves whole to the mesh's device
(``launch.mesh.DeviceMesh.device``). A spec that splits a leaf over an
axis of extent > 1 gives a ``ShardedTensor``: the global shape and dtype,
the sharding, and one local shard a mesh position, on that position's
device, in the order of jax's ``addressable_shards`` (the mesh's devices
flattened); positions that the spec replicates hold equal copies. One
process may drive every position, as the reference's ``jit`` drives
every device of its host; a mesh may repeat a device (``launch.mesh``),
so the split runs on one card or on the CPU too. On the mesh of a
process group (``DeviceMesh.groups``, ``parallel.dist``) each process is
one position and its ``ShardedTensor`` holds only that position's shard
(``local``): a gather takes the other positions' blocks from
``dist.all_gather``, over the FSDP subgroup where the blocks lie in this
rank's ``model`` column, else over every rank. ``train.step.make_train_step``
trains on such trees, a microbatch each of ``data_rows``, reading each
split leaf through ``SplitAtUse``: gathered at use (a stacked leaf a
layer at a time) by ``GatherFn``, whose backward is the reduce-scatter.
The per-position plan (``model_dim``) names the leaves whose spec splits
a compute dimension over ``model``; ``SplitAtUse`` hands each ``model``
position its block of such a leaf (``model_split.Blocks``), gathered
over the FSDP axes only, and the layers compute a position's share at a
time (``parallel.model_split``).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.parallel import dist
from repro_torch.parallel import model_split as MS


class PartitionSpec(tuple):
    """One mesh axis (a name), several (a tuple of names) or ``None`` per
    dimension. A one-name tuple is kept as the bare name, as the
    reference's ``PartitionSpec`` keeps it, so ``P(None, ("data",))``
    prints, compares and iterates as ``P(None, "data")``."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(
            p[0] if isinstance(p, tuple) and len(p) == 1 else p
            for p in parts))

    def __repr__(self) -> str:
        return "PartitionSpec" + tuple.__repr__(self)

    __str__ = __repr__


P = PartitionSpec


@dataclass(frozen=True)
class NamedSharding:
    """A leaf's ``PartitionSpec`` on a mesh."""
    mesh: object
    spec: PartitionSpec

    def shard_shape(self, global_shape) -> tuple[int, ...]:
        """One device's local shape of a leaf of ``global_shape``: each
        dimension divided by the extents of the axes that split it (as
        ``jax.sharding.NamedSharding.shard_shape``; raises where an
        extent does not divide the dimension)."""
        out = []
        for i, dim in enumerate(global_shape):
            part = self.spec[i] if i < len(self.spec) else None
            n = axis_size(self.mesh, part)
            if dim % n:
                raise ValueError(f"dimension {i} of {tuple(global_shape)} is "
                                 f"not divisible by {n} ({self.spec})")
            out.append(dim // n)
        return tuple(out)


    def shard_indices(self, global_shape) -> list[tuple[slice, ...]]:
        """The index of each mesh position's shard in a leaf of
        ``global_shape``, in the mesh's flat device order (as
        ``jax.sharding.NamedSharding.devices_indices_map``): along a
        dimension split over axes (a, b, ...) a position's block is its
        coordinates on those axes read as one number, ``a`` major."""
        shard = self.shard_shape(global_shape)
        names = list(self.mesh.axis_names)
        grid = tuple(self.mesh.shape[a] for a in names)
        out = []
        for pos in np.ndindex(grid):
            index = []
            for i, n in enumerate(shard):
                part = self.spec[i] if i < len(self.spec) else None
                block = 0
                for a in (() if part is None else (part,)
                          if isinstance(part, str) else part):
                    block = block * self.mesh.shape[a] + pos[names.index(a)]
                index.append(slice(block * n, (block + 1) * n))
            out.append(tuple(index))
        return out


class ShardedTensor:
    """A leaf split over a mesh: ``shape`` and ``dtype`` are the global
    leaf's, ``shards[i]`` is mesh position i's local block (its index
    ``indices[i]``, on ``sharding.mesh.devices.flat[i]``). On the mesh of
    a process group ``local`` is this process's position and ``shards``
    holds its shard alone; ``local`` is None where one process holds
    every position."""

    def __init__(self, shards, sharding: NamedSharding, shape,
                 dtype: torch.dtype):
        self.shards = tuple(shards)
        self.sharding = sharding
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.indices = sharding.shard_indices(self.shape)
        # the distinct blocks, each by the first position that holds it
        # (``firsts``), and each position's block (``block_of``)
        blocks: dict = {}
        self.block_of = tuple(
            blocks.setdefault(tuple((s.start, s.stop) for s in index),
                              len(blocks)) for index in self.indices)
        self.firsts = tuple(self.block_of.index(b)
                            for b in range(len(blocks)))
        groups = getattr(sharding.mesh, "groups", None)
        self.local = None if groups is None else groups.rank

    @property
    def device(self) -> torch.device:
        """The mesh's first device (where a gather lands by default)."""
        return self.sharding.mesh.device

    def numel(self) -> int:
        return self.shape.numel()

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={tuple(self.shape)}, dtype={self.dtype}"
                f", spec={self.sharding.spec}, shards={len(self.shards)})")

    def blocks(self) -> list[torch.Tensor]:
        """The distinct blocks, each the shard of the first position that
        holds it (``indices[firsts[b]]`` is block b's index)."""
        if self.local is not None:
            raise ValueError("a process holds its own shard only")
        return [self.shards[k] for k in self.firsts]

    def gather(self, device=None, dtype: torch.dtype | None = None,
               out: torch.Tensor | None = None) -> torch.Tensor:
        """The global tensor on ``device`` (default: the mesh's first),
        each shard cast to ``dtype`` first if given: bitwise the leaf that
        was split. Each block is read from the first position that holds
        it (on a process group's mesh, through ``dist.all_gather``: every
        rank calls it). ``out``, if given, is written and returned."""
        if out is None:
            out = torch.empty(self.shape, dtype=dtype or self.dtype,
                              device=self.device if device is None
                              else device)
        if self.local is not None:
            fetch = _Fetch(self, dtype or self.dtype,
                           range(len(self.firsts)))
            for k, block in zip(self.firsts, fetch()):
                out[self.indices[k]].copy_(block)
            return out
        for k in self.firsts:
            shard = self.shards[k]
            out[self.indices[k]].copy_(shard if dtype is None
                                       else shard.to(dtype))
        return out

    def gather_on(self, root: int = 0) -> torch.Tensor | None:
        """On a process group's mesh: the global tensor on rank ``root``
        (on the host; None on the other ranks), through
        ``dist.gather``; every rank calls it."""
        groups = self.sharding.mesh.groups
        got = dist.gather(self.shards[0], groups.world, root)
        if got is None:
            return None
        out = torch.empty(self.shape, dtype=self.dtype)
        for k in self.firsts:
            out[self.indices[k]].copy_(got[k])
        return out

    def map_shards(self, fn) -> "ShardedTensor":
        """``fn`` over every shard (elementwise: the shape is kept)."""
        shards = [fn(x) for x in self.shards]
        return ShardedTensor(shards, self.sharding, self.shape,
                             shards[0].dtype)

    def block_zeros(self, dtype: torch.dtype) -> "ShardedTensor":
        """Zeros of ``dtype`` split as this leaf, one tensor a distinct
        block: the positions that hold a block share its tensor (a
        gradient accumulator; see ``blocks``). On a process group's mesh,
        the own shard's zeros."""
        if self.local is not None:
            return ShardedTensor([self.shards[0].new_zeros(
                self.shards[0].shape, dtype=dtype)], self.sharding,
                self.shape, dtype)
        zeros = [x.new_zeros(x.shape, dtype=dtype) for x in self.blocks()]
        return ShardedTensor([zeros[b] for b in self.block_of],
                             self.sharding, self.shape, dtype)


# ------------------------------------------------ gathered at use
#
# The training step over a split tree (``train.step``) reads a split leaf
# through ``SplitAtUse``: its distinct blocks stand behind autograd
# leaves, and ``GatherFn`` gathers them where the loss uses them. Its
# backward gives each block its part of the gradient: the reduce-scatter
# of a mesh that one process drives. A stacked leaf is gathered one
# layer at a time (``models.lm.layer``), and under ``gathers_not_saved``
# autograd keeps, in place of a layer's gathered tensor, how to gather it
# again, so the layers gathered in the forward do not stay alive until
# the backward. On a process group's mesh the autograd leaves stand for
# the blocks without holding them (zeros expanded to a block's shape):
# a gather fetches the blocks through ``dist.all_gather`` (``_Fetch``,
# again where it gathers again), and the backward hands each leaf its
# block's part of this rank's gradient, which the step exchanges.

# The stacks the forwards take a layer at a time (``models.lm.layer``,
# which indexes a leaf with ``[i]``). Wider than ``ShardingRules``'s
# stacked test (``layers/`` or ``/layers/``, the reference's rule), which
# places whisper's ``enc_layers`` and ``dec_layers`` by its fallback rule:
# placement follows the reference, and the gather follows how the
# forwards read a leaf, whatever its spec.
LAYER_STACKS = ("layers", "enc_layers", "dec_layers")


def taken_by_layer(path: str) -> bool:
    """Whether the leaf at ``path`` is stacked on a leading layer axis
    that the forwards take a layer at a time."""
    return path.split("/", 1)[0] in LAYER_STACKS


def model_dim(spec: PartitionSpec, stacked: bool = False) -> int | None:
    """The per-position plan of a leaf: the dimension that ``spec``
    splits over ``model`` alone, a compute dimension (heads, d_ff,
    experts, d_inner or the vocabulary: ``ShardingRules``' 'm' role), or
    None. A stacked leaf's layer axis is never one."""
    return next((d for d, part in enumerate(spec)
                 if part == "model" and d >= stacked), None)


class _Plan(NamedTuple):
    """A tensor of ``shape``, ``dtype`` and ``device`` whose part
    ``index[b]`` is input block b (``_build``). ``fetch`` (a ``_Fetch``)
    gets the blocks on a process group's mesh, where the inputs stand for
    them."""
    shape: torch.Size
    dtype: torch.dtype
    device: torch.device
    index: tuple
    fetch: object = None


class _Fetch:
    """How a process of a process group's mesh gets blocks ``ids`` of
    ``x`` (of layer ``layer`` of a stacked leaf) in ``dtype``: each rank
    casts its shard (its layer, or zeros where its shard does not hold
    the layer) and ``dist.all_gather``s it over ``x``'s ``data``
    subgroup when the blocks lie in this rank's ``model`` column, else
    over every rank; block b is read from the first member that holds
    it."""

    def __init__(self, x: ShardedTensor, dtype: torch.dtype, ids,
                 layer: int | None = None):
        groups = x.sharding.mesh.groups
        ids = list(ids)
        col = {x.block_of[r] for r in groups.data.ranks}
        self.group = (groups.data if all(b in col for b in ids)
                      else groups.world)
        held = [x.block_of[r] for r in self.group.ranks]
        self.take = [held.index(b) for b in ids]
        self.x, self.dtype = x, dtype
        self.row = None
        if layer is not None:
            own = x.indices[groups.rank][0]
            self.row = (layer - own.start if own.start <= layer < own.stop
                        else -1)

    def __call__(self) -> list[torch.Tensor]:
        own = self.x.shards[0]
        if self.row is not None:
            own = (own[self.row] if self.row >= 0
                   else own.new_zeros(own.shape[1:]))
        got = dist.all_gather(own.to(self.dtype), self.group)
        return [got[k] for k in self.take]


def _fetch(x: ShardedTensor, dtype, ids, layer: int | None = None):
    """The ``_Fetch`` of a plan on a process group's mesh, else None."""
    return None if x.local is None else _Fetch(x, dtype, ids, layer)


def _placeholder(x: ShardedTensor) -> torch.Tensor:
    """A block of ``x`` as an autograd leaf stands for it on a process
    group's mesh: zeros of the block's shape, expanded from one."""
    return torch.zeros((), dtype=x.dtype, device=x.device).expand(
        x.sharding.shard_shape(x.shape))


def _build(plan: _Plan, blocks) -> torch.Tensor:
    if plan.fetch is not None:    # the inputs stand for the blocks
        blocks = plan.fetch()
    # made from a block, as ``block_zeros`` makes its zeros: the dry run
    # counts a tensor made from one position's blocks at that position
    out = blocks[0].new_empty(plan.shape, dtype=plan.dtype,
                              device=plan.device)
    for index, block in zip(plan.index, blocks):
        out[index].copy_(block)      # the cast of ``block.to(dtype)``
    return out


def _regather(plan: _Plan, blocks) -> torch.Tensor:
    with torch.no_grad():
        return _build(plan, blocks)


class GatherFn(torch.autograd.Function):
    """``GatherFn.apply(plan, *blocks)``: the tensor built from its
    blocks, each cast to the plan's dtype; the backward returns each
    block's part of the gradient, rounded to the block's dtype (the
    rounding of the unsplit step's cast back to the leaf). Nothing is
    saved."""

    @staticmethod
    def forward(ctx, plan, *blocks):
        ctx.plan = plan
        ctx.blocks = [(b.dtype, b.device) for b in blocks]
        return _build(plan, blocks)

    @staticmethod
    def backward(ctx, grad):
        return (None, *(grad[index].to(device=dev, dtype=dtype, copy=True)
                        for index, (dtype, dev) in zip(ctx.plan.index,
                                                       ctx.blocks)))


class SplitAtUse:
    """A split leaf as the training step's loss reads it, in ``dtype``
    (the type the layers use it in). ``inputs`` are the autograd leaves
    the step differentiates, views of the distinct blocks (each read
    from the first position that holds it, as ``gather`` reads it), and
    ``slots[n]`` says where input n's gradient goes: (block, None) for a
    whole block, (block, j) for row j of a stacked block.

    A leaf outside the stacks of layers is gathered whole (``whole``,
    once a data row). A stacked leaf is gathered a layer at a time
    (``layer(i)``, or ``[i]`` as ``models.lm.layer`` takes it): its
    inputs are a block's layer each, so layer i's gradient lands in its
    own inputs and no block-shaped gradient is made a layer. The spec may
    split any axis, the layer axis too.

    A leaf whose spec splits a compute dimension over ``model``
    (``model_dim``) is read as ``model_split.Blocks``: ``top()`` outside
    the stacks (each position's block gathered once a data row),
    ``layer(i)`` in them, where position j's block of layer i is gathered
    over the FSDP axes only when a layer asks for it, and carries how to
    gather it again (``gathers_not_saved``); ``whole()`` on those blocks
    gathers the leaf or the layer whole.

    On a process group's mesh the inputs stand for the blocks
    (``_placeholder``) and each plan fetches them (``_Fetch``); ``top()``
    gathers this rank's ``model`` position's block alone, and the layers
    ask for no other."""

    def __init__(self, x: ShardedTensor, dtype: torch.dtype,
                 stacked: bool):
        self.dtype = dtype
        self.inputs: list[torch.Tensor] = []
        self.slots: list[tuple] = []
        self._col = None if x.local is None else x.sharding.mesh.groups.col
        blocks = [(x.indices[k], x.shards[k] if x.local is None
                   else _placeholder(x)) for k in x.firsts]
        d = model_dim(x.sharding.spec, stacked)
        self.n = x.sharding.mesh.shape["model"] if d is not None else 1
        if not stacked:
            for b, (_, block) in enumerate(blocks):
                self.slots.append((b, None))
                self.inputs.append(block.detach().requires_grad_())
            self._whole = _Plan(x.shape, dtype, x.device,
                                tuple(index for index, _ in blocks),
                                _fetch(x, dtype, range(len(blocks))))
            self._positions = [_position_plan(x, dtype, d, j, [
                (index, inp, b) for b, ((index, _), inp) in enumerate(
                    zip(blocks, self.inputs))])
                for j in range(self.n)] if d is not None else None
            self._dim = d
            return
        parts = [[] for _ in range(x.shape[0])]   # a layer's blocks
        for b, (index, block) in enumerate(blocks):
            lo = index[0].start
            for j in range(lo, index[0].stop):
                parts[j].append((index[1:], len(self.inputs), b))
                self.slots.append((b, j - lo))
                self.inputs.append(block[j - lo].detach().requires_grad_())
        self._layers = [
            (_Plan(x.shape[1:], dtype, x.device,
                   tuple(index for index, _, _ in part),
                   _fetch(x, dtype, [b for _, _, b in part], i)),
             [self.inputs[n] for _, n, _ in part])
            for i, part in enumerate(parts)]
        self._dim = None if d is None else d - 1
        self._positions = None if d is None else [
            [_position_plan(x, dtype, d, j, [
                (index, self.inputs[n], b) for index, n, b in part],
                layer=i) for j in range(self.n)]
            for i, part in enumerate(parts)]

    def whole(self) -> torch.Tensor:
        return GatherFn.apply(self._whole, *self.inputs)

    def top(self):
        """The leaf outside the stacks as the loss reads it: gathered
        whole, or, split over ``model``, each position's block gathered
        (a ``Blocks``; on a process group's mesh, this rank's position's
        alone)."""
        if self._positions is None:
            return self.whole()
        cols = range(self.n) if self._col is None else [self._col]
        got = {j: GatherFn.apply(self._positions[j][0],
                                 *self._positions[j][1]) for j in cols}
        return MS.Blocks(self.n, self._dim, self.dtype, got.__getitem__,
                         self.whole)

    def layer(self, i: int):
        """Layer ``i``, gathered, or its ``Blocks`` (see the class). A
        gathered tensor carries how to gather it again (``_regather``,
        read by ``gathers_not_saved``)."""
        if self._positions is not None:
            return MS.Blocks(self.n, self._dim, self.dtype,
                             partial(self._gather, *zip(*self._positions[i])),
                             partial(self._gather, (self._layers[i][0],),
                                     (self._layers[i][1],), 0))
        return self._gather((self._layers[i][0],), (self._layers[i][1],), 0)

    @staticmethod
    def _gather(plans, inputs, j: int) -> torch.Tensor:
        out = GatherFn.apply(plans[j], *inputs[j])
        out._regather = partial(_regather, plans[j], inputs[j])
        return out

    def __getitem__(self, i: int):
        return self.layer(i)

    def to(self, dtype: torch.dtype) -> "SplitAtUse":
        """Itself: its layers are gathered in their use type already
        (``train.step.params_at_use`` casts every leaf to it)."""
        if dtype != self.dtype:
            raise ValueError(f"a leaf split at use in {self.dtype} was "
                             f"asked for in {dtype}")
        return self


def _position_plan(x: ShardedTensor, dtype, d: int, j: int, parts,
                   layer: int | None = None):
    """(plan, inputs): position j's block of ``x`` (dimension ``d`` split
    over ``model``), or of layer ``layer`` of it (``parts`` then index
    the layer's dimensions), from the ``(index, input, block id)``
    ``parts`` that lie in it, each placed at its index within the
    block."""
    n = x.sharding.mesh.shape["model"]
    width = x.shape[d] // n
    lo = j * width
    stacked = layer is not None
    shape = list(x.shape[1:] if stacked else x.shape)
    dd = d - stacked
    shape[dd] = width
    index, inputs, ids = [], [], []
    for idx, t, b in parts:
        if idx[dd].start // width == j:
            idx = list(idx)
            idx[dd] = slice(idx[dd].start - lo, idx[dd].stop - lo)
            index.append(tuple(idx))
            inputs.append(t)
            ids.append(b)
    return _Plan(torch.Size(shape), dtype, x.device, tuple(index),
                 _fetch(x, dtype, ids, layer)), inputs


def _pack(t: torch.Tensor):
    base = t if t._base is None else t._base
    regather = getattr(base, "_regather", None)
    if regather is None or t.dtype != base.dtype:
        return t
    return regather, t.size(), t.stride(), t.storage_offset()


def _unpack(packed) -> torch.Tensor:
    if isinstance(packed, torch.Tensor):
        return packed
    regather, size, stride, offset = packed
    return regather().as_strided(size, stride, offset)


def gathers_not_saved():
    """Saved-tensor hooks under which autograd saves, in place of a
    gathered layer (``SplitAtUse.layer``) or a view of it, how to gather
    it again: a product's backward, and an activation checkpoint's
    recomputation (``models.lm.remat_layer`` saves the layer's tensors),
    gather the layer again where they need it. So under every ``remat``
    policy at most one layer's gathered leaves are alive at a time, and
    no value changes: a gather is a copy."""
    return torch.autograd.graph.saved_tensors_hooks(_pack, _unpack)


def device_put(x, sharding: NamedSharding):
    """``x`` (a tensor or a ``ShardedTensor``) placed by ``sharding``:
    moved whole to the mesh's device when no axis of extent > 1 splits
    it, else split into a ``ShardedTensor``, each shard a copy of its
    block on its position's device (``meta`` shards on a meta mesh
    allocate nothing; on a process group's mesh, this rank's shard
    alone)."""
    mesh = sharding.mesh
    if isinstance(x, ShardedTensor):
        x = x.gather(mesh.device)
    named = [a for part in sharding.spec if part
             for a in ((part,) if isinstance(part, str) else part)]
    if all(mesh.shape[a] == 1 for a in named):
        return x.to(mesh.device)
    shape = sharding.shard_shape(tuple(x.shape))
    places = list(zip(sharding.shard_indices(tuple(x.shape)),
                      mesh.devices.flat))
    if getattr(mesh, "groups", None) is not None:
        places = places[mesh.groups.rank:mesh.groups.rank + 1]
    shards = []
    for index, dev in places:
        shard = torch.empty(shape, dtype=x.dtype, device=dev)
        shards.append(shard.copy_(x[index]))
    return ShardedTensor(shards, sharding, x.shape, x.dtype)


def gather_tree(tree, device=None):
    """``tree`` with every ``ShardedTensor`` gathered (see
    ``ShardedTensor.gather``)."""
    return _map_with_path(
        lambda _, x: x.gather(device) if isinstance(x, ShardedTensor)
        else x, tree)


def place(tree, shardings):
    """``device_put`` of every leaf of ``tree`` by the matching leaf of
    ``shardings`` (a tree of the same containers, as ``tree_shardings``
    returns it)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: place(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(place(v, s) for v, s in zip(tree, shardings)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(place(v, s) for v, s in zip(tree, shardings))
    return device_put(tree, shardings)


def fsdp_axes(mesh):
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return axes if axes else None


def axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return int(np.prod([mesh.shape[a] for a in axes]))


def _div(dim: int, n: int) -> bool:
    return n > 1 and dim % n == 0


def flatten_with_path(tree, path: tuple = ()) -> list[tuple[tuple, object]]:
    """``(path, leaf)`` pairs of a tree of dicts, lists and tuples, in the
    reference's order (dict keys sorted); ``None`` leaves are dropped."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in flatten_with_path(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in flatten_with_path(v, path + (i,))]
    return [(path, tree)]


def path_str(path: tuple) -> str:
    """The reference's ``'/'``-joined path of a leaf."""
    return "/".join(str(k) for k in path)


def _map_with_path(fn, tree, path: tuple = ()):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, v, path + (i,))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


class ShardingRules:
    """Maps parameter-tree paths to PartitionSpecs for a given mesh."""

    # dims named by their role; rule = {path-substring: (role per dim)}
    # roles: 'd' -> FSDP axes, 'm' -> model axis, '.' -> replicated
    RULES: list[tuple[str, str]] = [
        ("embed/table", "md"),      # (V, D): vocab->model, d_model->fsdp
        ("embed/pos", ".d"),
        ("lm_head", "dm"),          # (D, V)
        ("enc_pos", ".d"),
        ("attn/wq", "dm."),         # (D, H, hd)
        ("attn/wk", "dm."),
        ("attn/wv", "dm."),
        ("attn/wo", "m.d"),         # (H, hd, D)
        ("attn/bq", "m."),
        ("attn/bk", "m."),
        ("attn/bv", "m."),
        ("xattn/wq", "dm."),
        ("xattn/wk", "dm."),
        ("xattn/wv", "dm."),
        ("xattn/wo", "m.d"),
        ("xattn/bq", "m."),
        ("xattn/bk", "m."),
        ("xattn/bv", "m."),
        ("shared_attn/wq", "dm."),
        ("shared_attn/wk", "dm."),
        ("shared_attn/wv", "dm."),
        ("shared_attn/wo", "m.d"),
        ("mlp/w_gate", "dm"),       # (D, F)
        ("mlp/w_up", "dm"),
        ("mlp/w_down", "md"),       # (F, D)
        ("mlp/b_up", "m"),
        ("mlp/b_down", "d"),
        ("shared_mlp/w_gate", "dm"),
        ("shared_mlp/w_up", "dm"),
        ("shared_mlp/w_down", "md"),
        ("moe/router", "d."),       # (D, E): router replicated over model
        ("moe/w_gate", "md."),      # (E, D, F): EP on experts
        ("moe/w_up", "md."),
        ("moe/w_down", "m.d"),      # (E, F, D)
        # rwkv6 time-mix: (D, D) projections — out-dim to model
        ("time_mix/wr", "dm"),
        ("time_mix/wk", "dm"),
        ("time_mix/wv", "dm"),
        ("time_mix/wg", "dm"),
        ("time_mix/wo", "md"),
        ("time_mix/decay_A", "d."),
        ("time_mix/decay_B", ".d"),
        ("time_mix/bonus_u", "m."),
        ("channel_mix/w_in", "dm"),
        ("channel_mix/w_out", "md"),
        # mamba2: d_inner/heads to model, d_model to fsdp
        ("mamba/w_in_z", "dm"),
        ("mamba/w_in_x", "dm"),
        ("mamba/w_in_B", "dm."),    # (D, H, N)
        ("mamba/w_in_C", "dm."),
        ("mamba/w_in_dt", "dm"),
        ("mamba/dt_bias", "m"),
        ("mamba/A_log", "m"),
        ("mamba/D_skip", "m."),
        ("mamba/conv_x", ".m"),     # (W, d_inner)
        ("mamba/out_norm", "m"),
        ("mamba/w_out", "md"),
    ]

    def __init__(self, mesh):
        self.mesh = mesh
        self.fsdp = fsdp_axes(mesh)
        self.n_fsdp = axis_size(mesh, self.fsdp)
        self.n_model = mesh.shape["model"] if "model" in mesh.axis_names else 1

    def _role_axis(self, role: str, dim: int):
        if role == "m" and _div(dim, self.n_model):
            return "model"
        if role == "d" and self.fsdp and _div(dim, self.n_fsdp):
            return self.fsdp
        return None

    def spec_for(self, path: str, shape: tuple[int, ...]) -> PartitionSpec:
        """path: '/'-joined tree path; leading 'layers/' handled (stacked)."""
        shape = tuple(int(d) for d in shape)
        stacked = path.startswith("layers/") or "/layers/" in path
        core_shape = shape[1:] if stacked else shape
        spec: Optional[tuple] = None
        for pat, roles in self.RULES:
            if pat in path:
                if len(roles) != len(core_shape):
                    continue
                spec = tuple(self._role_axis(r, d)
                             for r, d in zip(roles, core_shape))
                break
        if spec is None:
            # fallback: replicate small tensors; for ≥2D try largest-dim FSDP
            if len(core_shape) >= 2 and max(core_shape) >= 1024:
                spec = tuple(
                    (self.fsdp if (d == max(core_shape)
                                   and self.fsdp
                                   and _div(d, self.n_fsdp)) else None)
                    for d in core_shape)
            else:
                spec = tuple(None for _ in core_shape)
        if stacked:
            spec = (None,) + spec
        return PartitionSpec(*spec)

    def tree_specs(self, params) -> object:
        """PartitionSpec tree matching ``params`` (its containers kept)."""
        return _map_with_path(
            lambda path, leaf: self.spec_for(path_str(path),
                                             tuple(leaf.shape)), params)

    def tree_shardings(self, params):
        """``NamedSharding`` tree matching ``params`` (see ``device_put``)."""
        return _map_with_path(
            lambda path, leaf: NamedSharding(
                self.mesh, self.spec_for(path_str(path), tuple(leaf.shape))),
            params)

    # ---------------- activation/batch shardings
    def batch_spec(self, batch_size: int, ndim: int) -> PartitionSpec:
        ax = self.fsdp if (self.fsdp and _div(batch_size, self.n_fsdp)) \
            else None
        return PartitionSpec(ax, *([None] * (ndim - 1)))

    def kv_cache_spec(self, batch: int, n_kv: int,
                      stacked: bool = True) -> PartitionSpec:
        """(L, B, S, KV, hd) or (B, S, KV, hd)."""
        b_ax = self.fsdp if (self.fsdp and _div(batch, self.n_fsdp)) else None
        h_ax = "model" if _div(n_kv, self.n_model) else None
        core = (b_ax, None, h_ax, None)
        return PartitionSpec(*(((None,) + core) if stacked else core))


def data_rows(mesh, batch_size: int) -> int:
    """The blocks a batch of ``batch_size`` is split into over ``mesh``'s
    FSDP axes (``ShardingRules.batch_spec``): their extent where it
    divides the batch, else 1."""
    return axis_size(mesh, ShardingRules(mesh).batch_spec(batch_size, 1)[0])

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
process drives every position, as the reference's ``jit`` drives every
device of its host; a mesh may repeat a device (``launch.mesh``), so the
split runs on one card or on the CPU too. ``train.step.make_train_step``
trains on such trees, a microbatch each of ``data_rows``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


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
    ``indices[i]``, on ``sharding.mesh.devices.flat[i]``)."""

    def __init__(self, shards, sharding: NamedSharding, shape,
                 dtype: torch.dtype):
        self.shards = tuple(shards)
        self.sharding = sharding
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.indices = sharding.shard_indices(self.shape)

    @property
    def device(self) -> torch.device:
        """The mesh's first device (where a gather lands by default)."""
        return self.sharding.mesh.device

    def numel(self) -> int:
        return self.shape.numel()

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={tuple(self.shape)}, dtype={self.dtype}"
                f", spec={self.sharding.spec}, shards={len(self.shards)})")

    def gather(self, device=None, dtype: torch.dtype | None = None
               ) -> torch.Tensor:
        """The global tensor on ``device`` (default: the mesh's first),
        each shard cast to ``dtype`` first if given: bitwise the leaf that
        was split. Each block is read from the first position that holds
        it."""
        out = torch.empty(self.shape, dtype=dtype or self.dtype,
                          device=self.device if device is None else device)
        seen = set()
        for index, shard in zip(self.indices, self.shards):
            key = tuple((s.start, s.stop) for s in index)
            if key not in seen:
                seen.add(key)
                out[index].copy_(shard if dtype is None else shard.to(dtype))
        return out

    def map_shards(self, fn) -> "ShardedTensor":
        """``fn`` over every shard (elementwise: the shape is kept)."""
        shards = [fn(x) for x in self.shards]
        return ShardedTensor(shards, self.sharding, self.shape,
                             shards[0].dtype)


def device_put(x, sharding: NamedSharding):
    """``x`` (a tensor or a ``ShardedTensor``) placed by ``sharding``:
    moved whole to the mesh's device when no axis of extent > 1 splits
    it, else split into a ``ShardedTensor``, each shard a copy of its
    block on its position's device (``meta`` shards on a meta mesh
    allocate nothing)."""
    mesh = sharding.mesh
    if isinstance(x, ShardedTensor):
        x = x.gather(mesh.device)
    named = [a for part in sharding.spec if part
             for a in ((part,) if isinstance(part, str) else part)]
    if all(mesh.shape[a] == 1 for a in named):
        return x.to(mesh.device)
    shape = sharding.shard_shape(tuple(x.shape))
    shards = []
    for index, dev in zip(sharding.shard_indices(tuple(x.shape)),
                          mesh.devices.flat):
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

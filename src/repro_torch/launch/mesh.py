"""The 1-D ``scenarios`` mesh of the fleet's sharded paths (port of
``repro.launch.mesh``).

Where the reference builds a ``jax.sharding.Mesh`` and ``shard_map``s the
scenario (or query) axis over it, the port's mesh is a ``ScenariosMesh``:
the ``torch.device`` of each block, in mesh order. A sharded path splits
its batch into that many contiguous blocks, runs each block on its
device and gathers the results in mesh order.

``make_scenarios_mesh`` builds one over the devices of one type, after
validating the shard count against that type's inventory. A
``ScenariosMesh`` may also be built directly from any sequence of
devices, repeats allowed: several blocks on one device. That is the
port's counterpart of the reference's ``Mesh`` over CPU devices faked
with ``XLA_FLAGS=--xla_force_host_platform_device_count=N``; the port's
CPU tests and the chip smoke's one-card blocks use it. Under an
initialised process group (``parallel.dist``) ``make_scenarios_mesh``
builds the mesh of the group's ranks instead, one block a rank
(``groups``): each process runs its own block and the results meet in
``dist`` collectives, as the reference's ``shard_map`` runs every
device's block at once.

``make_local_mesh`` builds the (data, model) mesh of training over the
host's devices (a ``DeviceMesh``); ``parallel.sharding`` places parameter
trees on it. Under an initialised process group (``parallel.dist``) it
builds the mesh of the group's ranks instead, one a position, and the
mesh knows this rank's position (``groups``). ``make_production_mesh`` builds the dry run's 16×16 and
2×16×16 meshes, of ``meta`` devices: the dry run (``launch.dryrun``)
reads shapes and shardings from them and allocates nothing.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.parallel.fleet import SCENARIO_AXIS


class ScenariosMesh:
    """A 1-D ``scenarios`` mesh: one device per block, in mesh order.

    ``groups`` (a ``parallel.dist.Group`` of every rank) makes it the
    mesh of a process group: block i is rank i's, this process runs block
    ``groups.index`` alone, and every entry of ``devices`` is this rank's
    device (``dist.local_device``), the only one it uses."""

    axis_names = (SCENARIO_AXIS,)

    def __init__(self, devices: Sequence[str | torch.device], groups=None):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("ScenariosMesh needs at least one device")
        if groups is not None and groups.size != len(self.devices):
            raise ValueError(f"a mesh of {len(self.devices)} blocks over "
                             f"a group of {groups.size} ranks")
        self.shape = {SCENARIO_AXIS: len(self.devices)}
        self.groups = groups

    def __repr__(self) -> str:
        where = ("" if self.groups is None
                 else f", rank {self.groups.index} of {self.groups.size}")
        return f"ScenariosMesh({[str(d) for d in self.devices]}{where})"


def _group_world() -> int | None:
    """The world size of the initialised process group, else None."""
    d = torch.distributed
    return d.get_world_size() if d.is_available() and d.is_initialized() \
        else None


def _inventory(device: str | torch.device) -> tuple[str, int]:
    kind = torch.device(device).type
    if kind == "cuda":
        return kind, torch.cuda.device_count()
    if kind == "cpu":
        return kind, 1
    raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', got {kind}")


def shards_arg_error(n_shards: int, flag: str = "--shards", *,
                     device: str | torch.device = DEFAULT_DEVICE
                     ) -> str | None:
    """None when ``n_shards`` fits the inventory of ``device``'s type
    (under a process group: when it is the group's world size, one block
    a rank), else the error message (the one source of the shard-count
    check)."""
    kind, n_dev = _inventory(device)
    world = _group_world()
    if world is not None:
        if n_shards == world:
            return None
        return (f"{flag} {n_shards} is not the {world} ranks of the "
                "process group (one block a rank)")
    if 1 <= n_shards <= n_dev:
        return None
    return (f"{flag} {n_shards} outside the visible device inventory "
            f"(1..{n_dev}, device type {kind}); build a ScenariosMesh from "
            "a list of devices to place several blocks on one device")


def make_scenarios_mesh(n_shards: int | None = None, *,
                        device: str | torch.device = DEFAULT_DEVICE
                        ) -> ScenariosMesh:
    """A ``scenarios`` mesh over the first ``n_shards`` devices of
    ``device``'s type (``None``: all of them), validated before anything
    is built. Under an initialised process group, the mesh of its ranks
    (``n_shards`` None or the world size), each rank's device
    ``parallel.dist.local_device``."""
    kind, n_dev = _inventory(device)
    world = _group_world()
    n = (n_dev if world is None else world) if n_shards is None \
        else n_shards
    err = shards_arg_error(n, flag="n_shards", device=device)
    if err is not None:
        raise ValueError(err)
    if world is not None:
        from repro_torch.parallel import dist

        return ScenariosMesh([dist.local_device(kind)] * world,
                             groups=dist.world_group())
    if kind == "cpu":
        return ScenariosMesh([torch.device("cpu")])
    return ScenariosMesh([torch.device("cuda", i) for i in range(n)])


class DeviceMesh:
    """A mesh of devices with named axes: ``devices`` is an array of
    ``torch.device`` of the mesh's shape, ``shape`` maps each axis name to
    its extent (as a ``jax.sharding.Mesh``'s does) and ``device`` is the
    first device, where a leaf that no axis splits is placed.

    ``groups`` (a ``parallel.dist.MeshGroups``) makes it the mesh of a
    process group: this process is position ``groups.rank`` (in the
    devices' flat order), holds only that position's shards, and
    ``device`` is its own device."""

    def __init__(self, devices, axis_names: Sequence[str], groups=None):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names) or not self.devices.size:
            raise ValueError(f"a mesh of shape {self.devices.shape} cannot "
                             f"carry axes {self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.groups = groups
        self.device = self.devices.flat[0 if groups is None else groups.rank]

    def __repr__(self) -> str:
        devs = [str(d) for d in self.devices.flat]
        where = "" if self.groups is None else f", {self.groups}"
        return f"DeviceMesh({self.shape}, {devs}{where})"


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16×16 single-pod (256 chips) or 2×16×16 multi-pod (512 chips), as
    the reference's: ``model`` is tensor/expert-parallel, ``data`` is
    data + FSDP, ``pod`` extends data/FSDP across pods. Every device is
    ``meta``, so building it needs no card."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    grid = np.empty(shape, dtype=object)
    grid.fill(torch.device("meta"))
    return DeviceMesh(grid, axes)


def make_local_mesh(model: int = 1, *,
                    device: str | torch.device = DEFAULT_DEVICE
                    ) -> DeviceMesh:
    """The (data, model) mesh of this host's devices of ``device``'s type
    (every CUDA device, or the one CPU), shaped ``(n // model, model)``.
    Under an initialised process group, the mesh of its ranks, shaped
    ``(world // model, model)``, this process one of its positions: the
    grid holds this rank's device (``parallel.dist.local_device``), the
    only one it uses."""
    kind, n = _inventory(resolve_device(device))
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        from repro_torch.parallel import dist

        world = torch.distributed.get_world_size()
        if model < 1 or world % model:
            raise ValueError(f"model={model} does not divide the {world} "
                             "ranks of the process group")
        groups = dist.mesh_groups(world // model, model)
        grid = np.empty((world // model, model), dtype=object)
        grid.fill(dist.local_device(kind))
        return DeviceMesh(grid, ("data", "model"), groups=groups)
    if model < 1 or n % model:
        raise ValueError(f"model={model} does not divide the {n} visible "
                         f"{kind} device(s)")
    devs = ([torch.device("cpu")] if kind == "cpu"
            else [torch.device("cuda", i) for i in range(n)])
    grid = np.empty(n, dtype=object)
    grid[:] = devs
    return DeviceMesh(grid.reshape(n // model, model), ("data", "model"))

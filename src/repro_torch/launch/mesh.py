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
CPU tests and the chip smoke's one-card blocks use it.

``make_local_mesh`` builds the (data, model) mesh of training over the
host's devices (a ``DeviceMesh``); ``parallel.sharding`` places parameter
trees on it. ``make_production_mesh`` builds the dry run's 16×16 and
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
    """A 1-D ``scenarios`` mesh: one device per block, in mesh order."""

    axis_names = (SCENARIO_AXIS,)

    def __init__(self, devices: Sequence[str | torch.device]):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("ScenariosMesh needs at least one device")
        self.shape = {SCENARIO_AXIS: len(self.devices)}

    def __repr__(self) -> str:
        return f"ScenariosMesh({[str(d) for d in self.devices]})"


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
    """None when ``n_shards`` fits the inventory of ``device``'s type,
    else the error message (the one source of the shard-count check)."""
    kind, n_dev = _inventory(device)
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
    is built."""
    kind, n_dev = _inventory(device)
    n = n_dev if n_shards is None else n_shards
    err = shards_arg_error(n, flag="n_shards", device=device)
    if err is not None:
        raise ValueError(err)
    if kind == "cpu":
        return ScenariosMesh([torch.device("cpu")])
    return ScenariosMesh([torch.device("cuda", i) for i in range(n)])


class DeviceMesh:
    """A mesh of devices with named axes: ``devices`` is an array of
    ``torch.device`` of the mesh's shape, ``shape`` maps each axis name to
    its extent (as a ``jax.sharding.Mesh``'s does) and ``device`` is the
    first device, where a leaf that no axis splits is placed."""

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names) or not self.devices.size:
            raise ValueError(f"a mesh of shape {self.devices.shape} cannot "
                             f"carry axes {self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.device = self.devices.flat[0]

    def __repr__(self) -> str:
        devs = [str(d) for d in self.devices.flat]
        return f"DeviceMesh({self.shape}, {devs})"


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
    (every CUDA device, or the one CPU), shaped ``(n // model, model)``."""
    kind, n = _inventory(resolve_device(device))
    if model < 1 or n % model:
        raise ValueError(f"model={model} does not divide the {n} visible "
                         f"{kind} device(s)")
    devs = ([torch.device("cpu")] if kind == "cpu"
            else [torch.device("cuda", i) for i in range(n)])
    grid = np.empty(n, dtype=object)
    grid[:] = devs
    return DeviceMesh(grid.reshape(n // model, model), ("data", "model"))

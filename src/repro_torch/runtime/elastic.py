"""Elastic remeshing plans and live capacity plans (port of
``repro.runtime.elastic``).

The paper's per-stage resource changes map to changing a training mesh's
``data`` extent. ``reshard_plan`` reports, per parameter, the old and new
``PartitionSpec`` (``parallel.sharding``) and the bytes of the leaf, and
whether it must move: the number a scheduler needs to estimate a
resize's cost (and what ASA learns to hide in the queue-wait overlap). It
reads shapes and dtypes only, so a tree of meta tensors gives the plan
of a published size without allocating it. ``apply_resize`` re-places
the leaves on the new mesh (``parallel.sharding.device_put``: a split
leaf is gathered and split again by the new mesh's sharding, whole on a
mesh whose axes do not split it; on the meshes of one process group, a
leaf that stays split moves by an all-to-all of its blocks'
intersections, and no rank builds it whole): data movement only, so
bitwise.

``resize_schedule`` is the center-side view of the same elasticity: a
sequence of live capacity changes (the malleable-job model of Dynamic
Fractional Resource Scheduling, arXiv 1106.4985) expressed as a
``runtime.fault.FaultSchedule`` that ``repro_torch.xsim`` folds into its
event steps: graceful shrinks drain, preemptive shrinks kill and requeue.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from repro_torch.parallel.sharding import (ShardingRules, flatten_with_path,
                                           path_str, place)
from repro_torch.runtime import fault as _fault


@dataclass
class ReshardEntry:
    path: str
    old_spec: str
    new_spec: str
    bytes_total: int
    moves: bool


def reshard_plan(params, old_rules: ShardingRules,
                 new_rules: ShardingRules) -> list[ReshardEntry]:
    """One entry per tensor of ``params`` (a tree of dicts, lists and
    tuples), in the reference's order."""
    plan = []
    for path, leaf in flatten_with_path(params):
        pstr = path_str(path)
        shape = tuple(leaf.shape)
        old = old_rules.spec_for(pstr, shape)
        new = new_rules.spec_for(pstr, shape)
        nbytes = leaf.numel() * leaf.dtype.itemsize
        # a leaf moves if its spec changed OR it is sharded over an axis
        # whose extent changed (same spec string, different shard shape)
        axes_used = {a for part in new if part
                     for a in ((part,) if isinstance(part, str) else part)}
        size_changed = any(
            old_rules.mesh.shape.get(a) != new_rules.mesh.shape.get(a)
            for a in axes_used)
        plan.append(ReshardEntry(
            path=pstr, old_spec=str(old), new_spec=str(new),
            bytes_total=nbytes,
            moves=(str(old) != str(new)) or size_changed))
    return plan


def apply_resize(tree, new_mesh, new_rules: ShardingRules):
    """Re-place every leaf under the new mesh's shardings."""
    return place(tree, new_rules.tree_shardings(tree))


def resize_schedule(steps: Sequence[tuple[float, float]], *,
                    preempt: bool = False) -> _fault.FaultSchedule:
    """Live capacity plan → ``runtime.fault.FaultSchedule``.

    ``steps`` is ``[(t, delta_frac), ...]``: at absolute simulation time
    ``t`` the center's capacity changes by ``delta_frac`` of its original
    total cores. Positive deltas grow (nodes join); negative deltas
    shrink — gracefully by default (a DRAIN: nodes leave as their running
    work completes), or preemptively with ``preempt=True`` (a FAIL: the
    most recently started jobs on the lost nodes are killed and requeued,
    the xsim engine charges their lost core-seconds as restart overhead).
    """
    events = []
    for t, delta in steps:
        if delta == 0.0:
            raise ValueError(f"zero-delta resize step at t={t}")
        if delta > 0.0:
            events.append(_fault.grow(t, delta))
        elif preempt:
            events.append(_fault.fail(t, -delta))
        else:
            events.append(_fault.drain(t, -delta))
    return _fault.FaultSchedule(tuple(events))

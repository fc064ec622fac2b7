"""One process a mesh position (ROADMAP Queue 1 item 12(f)): the process
group of a (data, model) mesh and the few collectives that join its
positions.

The reference runs every device of its mesh at once under one ``jit``
and lets XLA's collectives join them. The port does the same with one
process a position over ``torch.distributed``: a (d, m) mesh is d·m
ranks, and rank r is position (r // m, r % m), row-major, the order in
which ``launch.mesh.DeviceMesh`` flattens its devices and in which jax
lists ``addressable_shards``. ``MeshGroups`` holds this rank's position
and its subgroups: ``data``, the ranks of its ``model`` index across the
data rows (the FSDP axis: a leaf's blocks are gathered and its gradients
exchanged there), and ``model``, the ranks of its data row (the shares
of a layer meet there); ``world`` is every rank.

The collectives move values and never add them: ``all_gather`` hands
back every member's tensor in position order and ``all_to_all`` hands
part k to member k, so that the caller adds the parts in the fixed order
of the one-process route (``parallel.model_split.psum``, the rows' sums
in ``train.step``) and the two routes stay bitwise. ``gather`` brings
every member's tensor to one rank and ``broadcast`` sends one rank's to
all. ``COUNTS`` counts each kind's calls and the bytes this rank
receives, as the reference's ``parallel.collectives.collective_stats``
counts them in HLO.

The fleet's sharded paths (ROADMAP Queue 1 item 12(g)) use the 1-D
group of a ``scenarios`` mesh, every rank one block (``world_group``):
``all_gather_many`` brings every rank's tensors (the leaves of its
block of a batched tree, ``parallel.fleet.all_gather_tree``) to every
rank in one call, their bytes packed into one buffer, and
``all_to_all_v`` sends each rank a part of its own size (a resize's
intersections, ``parallel.sharding.device_put``).

The transport is ``gloo``: on CPU tensors as they are, and on a card
that several ranks share through pinned host buffers, copied explicitly
here (gloo's own handling of CUDA tensors covers only some
collectives). NCCL, one rank a card, waits for a host with more than one
card (item 12(e)). ``init`` gives the group an explicit timeout, so that
a rank that dies fails its peers instead of hanging them.
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as D

# the flat all-gather (its name changed in torch 2.13)
_ALL_GATHER = getattr(D, "all_gather_single", None) or \
    D.all_gather_into_tensor
TIMEOUT_S = 300
_timeout_s = float(TIMEOUT_S)   # the initialised group's (``init``)
TRANSPORT = "gloo, host-staged"
KINDS = ("all_gather", "all_to_all", "gather", "broadcast")
COUNTS = {k: {"calls": 0, "bytes": 0} for k in KINDS}


def reset_counts() -> None:
    for c in COUNTS.values():
        c.update(calls=0, bytes=0)


def _count(kind: str, nbytes: int) -> None:
    COUNTS[kind]["calls"] += 1
    COUNTS[kind]["bytes"] += int(nbytes)


def init(rank: int | None = None, world: int | None = None, *,
         init_method: str = "env://", timeout_s: float = TIMEOUT_S) -> None:
    """Join the ``gloo`` process group (``rank``/``world`` from the
    environment that ``torch.distributed.run`` sets when not given), and
    take this rank's share of the host's CPU threads."""
    global _timeout_s
    D.init_process_group("gloo", init_method=init_method,
                         rank=-1 if rank is None else rank,
                         world_size=-1 if world is None else world,
                         timeout=timedelta(seconds=timeout_s))
    _timeout_s = float(timeout_s)
    local = int(os.environ.get("LOCAL_WORLD_SIZE", D.get_world_size()))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // local))


def timeout_s() -> float:
    """The seconds a collective of the initialised group may wait before
    it fails (``init``'s ``timeout_s``)."""
    return _timeout_s


def world_from_env() -> int:
    """The world size that ``torch.distributed.run`` names (1 without
    it)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def local_device(kind: str) -> torch.device:
    """This rank's device of ``kind``: ``cuda:(LOCAL_RANK % cards)``, so
    every rank of a one-card host shares ``cuda:0``; or the CPU."""
    if kind != "cuda":
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", D.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


class Group:
    """Ranks in position order; ``index`` is this rank's place among
    them. ``pg`` is the process group (None: the default, every rank)."""

    def __init__(self, ranks, pg):
        self.ranks = tuple(ranks)
        self.pg = pg
        self.size = len(self.ranks)
        self.index = self.ranks.index(D.get_rank())


class MeshGroups:
    """This rank's position on a (data, model) mesh and its subgroups
    (see the module docstring). Every rank makes every subgroup, in the
    same order, as ``new_group`` asks."""

    def __init__(self, data: int, model: int):
        world = D.get_world_size()
        if data * model != world:
            raise ValueError(f"a ({data}, {model}) mesh needs {data * model}"
                             f" ranks, the group has {world}")
        self.shape = (data, model)
        self.rank = D.get_rank()
        self.row, self.col = divmod(self.rank, model)
        cols = [[r * model + c for r in range(data)] for c in range(model)]
        rows = [[r * model + c for c in range(model)] for r in range(data)]
        col_pgs = [D.new_group(rs) for rs in cols]
        row_pgs = [D.new_group(rs) for rs in rows]
        self.world = Group(range(world), None)
        self.data = Group(cols[self.col], col_pgs[self.col])
        self.model = Group(rows[self.row], row_pgs[self.row])

    def __repr__(self) -> str:
        return (f"MeshGroups(shape={self.shape}, rank={self.rank}, "
                f"position=({self.row}, {self.col}))")


_MESH_GROUPS: dict = {}


def mesh_groups(data: int, model: int) -> MeshGroups:
    """The subgroups of a (data, model) mesh over the initialised group,
    made once a shape (every rank asks for the same shapes in the same
    order)."""
    key = (data, model)
    if key not in _MESH_GROUPS:
        _MESH_GROUPS[key] = MeshGroups(data, model)
    return _MESH_GROUPS[key]


def destroy() -> None:
    """Leave the process group (and forget its subgroups)."""
    _MESH_GROUPS.clear()
    if D.is_initialized():
        D.destroy_process_group()


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` as gloo takes it: contiguous on the host, through a pinned
    buffer from a card."""
    if t.device.type == "cpu":
        return t.contiguous()
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return buf.copy_(t)


def _host_buffer(shape, dtype, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype,
                       pin_memory=like.device.type == "cuda")


def all_gather(t: torch.Tensor, group: Group) -> list[torch.Tensor]:
    """Every member's ``t`` (same shape and dtype on each), in position
    order, on ``t``'s device."""
    if group.size == 1:
        return [t]
    h = _to_host(t).reshape(-1)
    out = _host_buffer((group.size * h.numel(),), h.dtype, t)
    _ALL_GATHER(out, h, group=group.pg)
    _count("all_gather", out.numel() * out.element_size())
    out = out.to(t.device).view((group.size,) + tuple(t.shape))
    return list(out.unbind(0))


def all_to_all(parts: list[torch.Tensor], group: Group) -> list:
    """``parts[k]`` sent to member k (all of one shape and dtype); returns
    what each member sent this rank, in position order."""
    if group.size == 1:
        return list(parts)
    like = parts[0]
    h = _to_host(torch.stack(parts)).reshape(-1)
    out = _host_buffer(h.shape, h.dtype, like)
    D.all_to_all_single(out, h, group=group.pg)
    _count("all_to_all", out.numel() * out.element_size())
    return list(out.to(like.device).view((group.size,) + tuple(like.shape))
                .unbind(0))


def gather(t: torch.Tensor, group: Group, dst: int = 0) -> list | None:
    """Every member's ``t`` on member ``dst`` (a list in position order,
    on ``t``'s device); None on the others."""
    if group.size == 1:
        return [t]
    h = _to_host(t)
    here = group.index == dst
    out = ([_host_buffer(h.shape, h.dtype, t) for _ in range(group.size)]
           if here else None)
    D.gather(h, out, dst=group.ranks[dst], group=group.pg)
    if not here:
        return None
    _count("gather", sum(o.numel() * o.element_size() for o in out))
    return [o.to(t.device) for o in out]


def broadcast(t: torch.Tensor, group: Group, src: int = 0) -> torch.Tensor:
    """Member ``src``'s ``t`` on every member (a new tensor on ``t``'s
    device)."""
    if group.size == 1:
        return t
    h = _to_host(t).clone()
    D.broadcast(h, src=group.ranks[src], group=group.pg)
    _count("broadcast", h.numel() * h.element_size())
    return h.to(t.device)


def world_group() -> Group:
    """Every rank of the initialised group, in rank order: the 1-D group
    of a ``scenarios`` mesh (``launch.mesh.make_scenarios_mesh``)."""
    return Group(range(D.get_world_size()), None)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _from_bytes(buf: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    # a copy: a leaf's bytes may start at an offset its dtype cannot view
    return buf.clone().view(like.dtype).reshape(like.shape)


def all_gather_many(leaves: list[torch.Tensor], group: Group) -> list:
    """Every member's ``leaves`` (one list of shapes and dtypes on each),
    in position order, each leaf on the device of this rank's: their
    bytes packed into one buffer, so one all-gather whatever the number
    of leaves and dtypes."""
    if group.size == 1 or not leaves:
        return [list(leaves)] * group.size
    parts = [_bytes(x) for x in leaves]
    sizes = [p.numel() for p in parts]
    dev = leaves[0].device
    packed = torch.cat([p.to(dev) for p in parts])
    return [[_from_bytes(b.to(x.device), x)
             for b, x in zip(buf.split(sizes), leaves)]
            for buf in all_gather(packed, group)]


def all_to_all_v(parts: list[torch.Tensor], group: Group,
                 recv_numels: list[int]) -> list[torch.Tensor]:
    """``parts[k]`` (1-D, one dtype, any length) sent to member k;
    returns what each member sent this rank, in position order, member k's
    part ``recv_numels[k]`` elements long (the caller knows the sizes: a
    resize computes them from the shardings, so no second exchange)."""
    like = parts[0]
    if group.size == 1:
        return list(parts)
    send = [_bytes(p) for p in parts]
    h = _to_host(torch.cat(send))
    isz = like.element_size()
    out = _host_buffer((sum(recv_numels) * isz,), torch.uint8, like)
    D.all_to_all_single(out, h, [n * isz for n in recv_numels],
                        [p.numel() for p in send], group=group.pg)
    _count("all_to_all", out.numel())
    got = out.to(like.device).split([n * isz for n in recv_numels])
    return [g.view(like.dtype) for g in got]


def agree(ok: bool, group: Group, src: int = 0) -> bool:
    """Member ``src``'s ``ok`` on every member: how one rank's outcome
    (a checkpoint published or not) reaches the others."""
    return bool(broadcast(torch.tensor([int(ok)]), group, src)[0])

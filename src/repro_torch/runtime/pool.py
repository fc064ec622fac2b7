"""Global resource pool over multiple batch allocations (paper §3.1): the
port's own copy of ``repro.runtime.pool``, line for line below this
docstring (stdlib only).

The Mesos 'unified view' adapted to a fleet of accelerators: each batch
job that starts contributes an ``Allocation`` (a set of slices); the pool
presents them as one elastic inventory from which stages claim resources.
Offer/claim semantics mirror Mesos offers; revocation mirrors preemption
or node failure.

Accounting is exact: a ``Claim`` records the per-allocation breakdown
``{alloc_id: slices}`` of what it holds, so release and revocation give
back precisely the slices each allocation contributed. The pool invariant

    sum(claim.slices) == sum(claimed_per_alloc)  and
    0 <= claimed_per_alloc[a] <= alloc[a].slices for every allocation

holds after every operation (``check_invariants`` verifies it).

Allocations may carry an ``expires_at`` walltime: ``sweep_expired(now)``
lapses every allocation past its deadline, revoking its claims through
the normal ``on_revoke`` path. Claims may carry an ``expires_at`` of their
own, a **lease**: the holder keeps renewing (``renew``) or
``sweep_expired(now)`` lapses the claim as an allocation failure would.
The serving loop (``serve.loop``) leases one table slot per tenant and
refreshes the lease on every request, so a sweep revokes precisely the
tenants that went cold.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass
class Allocation:
    """One batch-system allocation (a job that started)."""
    id: int
    slices: int                  # pod slices (or nodes) granted
    expires_at: Optional[float] = None
    healthy: bool = True


@dataclass
class Claim:
    id: int
    slices: int
    # exact per-allocation breakdown of the claim — release/revoke give
    # back precisely what each allocation contributed
    alloc_slices: dict[int, int] = field(default_factory=dict)
    # lease deadline: sweep_expired(now >= expires_at) revokes the claim;
    # None = held until released/revoked (the pre-lease behavior)
    expires_at: Optional[float] = None

    @property
    def alloc_ids(self) -> list[int]:
        return list(self.alloc_slices)


class ResourcePool:
    def __init__(self):
        self._allocs: dict[int, Allocation] = {}
        self._claims: dict[int, Claim] = {}
        self._ids = itertools.count(1)
        self._claimed_per_alloc: dict[int, int] = {}
        self.on_revoke: list[Callable[[Claim], None]] = []

    # ------------------------------------------------------------- supply
    def add_allocation(self, slices: int,
                       expires_at: Optional[float] = None) -> Allocation:
        a = Allocation(next(self._ids), slices, expires_at)
        self._allocs[a.id] = a
        self._claimed_per_alloc[a.id] = 0
        return a

    def remove_allocation(self, alloc_id: int) -> list[Claim]:
        """Allocation ended/failed: revoke claims that used it.

        A revoked claim that spanned several allocations hands its slices
        back to every *surviving* allocation — the whole claim dies (its
        holder lost part of its resources), but the other allocations'
        capacity must not leak.
        """
        self._allocs.pop(alloc_id, None)
        self._claimed_per_alloc.pop(alloc_id, None)
        hit = [c for c in self._claims.values()
               if alloc_id in c.alloc_slices]
        for c in hit:
            del self._claims[c.id]
            for aid, amt in c.alloc_slices.items():
                if aid in self._claimed_per_alloc:
                    self._claimed_per_alloc[aid] -= amt
            for cb in self.on_revoke:
                cb(c)
        return hit

    def sweep_expired(self, now: float) -> list[Claim]:
        """Lapse every allocation AND every claim lease past its deadline.

        The batch system reclaimed those nodes whether we noticed or not;
        this makes the pool notice: each expired allocation leaves the
        inventory and its claims are revoked through ``on_revoke`` exactly
        as a failure would.  Expired claim leases (``Claim.expires_at``)
        are then revoked the same way — slices returned to their
        allocations, ``on_revoke`` fired once.  Returns the revoked
        claims (allocation-driven first, then lapsed leases, oldest
        deadline first — a deterministic idle-LRU order).
        """
        expired = [a.id for a in self._allocs.values()
                   if a.expires_at is not None and a.expires_at <= now]
        revoked: list[Claim] = []
        for aid in expired:
            revoked.extend(self.remove_allocation(aid))
        lapsed = sorted((c for c in self._claims.values()
                         if c.expires_at is not None
                         and c.expires_at <= now),
                        key=lambda c: (c.expires_at, c.id))
        for c in lapsed:
            self.release(c)
            for cb in self.on_revoke:
                cb(c)
            revoked.append(c)
        return revoked

    # ------------------------------------------------------------- demand
    def available(self, now: Optional[float] = None) -> int:
        if now is not None:
            self.sweep_expired(now)
        return sum(
            a.slices - self._claimed_per_alloc.get(a.id, 0)
            for a in self._allocs.values() if a.healthy)

    def claim(self, slices: int, now: Optional[float] = None,
              expires_at: Optional[float] = None) -> Optional[Claim]:
        """First-fit claim across allocations (may span several).
        ``expires_at`` makes it a lease: renew it or the next
        ``sweep_expired`` past the deadline revokes it."""
        if now is not None:
            self.sweep_expired(now)
        if slices > self.available():
            return None
        remaining = slices
        used: dict[int, int] = {}
        for a in self._allocs.values():
            if not a.healthy:
                continue
            free = a.slices - self._claimed_per_alloc[a.id]
            take = min(free, remaining)
            if take > 0:
                self._claimed_per_alloc[a.id] += take
                used[a.id] = take
                remaining -= take
            if remaining == 0:
                break
        c = Claim(next(self._ids), slices, used, expires_at=expires_at)
        self._claims[c.id] = c
        return c

    def renew(self, claim: Claim,
              expires_at: Optional[float]) -> bool:
        """Push a live lease's deadline (``None`` clears it); returns
        False when the claim is already dead — the holder learns its
        lease lapsed instead of writing to a ghost."""
        live = self._claims.get(claim.id)
        if live is None:
            return False
        live.expires_at = expires_at
        return True

    def release(self, claim: Claim) -> None:
        if claim.id not in self._claims:
            return
        del self._claims[claim.id]
        for aid, amt in claim.alloc_slices.items():
            if aid in self._claimed_per_alloc:
                self._claimed_per_alloc[aid] -= amt

    # ---------------------------------------------------------- invariant
    def check_invariants(self) -> list[str]:
        """Return violations of the pool invariant (empty ⇒ consistent)."""
        errs: list[str] = []
        claimed = sum(c.slices for c in self._claims.values())
        counted = sum(self._claimed_per_alloc.values())
        if claimed != counted:
            errs.append(f"sum(claims)={claimed} != "
                        f"sum(claimed_per_alloc)={counted}")
        for aid, amt in self._claimed_per_alloc.items():
            a = self._allocs.get(aid)
            if a is None:
                errs.append(f"claimed_per_alloc references dead alloc {aid}")
            elif not 0 <= amt <= a.slices:
                errs.append(f"alloc {aid}: claimed {amt} outside "
                            f"[0, {a.slices}]")
        for c in self._claims.values():
            if sum(c.alloc_slices.values()) != c.slices:
                errs.append(f"claim {c.id}: breakdown sums to "
                            f"{sum(c.alloc_slices.values())}, "
                            f"not {c.slices}")
            for aid in c.alloc_slices:
                if aid not in self._allocs:
                    errs.append(f"claim {c.id} references dead alloc {aid}")
        return errs

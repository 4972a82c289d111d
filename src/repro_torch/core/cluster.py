"""Sparse mapping — the paper's §III-F mechanism as a first-class object
(a copy of ``repro.core.cluster``).

A cluster is declared with ``max_slots``; slots are filled opportunistically
and may empty at any time (revocation). The object tracks:

- the slot state machine (EMPTY -> PENDING -> ACTIVE -> REVOKED -> EMPTY),
- a monotonically increasing ``membership_version`` (bumped on every
  active-set change; the elastic runtime keys jit caches & LR on it),
- deterministic data-shard ownership: the fixed shard space is
  ``max_slots`` wide and each active slot owns its own shard plus a
  round-robin share of the orphaned ones — so membership changes never
  require coordination or data movement, only re-evaluation of a pure
  function (pairs with data/pipeline.py's stateless batches).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Tuple


class SlotState(enum.Enum):
    EMPTY = "empty"
    PENDING = "pending"      # requested; provisioning
    ACTIVE = "active"
    REVOKED = "revoked"      # terminal for this occupant; slot can refill


@dataclasses.dataclass
class Slot:
    index: int
    state: SlotState = SlotState.EMPTY
    kind: Optional[str] = None        # server type occupying the slot
    region: str = "us-east1"
    joined_at_step: Optional[int] = None
    revoked_at_step: Optional[int] = None


class SparseCluster:
    def __init__(self, max_slots: int):
        if max_slots < 1:
            raise ValueError("max_slots must be >= 1")
        self.max_slots = max_slots
        self.slots: List[Slot] = [Slot(i) for i in range(max_slots)]
        self.membership_version = 0

    # -- membership transitions -------------------------------------------
    def request(self, slot: int, kind: str = "K80",
                region: str = "us-east1") -> None:
        s = self.slots[slot]
        if s.state not in (SlotState.EMPTY, SlotState.REVOKED):
            raise ValueError(f"slot {slot} is {s.state}")
        s.state, s.kind, s.region = SlotState.PENDING, kind, region

    def activate(self, slot: int, step: int) -> None:
        s = self.slots[slot]
        if s.state != SlotState.PENDING:
            raise ValueError(f"slot {slot} is {s.state}, expected PENDING")
        s.state, s.joined_at_step = SlotState.ACTIVE, step
        self.membership_version += 1

    def revoke(self, slot: int, step: int) -> None:
        s = self.slots[slot]
        if s.state != SlotState.ACTIVE:
            raise ValueError(f"slot {slot} is {s.state}, expected ACTIVE")
        s.state, s.revoked_at_step = SlotState.REVOKED, step
        self.membership_version += 1

    def fill_and_activate(self, slot: int, step: int, kind: str = "K80",
                          region: str = "us-east1") -> None:
        self.request(slot, kind, region)
        self.activate(slot, step)

    # -- views --------------------------------------------------------------
    def active_slots(self) -> List[int]:
        return [s.index for s in self.slots if s.state == SlotState.ACTIVE]

    @property
    def n_active(self) -> int:
        return len(self.active_slots())

    def active_kinds(self) -> List[str]:
        """Server kind per active slot, in slot order — the kind-vector the
        heterogeneity layer allocates over."""
        return [s.kind for s in self.slots if s.state == SlotState.ACTIVE]

    def composition(self) -> Dict[str, int]:
        """Kind -> active count (fleet summary for observations/ledgers)."""
        out: Dict[str, int] = {}
        for k in self.active_kinds():
            out[k] = out.get(k, 0) + 1
        return out

    # -- deterministic shard ownership ---------------------------------------
    def shard_assignment(self) -> Dict[int, List[int]]:
        """active slot -> list of owned data shards (fixed space: max_slots).

        Own shard first, then orphans round-robin by active rank. Total
        coverage is exactly {0..max_slots-1} with no overlap — property-
        tested in tests/test_cluster.py.
        """
        act = self.active_slots()
        if not act:
            return {}
        owned = {a: [a] for a in act}
        orphans = [i for i in range(self.max_slots) if i not in act]
        for j, shard in enumerate(orphans):
            owned[act[j % len(act)]].append(shard)
        return owned

"""Request queues for the serving engine: FIFO and SLO-aware (a copy of
``repro.serving.queue``, which never touches jax; the port keeps its own).

Two interchangeable queue disciplines behind one small interface
(``push`` / ``pop`` / ``requeue_front`` / ``drain_all`` / ``__len__``):

``FIFOQueue``  the legacy discipline on a ``collections.deque`` — O(1)
               admits (the old plain-list ``_pending.pop(0)`` was O(n)
               per admit) with ``appendleft`` re-enqueue so a revoked
               request regenerates before newly-arrived work.

``SLOQueue``   deadline/priority ordering plus admission control. Pops
               come out ordered by ``(priority, deadline_s, seq)`` —
               lower priority value first, earlier deadline first, FIFO
               within ties — regardless of push order. ``capacity``
               bounds the backlog (pushes beyond it are rejected, the
               serving analogue of load shedding), and expired requests
               (``now > deadline_s``) are dropped at pop time instead of
               burning decode slots on work that already missed its SLO.
               Requests re-admitted after a revocation (``requeue_front``)
               carry their original priority but sort ahead of same-key
               arrivals: they already paid queueing delay once.

The engine never sees the discipline — both queues mask the same way a
serving slot does, so swapping SLO scheduling in/out never touches the
decode path.
"""
from __future__ import annotations

import heapq
import itertools
import math
from collections import deque
from typing import Callable, List, Optional

from repro_torch.serving.engine import Request


class FIFOQueue:
    """Arrival-order queue on a deque; the default engine discipline."""

    def __init__(self):
        self._items: deque = deque()

    def push(self, req: Request, *, now: float = 0.0) -> bool:
        self._items.append(req)
        return True

    def requeue_front(self, req: Request) -> None:
        self._items.appendleft(req)

    def pop(self, *, now: float = 0.0) -> Optional[Request]:
        return self._items.popleft() if self._items else None

    def drain_all(self) -> List[Request]:
        out = list(self._items)
        self._items.clear()
        return out

    def __len__(self) -> int:
        return len(self._items)

    def __getitem__(self, i: int) -> Request:
        return self._items[i]

    def oldest_wait_s(self, now: float) -> float:
        """Age of the longest-waiting queued request (0.0 when empty) —
        the backlog-staleness gauge the time-series sampler polls."""
        return _oldest_wait(self._items, now)


def _oldest_wait(reqs, now: float) -> float:
    """Max queueing age across ``reqs`` on the engine clock. A request
    re-admitted after a migration keeps its ORIGINAL enqueue time — its
    user has been waiting since then, which is exactly what the gauge
    should say."""
    oldest = 0.0
    for req in reqs:
        t0 = req.timing.t_enqueue
        if t0 is None:
            t0 = req.arrival_s
        oldest = max(oldest, now - t0)
    return oldest


def _deadline_of(req: Request) -> float:
    """Effective deadline for ordering AND expiry: ``None`` means the
    request never expires (the ordering key already said so via
    ``math.inf``; the expiry comparisons must agree, or a deadline-free
    request crashes ``push``/``pop`` with a ``TypeError``)."""
    d = req.deadline_s
    return math.inf if d is None else d


class SLOQueue:
    """Deadline/priority-ordered queue with admission control.

    ``on_drop`` (optional callable) observes every request rejected at
    admission or expired at pop, so the engine can count SLO losses that
    never reached a slot.

    ``budget`` (optional) bounds the backlog by an arbitrary additive
    resource instead of request count: ``cost(req)`` (default 1 per
    request) is charged at push and released at pop/drain. With
    ``cost = pages_needed(...)`` this is page-budget admission control —
    the queue sheds load when the backlog's worst-case KV-cache demand
    exceeds the replica's page pool, not merely when slots run out.
    """

    # re-admitted requests sort ahead of fresh ones at the same
    # (priority, deadline): their seq is negated below zero
    _front = itertools.count(-1, -1)

    def __init__(self, *, capacity: Optional[int] = None,
                 drop_expired: bool = True,
                 on_drop: Optional[Callable[[Request, str], None]] = None,
                 budget: Optional[float] = None,
                 cost: Optional[Callable[[Request], float]] = None):
        if capacity is not None and capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if budget is not None and budget <= 0:
            raise ValueError(f"budget must be > 0, got {budget}")
        self.capacity = capacity
        self.drop_expired = drop_expired
        self.on_drop = on_drop
        self.budget = budget
        self._cost = cost if cost is not None else (lambda req: 1)
        self._used = 0.0
        self._heap: List = []
        self._seq = itertools.count()

    @property
    def used_budget(self) -> float:
        return self._used

    def _key(self, req: Request, seq: int):
        return (req.priority, _deadline_of(req), seq)

    def push(self, req: Request, *, now: float = 0.0) -> bool:
        if self.capacity is not None and len(self._heap) >= self.capacity:
            if self.on_drop:
                self.on_drop(req, "capacity")
            return False
        if self.drop_expired and now > _deadline_of(req):
            if self.on_drop:
                self.on_drop(req, "expired")
            return False
        c = self._cost(req)
        if self.budget is not None and self._used + c > self.budget:
            if self.on_drop:
                self.on_drop(req, "budget")
            return False
        heapq.heappush(self._heap,
                       (*self._key(req, next(self._seq)), c, req))
        self._used += c
        return True

    def requeue_front(self, req: Request) -> None:
        """Re-admit a revoked/migrated request ahead of same-key arrivals
        (never subject to capacity/budget: it was already admitted once)."""
        c = self._cost(req)
        heapq.heappush(self._heap,
                       (*self._key(req, next(SLOQueue._front)), c, req))
        self._used += c

    def pop(self, *, now: float = 0.0) -> Optional[Request]:
        while self._heap:
            *_, c, req = heapq.heappop(self._heap)
            self._used -= c
            if self.drop_expired and now > _deadline_of(req):
                if self.on_drop:
                    self.on_drop(req, "expired")
                continue
            return req
        return None

    def drain_all(self) -> List[Request]:
        out = [entry[-1] for entry in sorted(self._heap)]
        self._heap.clear()
        self._used = 0.0
        return out

    def __len__(self) -> int:
        return len(self._heap)

    def __getitem__(self, i: int) -> Request:
        return [entry[-1] for entry in sorted(self._heap)][i]

    def oldest_wait_s(self, now: float) -> float:
        """Age of the longest-waiting queued request (0.0 when empty)."""
        return _oldest_wait((entry[-1] for entry in self._heap), now)

"""Dynamic batch allocation — throughput-proportional work division.

The mechanism from "Taming Resource Heterogeneity In Distributed ML
Training With Dynamic Batching" (arXiv:2305.12213), specialized to the
sparse-mapping runtime: a synchronous step over a mixed fleet finishes
when its *slowest* member finishes, so per-slot batch shares should be
proportional to per-slot throughput, clamped to memory, and re-solved on
every membership change.

Step-time model (what the MC engine and the gym price):

    T_step = max_k  alloc_k / ex_k            (ex_k = examples/sec)

- **uniform** batching (``alloc_k = B/n``): the slowest device dominates
  and the fleet's step rate collapses to ``n * min_k(rate_k)``.
- **dynamic** batching (``alloc_k ∝ ex_k``): every device finishes
  together and the fleet recovers the sum of its members' rates —
  which is exactly the homogeneous aggregate the engine always used, so
  homogeneous fleets are bit-for-bit unchanged.

``allocate`` solves the integer allocation (water-filling under memory
caps + largest-remainder rounding, deterministic); ``aggregate_rate`` /
``aggregate_rate_batch`` (defined in ``hetero/rates.py`` so the
simulators can import them below ``repro_torch.core``, re-exported here) are
the closed forms the engines integrate (continuous shares — the
integer-rounding correction is O(1/B) and the engine's calibration is
far coarser than that). ``DynamicBatchAllocator``
is the runtime object: it watches a ``SparseCluster`` and re-solves only
when ``membership_version`` bumps, emitting the fixed-shape per-slot
example-count vector the masked train step consumes (shapes never
change — occupancy is data).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.hetero.profiles import caps_for, profile, rates_for
from repro_torch.hetero.rates import (BATCHING_MODES, _check_mode,  # noqa: F401
                                aggregate_rate, aggregate_rate_batch)


def _waterfill(weights: np.ndarray, total: int,
               caps: np.ndarray) -> np.ndarray:
    """Continuous ``total * w/sum(w)`` shares, clamped to ``caps`` with
    proportional redistribution of the clamped overflow (water-filling).
    Terminates in <= n passes: every pass fixes >= 1 slot at its cap."""
    n = weights.size
    alloc = np.zeros(n)
    fixed = np.zeros(n, dtype=bool)
    remaining = float(total)
    for _ in range(n):
        free = ~fixed
        if remaining <= 0 or not free.any():
            break
        share = remaining * weights[free] / weights[free].sum()
        over = share >= caps[free] - alloc[free]
        if not over.any():
            alloc[free] += share
            break
        hit = np.nonzero(free)[0][over]
        remaining -= float((caps[hit] - alloc[hit]).sum())
        alloc[hit] = caps[hit]
        fixed[hit] = True
    return alloc


def allocate(kinds: Sequence[str], global_batch: int, *,
             batching: str = "dynamic",
             caps: Optional[np.ndarray] = None) -> np.ndarray:
    """Integer per-slot batch allocation over the active slots.

    Guarantees (property-tested in ``tests/test_hetero.py``):
    sums exactly to ``global_batch``; non-negative; ``alloc_k <= caps_k``;
    deterministic in ``(kinds, global_batch, batching, caps)``; collapses
    to the uniform split when all kinds are equal (up to the +-1 of
    integer rounding, resolved by slot index).
    """
    _check_mode(batching)
    n = len(kinds)
    if n == 0:
        raise ValueError("no active slots to allocate over")
    if global_batch < 0:
        raise ValueError(f"global_batch must be >= 0, got {global_batch}")
    caps = caps_for(kinds) if caps is None \
        else np.asarray(caps, dtype=np.int64)
    if caps.shape != (n,):
        raise ValueError(f"caps shape {caps.shape} != ({n},)")
    if int(caps.sum()) < global_batch:
        raise ValueError(f"global batch {global_batch} exceeds fleet "
                         f"memory capacity {int(caps.sum())}")
    weights = np.ones(n) if batching == "uniform" else rates_for(kinds)
    cont = _waterfill(weights, int(global_batch), caps.astype(np.float64))
    alloc = np.floor(cont).astype(np.int64)
    short = int(global_batch) - int(alloc.sum())
    if short > 0:
        frac = cont - alloc
        # largest remainder, ties broken by slot index (stable sort)
        order = np.argsort(-frac, kind="stable")
        alloc[order[:short]] += 1
    return alloc


def step_time_s(kinds: Sequence[str], global_batch: int, *,
                batching: str = "dynamic",
                caps: Optional[np.ndarray] = None) -> float:
    """Exact synchronous step time ``max_k(alloc_k / ex_k)`` from the
    *integer* allocation — the trainer-facing number (the closed forms
    above drop the O(1/B) rounding term)."""
    alloc = allocate(kinds, global_batch, batching=batching, caps=caps)
    ex = rates_for(kinds)
    return float((alloc / ex).max())


# ---------------------------------------------------------------------------
# Runtime allocator: membership-keyed caching over a SparseCluster
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SlotAllocation:
    """One solved allocation for one membership version."""
    membership_version: int
    counts: np.ndarray            # (max_slots,) int64; 0 for inactive slots
    lr_ratio: float               # aggregate-throughput / base-throughput
    global_batch: int             # what the counts sum to (post-clamping)


class DynamicBatchAllocator:
    """Per-slot example counts for a live ``SparseCluster``, re-solved on
    every ``membership_version`` bump (and ONLY then — steady state is a
    cache hit, so the allocator adds nothing to the step hot path).

    ``cap_per_slot`` is the batch layout's physical row capacity (the
    ``per_slot`` axis of the ``(max_slots, per_slot, ...)`` batch); the
    effective per-slot cap is ``min(cap_per_slot, profile.mem_examples)``.
    If the active fleet cannot hold ``global_batch`` examples the batch
    shrinks to fleet capacity (training continues under-provisioned
    instead of dying — the transient-server way).

    ``lr_ratio`` generalizes the paper's adaptive-LR rule (C6) from
    ``n_active / base_workers`` to an aggregate-throughput ratio:
    ``sum_k ex_k / (base_workers * ex_base)``. For a homogeneous fleet of
    ``base_kind`` servers it reduces exactly to ``n_active/base_workers``.
    """

    def __init__(self, cluster, global_batch: int, *,
                 cap_per_slot: Optional[int] = None,
                 base_workers: int = 1, base_kind: str = "K80",
                 batching: str = "dynamic"):
        _check_mode(batching)
        if global_batch < 1:
            raise ValueError("global_batch must be >= 1")
        if base_workers < 1:
            raise ValueError("base_workers must be >= 1")
        self.cluster = cluster
        self.global_batch = int(global_batch)
        self.cap_per_slot = cap_per_slot
        self.base_workers = int(base_workers)
        self.base_kind = base_kind
        self.batching = batching
        self._cached: Optional[Tuple[int, np.ndarray, float, int]] = None
        self.solve_count = 0          # observability: recompute frequency

    def _solve(self) -> Tuple[np.ndarray, float, int]:
        act = self.cluster.active_slots()
        counts = np.zeros(self.cluster.max_slots, dtype=np.int64)
        if not act:
            return counts, 0.0, 0
        kinds = [self.cluster.slots[s].kind for s in act]
        caps = caps_for(kinds)
        if self.cap_per_slot is not None:
            caps = np.minimum(caps, int(self.cap_per_slot))
        batch = min(self.global_batch, int(caps.sum()))
        alloc = allocate(kinds, batch, batching=self.batching, caps=caps)
        counts[np.asarray(act)] = alloc
        ratio = float(rates_for(kinds).sum()) \
            / (self.base_workers * profile(self.base_kind).examples_per_sec)
        return counts, ratio, batch

    def allocation(self) -> SlotAllocation:
        ver = self.cluster.membership_version
        if self._cached is None or self._cached[0] != ver:
            counts, ratio, batch = self._solve()
            self._cached = (ver, counts, ratio, batch)
            self.solve_count += 1
        _, counts, ratio, batch = self._cached
        return SlotAllocation(membership_version=ver, counts=counts,
                              lr_ratio=ratio, global_batch=batch)

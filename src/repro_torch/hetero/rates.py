"""Fleet step-rate closed forms — the heterogeneity model the simulators
integrate.

A synchronous step over a mixed fleet finishes when its slowest member
finishes: ``T_step = max_k(alloc_k / rate_k)``. Under **uniform**
batching (``alloc_k = B/n``) the slowest device dominates and the fleet
rate collapses to ``n * min_k(rate_k)``; under **dynamic** batching
(``alloc_k ∝ rate_k``, the allocator's proportional shares) every device
finishes together and the fleet recovers ``sum_k(rate_k)`` — exactly the
homogeneous aggregate the engines always used, so homogeneous fleets are
unchanged under either mode.

This module is deliberately dependency-free (NumPy only): it sits below
``repro_torch.core`` in the import graph so the simulator and the batched MC
engine can import it at module top without a cycle (the profile/allocator
half of the hetero layer imports ``repro_torch.core.pricing`` and must stay
above it).
"""
from __future__ import annotations

import numpy as np

BATCHING_MODES = ("dynamic", "uniform")


def _check_mode(batching: str) -> None:
    if batching not in BATCHING_MODES:
        raise ValueError(f"unknown batching mode {batching!r}; "
                         f"expected one of {BATCHING_MODES}")


def aggregate_rate(rates: np.ndarray, batching: str = "dynamic") -> float:
    """Fleet step rate (steps/sec) from the active members' rates.

    ``dynamic``: sum (throughput-proportional shares keep every device
    busy); ``uniform``: ``n * min`` (the slowest dominates). Homogeneous
    fleets agree under both modes.
    """
    _check_mode(batching)
    r = np.asarray(rates, dtype=np.float64)
    if r.size == 0:
        return 0.0
    if batching == "uniform":
        return float(r.size * r.min())
    return float(r.sum())


def aggregate_rate_batch(active: np.ndarray, rate_w: np.ndarray,
                         batching: str = "dynamic") -> np.ndarray:
    """Vectorized ``aggregate_rate`` over a trial axis: ``active`` is
    ``(N, W)`` bool, ``rate_w`` is ``(W,)``; returns ``(N,)``."""
    _check_mode(batching)
    if batching == "dynamic":
        return (active * rate_w).sum(axis=1)
    n = active.sum(axis=1)
    slow = np.where(active, rate_w, np.inf).min(axis=1,
                                                initial=np.inf)
    return np.where(n > 0, n * np.where(np.isfinite(slow), slow, 0.0), 0.0)

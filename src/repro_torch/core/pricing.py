"""Price book and billing — paper Table II, per-second charging [15]
(a copy of ``repro.core.pricing``).

All prices in $/hr for GCE custom instances (61 GB / 4-8 vCPU GPU servers,
16 GB / 4 vCPU parameter server). ``savings_potential`` is the transient/
on-demand unit-price ratio, matching the paper's Table II column.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict


@dataclasses.dataclass(frozen=True)
class ServerType:
    name: str
    ondemand_hr: float
    transient_hr: float
    # Calibrated single-worker training rate for the paper's workload
    # (ResNet-32/Cifar-10, batch 128): steps/second. K80 = 64000 steps/3.91h.
    steps_per_sec: float
    mem_gb: int = 61
    vcpu: int = 4

    @property
    def savings_potential(self) -> float:
        return self.transient_hr / self.ondemand_hr

    def price_hr(self, transient: bool) -> float:
        return self.transient_hr if transient else self.ondemand_hr


K80_RATE = 64_000 / (3.91 * 3600)          # 4.547 steps/s  (Table I)
P100_RATE = 64_000 / (1.50 * 3600)         # 11.85 steps/s  (Table III)
V100_RATE = 64_000 / (1.23 * 3600)         # 14.45 steps/s  (Table III)

SERVER_TYPES: Dict[str, ServerType] = {
    "K80": ServerType("K80", 0.723, 0.256, K80_RATE, 61, 4),
    "P100": ServerType("P100", 1.43, 0.551, P100_RATE, 61, 8),
    "V100": ServerType("V100", 2.144, 0.861, V100_RATE, 61, 8),
    "PS": ServerType("PS", 0.143, 0.041, 0.0, 16, 4),
}

# Paper §III-A: single-K80 on-demand budget that constrains Table III.
SINGLE_K80_BUDGET = 2.83


def server_cost(kind: str, seconds: float, transient: bool) -> float:
    """Per-second billing [15]: charge exactly the active seconds."""
    if seconds < 0:
        raise ValueError(f"negative active time {seconds}")
    return SERVER_TYPES[kind].price_hr(transient) * seconds / 3600.0


def hourly_cost(kind: str, seconds: float, transient: bool) -> float:
    """Legacy hour-granularity billing (for the paper's comparison)."""
    hours = math.ceil(seconds / 3600.0) if seconds > 0 else 0
    return SERVER_TYPES[kind].price_hr(transient) * hours


def price_at(kind: str, t: float, trace=None, *,
             transient: bool = True) -> float:
    """Spot $/hr for ``kind`` at simulation time ``t`` (seconds).

    The replay hook: in the reference, a ``trace`` makes the quote
    follow the trace's piecewise-constant price path; the port has no
    trace replay yet, so a trace raises. Without one it is the static
    Table II book price. On-demand prices never float.
    """
    if not transient or trace is None:
        return SERVER_TYPES[kind].price_hr(transient)
    raise NotImplementedError(
        "price_at(..., trace=...): trace replay (traces/replay.py) is not "
        "ported to PyTorch yet; see ROADMAP.md Queue 1 item 2a")

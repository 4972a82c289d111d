"""Device profiles — per-kind throughput/memory/price, the heterogeneity
registry.

The paper's heterogeneous-cluster experiments (§III-C: K80 vs P100 vs
V100 under one budget) price servers per type but the execution stack
treated every active slot as identical. A ``DeviceProfile`` makes the
per-kind facts first-class:

- ``examples_per_sec`` — calibrated single-device training throughput on
  the paper's workload (ResNet-32/CIFAR-10, per-worker batch 128):
  ``pricing.SERVER_TYPES[kind].steps_per_sec * PAPER_BATCH``. Table I
  fixes the K80 rate (64 000 steps in 3.91 h), Table III the P100/V100
  rates — the same provenance chain as the simulator's step rates, so
  the allocator and the MC engine can never disagree on relative speed.
- ``mem_examples`` — the largest per-step batch the device can hold
  (activation memory cap for the reduced ResNet). K80 boards expose
  12 GB per GPU, P100/V100 16 GB; caps scale accordingly. At the
  paper's per-worker batch the caps never bind; they exist so dynamic
  allocation degrades gracefully when a fast device is memory-starved
  (arXiv:2305.12213's motivating case).
- prices are *wired to* ``pricing.SERVER_TYPES`` (not copied), so a
  price-book update propagates here automatically.

``register_profile`` admits custom kinds (tests register synthetic
devices); ``profile`` is the lookup every other layer uses.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Sequence

import numpy as np

from repro_torch.core import pricing

# The paper's per-worker batch size (§III-A): throughput calibration unit.
PAPER_BATCH = 128

# Per-GPU memory in GB (K80 = one 12 GB die of the dual-die board;
# P100/V100 = 16 GB HBM2). Source: GCE GPU documentation for the
# paper's custom instances.
_GPU_MEM_GB = {"K80": 12, "P100": 16, "V100": 16}

# Examples of the paper's workload that fit one training step per GB —
# fitted so a 12 GB K80 holds 8x the paper's batch with headroom.
_EXAMPLES_PER_GB = 85


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """Per-kind execution profile consumed by the batch allocator."""
    kind: str
    examples_per_sec: float       # calibrated training throughput
    mem_examples: int             # per-step batch memory cap

    def __post_init__(self):
        if self.examples_per_sec <= 0:
            raise ValueError(f"{self.kind}: examples_per_sec must be > 0")
        if self.mem_examples < 1:
            raise ValueError(f"{self.kind}: mem_examples must be >= 1")

    @property
    def steps_per_sec(self) -> float:
        """Rate in the simulator's unit (steps of ``PAPER_BATCH``)."""
        return self.examples_per_sec / PAPER_BATCH

    @property
    def price_hr(self) -> float:
        """Transient $/hr, live from the price book (never copied)."""
        return pricing.SERVER_TYPES[self.kind].transient_hr

    @property
    def ondemand_hr(self) -> float:
        return pricing.SERVER_TYPES[self.kind].ondemand_hr

    @property
    def usd_per_million_examples(self) -> float:
        """Spot $ per 1M examples — the allocator-facing efficiency view."""
        return self.price_hr / (self.examples_per_sec * 3600.0) * 1e6


def _default_registry() -> Dict[str, DeviceProfile]:
    out = {}
    for kind, st in pricing.SERVER_TYPES.items():
        if st.steps_per_sec <= 0:          # "PS" does no training compute
            continue
        mem = _GPU_MEM_GB.get(kind, 16) * _EXAMPLES_PER_GB
        out[kind] = DeviceProfile(kind=kind,
                                  examples_per_sec=st.steps_per_sec
                                  * PAPER_BATCH,
                                  mem_examples=int(mem))
    return out


DEVICE_PROFILES: Dict[str, DeviceProfile] = _default_registry()


def profile(kind: str) -> DeviceProfile:
    try:
        return DEVICE_PROFILES[kind]
    except KeyError:
        raise KeyError(f"no device profile for kind {kind!r}; known: "
                       f"{sorted(DEVICE_PROFILES)}") from None


def register_profile(p: DeviceProfile) -> None:
    """Admit a custom kind (tests / future accelerators). Idempotent for
    an identical profile; re-registering a different one replaces it."""
    DEVICE_PROFILES[p.kind] = p


def rates_for(kinds: Sequence[str]) -> np.ndarray:
    """``examples_per_sec`` vector for a slot-kind list (vectorized)."""
    return np.array([profile(k).examples_per_sec for k in kinds],
                    dtype=np.float64)


def caps_for(kinds: Sequence[str]) -> np.ndarray:
    """``mem_examples`` vector for a slot-kind list."""
    return np.array([profile(k).mem_examples for k in kinds],
                    dtype=np.int64)


def composition(kinds: Iterable[str]) -> Dict[str, int]:
    """Kind -> count summary of a fleet (ledger / observation view)."""
    out: Dict[str, int] = {}
    for k in kinds:
        out[k] = out.get(k, 0) + 1
    return out

"""Heterogeneity layer: device profiles + dynamic batch allocation (a
copy of ``repro.hetero``, numpy only; the port keeps its own because it
never imports the JAX package).

Makes mixed transient fleets (the paper's K80/P100/V100 configurations)
first-class across the stack: ``profiles`` carries the calibrated
per-kind throughput/memory/price registry, ``allocator`` solves
throughput-proportional per-slot batch shares and the fleet step-rate
model (``uniform`` = slowest-dominates, ``dynamic`` = sum-of-rates)
consumed by the simulators, the elastic runtime, the policies, and the
gym. See docs/ARCHITECTURE.md ("Heterogeneity layer").
"""
from repro_torch.hetero.allocator import (BATCHING_MODES, DynamicBatchAllocator,
                                    SlotAllocation, aggregate_rate,
                                    aggregate_rate_batch, allocate,
                                    step_time_s)
from repro_torch.hetero.profiles import (DEVICE_PROFILES, PAPER_BATCH,
                                   DeviceProfile, caps_for, composition,
                                   profile, rates_for, register_profile)

__all__ = [
    "BATCHING_MODES", "DynamicBatchAllocator", "SlotAllocation",
    "aggregate_rate", "aggregate_rate_batch", "allocate", "step_time_s",
    "DEVICE_PROFILES", "PAPER_BATCH", "DeviceProfile", "caps_for",
    "composition", "profile", "rates_for", "register_profile",
]

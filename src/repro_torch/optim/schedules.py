"""LR schedules and the paper's adaptive-LR-by-active-workers rule (C6)
(counterpart of ``repro.optim.schedules``). Plain Python floats: the
multiplier is a host scalar, no tensor is needed.

``adaptive_lr_scale`` is Fig 5's fix: the linear-scaling rule keyed to the
number of *active* workers rather than the configured maximum.
"""
from __future__ import annotations

import math
from typing import Callable

from repro_torch.config import ScheduleConfig


def make_schedule(cfg: ScheduleConfig) -> Callable[[int], float]:
    """step -> lr multiplier in [0, 1] (applied on top of the base lr)."""
    def fn(step) -> float:
        step = float(step)
        warm = min(1.0, (step + 1.0) / max(1, cfg.warmup_steps))
        if cfg.kind == "constant":
            decay = 1.0
        elif cfg.kind == "cosine":
            frac = (step - cfg.warmup_steps) / max(
                1, cfg.total_steps - cfg.warmup_steps)
            frac = min(max(frac, 0.0), 1.0)
            decay = cfg.min_ratio + (1 - cfg.min_ratio) * 0.5 * (
                1.0 + math.cos(math.pi * frac))
        elif cfg.kind == "step":
            decay = 1.0
            for b, f in zip(cfg.step_boundaries, cfg.step_factors):
                if step >= b:
                    decay = f
        else:
            raise ValueError(cfg.kind)
        return warm * decay

    return fn


def adaptive_lr_scale(active_workers, base_workers: int = 1,
                      adaptive: bool = True,
                      configured_workers: int = 1) -> float:
    """Linear-scaling-rule multiplier.

    adaptive=True  -> scale by the number of currently ACTIVE workers (C6).
    adaptive=False -> the naive TF behaviour: scale by the CONFIGURED
                      (maximum-slot) worker count regardless of how many
                      are actually alive.
    """
    if adaptive:
        return float(active_workers) / base_workers
    return float(configured_workers) / base_workers

"""Transient-server model: lifetimes, revocation warnings, server state
(a copy of ``repro.core.transient``: numpy only, so one
``np.random.Generator`` gives the same samples in both packages).

Lifetime distributions are calibrated to the paper's measurements:

- Fig 3 (GCE preemptible GPU lifetime CDF, >600 servers): ~20% revoked
  within the first 2 h, ~70% survive to the 24 h hard cap, the remaining
  ~10% spread over (2 h, 24 h).
- Per-type *early* revocation rates during training (Tables I & III):
  K80: 13/128 workers revoked within ~1.05 h  ->  P(L < 1.05h) ~ 0.10
  P100: 2/32 revoked within 1.50 h            ->  P(L < 1.50h) ~ 0.0666
  V100: 14/32 revoked within 1.23 h           ->  P(L < 1.23h) ~ 0.438

We model each type's lifetime as a three-part mixture: an early-phase
exponential (mass ``p_early`` within ``early_window``), a uniform middle,
and an atom at the 24 h cap (mass ``p_cap``). GCE semantics: a 30-second
warning precedes revocation; the 24 h cap always revokes.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np

MAX_LIFETIME_S = 24 * 3600.0
GCE_WARNING_S = 30.0
EC2_WARNING_S = 120.0


@dataclasses.dataclass(frozen=True)
class LifetimeModel:
    """Mixture lifetime distribution for one server type."""
    p_early: float          # mass revoked within early_window
    early_window: float     # seconds
    p_cap: float            # mass surviving to the 24h cap
    # middle mass = 1 - p_early - p_cap, uniform on (early_window, cap)

    def sample(self, rng: np.random.Generator, n: int = 1) -> np.ndarray:
        u = rng.uniform(size=n)
        out = np.empty(n)
        # early: exact inverse-CDF of an exponential truncated to the window
        early = u < self.p_early
        scale = self.early_window / 3.0            # ~95% of early mass in window
        ue = rng.uniform(size=n)
        trunc = 1.0 - np.exp(-self.early_window / scale)
        out[early] = -scale * np.log(1.0 - ue[early] * trunc)
        cap = u >= 1.0 - self.p_cap
        out[cap] = MAX_LIFETIME_S
        mid = ~early & ~cap
        out[mid] = rng.uniform(self.early_window, MAX_LIFETIME_S, size=n)[mid]
        return out

    def p_revoked_by(self, t: float) -> float:
        """Analytic CDF at time t (used by the budget planner)."""
        if t <= 0:
            return 0.0
        if t >= MAX_LIFETIME_S:
            return 1.0
        scale = self.early_window / 3.0
        if t < self.early_window:
            # truncated-exponential early phase
            frac = (1 - np.exp(-t / scale)) / (1 - np.exp(-self.early_window / scale))
            return self.p_early * float(frac)
        mid_mass = 1.0 - self.p_early - self.p_cap
        mid_frac = (t - self.early_window) / (MAX_LIFETIME_S - self.early_window)
        return self.p_early + mid_mass * float(mid_frac)


class EmpiricalLifetime:
    """Lifetime distribution defined by observed samples (trace replay).

    Bootstrap-resamples the observation vector; ``p_revoked_by`` is the
    empirical CDF. Shares ``sample``/``p_revoked_by`` with
    ``LifetimeModel`` so the planner and the replay path are
    interchangeable consumers.
    """

    def __init__(self, samples_s: np.ndarray):
        samples = np.asarray(samples_s, dtype=np.float64)
        if samples.ndim != 1 or samples.size == 0:
            raise ValueError("need a non-empty 1-D sample vector")
        if (samples <= 0).any():
            raise ValueError("lifetimes must be positive")
        self.samples = np.minimum(samples, MAX_LIFETIME_S)

    def sample(self, rng: np.random.Generator, n: int = 1) -> np.ndarray:
        return self.samples[rng.integers(self.samples.size, size=n)]

    def p_revoked_by(self, t: float) -> float:
        return float(np.mean(self.samples <= t))


# Calibration: match the per-type early-revocation observations above while
# keeping the aggregate Fig-3 shape (~70% reach the cap).
LIFETIMES = {
    # K80 reconciles Table I (13/128 ~ 10% within 1.05 h) with Table III
    # (28/448 ~ 6.25% across 0.5-2.2 h runs): p_early = 0.09 sits between.
    "K80": LifetimeModel(p_early=0.09, early_window=1.2 * 3600, p_cap=0.72),
    "P100": LifetimeModel(p_early=0.075, early_window=1.7 * 3600, p_cap=0.75),
    "V100": LifetimeModel(p_early=0.45, early_window=1.4 * 3600, p_cap=0.40),
    "PS": LifetimeModel(p_early=0.10, early_window=2.0 * 3600, p_cap=0.72),
}


class ServerState(enum.Enum):
    PENDING = "pending"          # requested, not yet fulfilled
    RUNNING = "running"
    WARNED = "warned"            # inside the 30 s revocation window
    REVOKED = "revoked"
    RELEASED = "released"        # returned by the customer


@dataclasses.dataclass
class TransientServer:
    """One cloud server instance participating in training."""
    kind: str                    # "K80" | "P100" | "V100" | "PS"
    transient: bool
    region: str = "us-east1"
    start_s: float = 0.0         # provisioned time (sim clock)
    lifetime_s: float = MAX_LIFETIME_S
    state: ServerState = ServerState.RUNNING
    end_s: Optional[float] = None  # revoked/released time

    @property
    def revoke_s(self) -> Optional[float]:
        """Absolute revocation time (None for on-demand)."""
        if not self.transient:
            return None
        return self.start_s + self.lifetime_s

    def active_seconds(self, now: float) -> float:
        end = self.end_s if self.end_s is not None else now
        return max(0.0, min(end, now) - self.start_s)


def provision(kind: str, *, transient: bool, rng: np.random.Generator,
              now: float = 0.0, region: str = "us-east1",
              provisioning_delay_s: float = 0.0) -> TransientServer:
    life = LIFETIMES[kind].sample(rng, 1)[0] if transient else np.inf
    return TransientServer(kind=kind, transient=transient, region=region,
                           start_s=now + provisioning_delay_s,
                           lifetime_s=float(life))

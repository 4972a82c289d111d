"""Replica autoscaling: ``core.policy.Policy`` reused for serving
(counterpart of ``repro.serving.autoscale``).

The planning layer's policy machinery (incumbent bookkeeping, decision
log, hysteresis in the strategy hook) is market-agnostic — ``Policy.act``
only needs a frozen-dataclass observation with a ``current`` field. Here
the observation is serving load instead of spot prices, and the decision
is a replica count instead of a fleet composition: the same controller
shape the paper's redesign argues for (observe conditions, replan the
cluster), pointed at inference.

``ReplicaAutoscaler`` targets a slot-utilization band: scale up when
utilization (or queue backlog per replica) runs hot, scale down when the
fleet idles — with multiplicative hysteresis so a bursty arrival trace
does not thrash replicas through prefill-replay churn the way price noise
would thrash training fleets through rejoin overhead.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

from repro_torch.core.policy import Policy

# alert kinds that demand MORE capacity (matches obs/slo.ALERT_*; string
# literals so this module stays importable without the obs package)
_SCALE_UP_ALERTS = ("slo_burn", "revocation_storm", "pool_exhaustion")


@dataclasses.dataclass(frozen=True)
class ServeLoad:
    """Current-conditions observation for a serving fleet."""
    t_s: float
    utilization: float            # mean active_slots / max_batch, live fleet
    queue_depth: int              # queued requests across the fleet
    n_replicas: int               # live (non-draining) replicas
    slots_per_replica: int
    current: Optional["ReplicaDecision"] = None
    # hot SLO-monitor alerts (obs/slo.Alert or plain kind strings): the
    # measured-health channel, first-class alongside instantaneous load
    alerts: Tuple = ()


@dataclasses.dataclass(frozen=True)
class ReplicaDecision:
    n_replicas: int

    @property
    def label(self) -> str:
        return f"{self.n_replicas}r"


class ReplicaAutoscaler(Policy):
    """Keep utilization inside [low, high] by replanning replica counts.

    The demand estimate is (busy slots + queued work) / slots-per-replica;
    the decision is that demand divided by ``target_util``, clamped to
    [min_replicas, max_replicas]. Hysteresis: the incumbent survives
    unless the target differs by more than ``deadband`` replicas — the
    serving analogue of GreedyCheapest's switch margin.

    Hot SLO-monitor alerts (``ServeLoad.alerts``) override the load
    math: an active burn / revocation-storm / pool-exhaustion alert
    means measured health is ALREADY failing, so the fleet grows by at
    least one replica and the deadband is bypassed — hysteresis exists
    to suppress noise, and a multi-window burn rate is by construction
    not noise.
    """

    def __init__(self, *, min_replicas: int = 1, max_replicas: int = 8,
                 target_util: float = 0.75, deadband: int = 0):
        super().__init__()
        if not (0.0 < target_util <= 1.0):
            raise ValueError(f"target_util must be in (0, 1], "
                             f"got {target_util}")
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError("need 1 <= min_replicas <= max_replicas")
        self.name = f"replica-autoscaler({target_util:.2f})"
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.target_util = target_util
        self.deadband = deadband

    @staticmethod
    def _alert_kinds(obs: ServeLoad) -> Tuple[str, ...]:
        return tuple(a if isinstance(a, str) else a.kind
                     for a in obs.alerts)

    def decide(self, obs: ServeLoad, ctx=None) -> ReplicaDecision:
        busy = obs.utilization * obs.n_replicas * obs.slots_per_replica
        demand_slots = busy + obs.queue_depth
        want = math.ceil(demand_slots
                         / (obs.slots_per_replica * self.target_util)) \
            if demand_slots > 0 else self.min_replicas
        want = max(self.min_replicas, min(self.max_replicas, want))
        kinds = self._alert_kinds(obs)
        scale_up_alert = any(k in _SCALE_UP_ALERTS for k in kinds)
        cur = obs.current.n_replicas if obs.current is not None else None
        base = cur if cur is not None else obs.n_replicas
        if scale_up_alert:
            # measured SLO failure: grow by >= 1 regardless of what the
            # instantaneous load math says, capped at max_replicas
            want = min(self.max_replicas, max(want, base + 1))
        self.last_scores = {"demand_slots": float(demand_slots),
                            "target": float(want),
                            "alerts": float(len(kinds))}
        if cur is not None and not scale_up_alert \
                and abs(want - cur) <= self.deadband:
            want = cur
        return ReplicaDecision(n_replicas=want)

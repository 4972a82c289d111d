"""Multi-replica serving fleet on transient servers (counterpart of
``repro.serving.cluster``).

``ServeCluster`` is the serving counterpart of the training cluster in
``core/cluster.py``: N ``ServeEngine`` replicas behave like N transient
servers — they can be warned (drain + migrate via prefix replay), revoked
outright (from-scratch regeneration elsewhere), and added/removed by an
autoscaler mid-workload. All replicas share one model + params and the
SAME step callables (``ServeEngine.shared_fns``) and one parameter tree
on the card, so scaling a replica up costs a cache allocation, never a
copy of the weights.

Routing is least-loaded (active slots + queue depth); a drained or
revoked replica's displaced requests re-route through the same picker.
``replica_seconds`` integrates live-replica time on the engine clock —
the cost axis the serve-frontier benchmark prices, exactly how the
training benchmarks price worker-seconds.
"""
from __future__ import annotations

import warnings
from typing import Callable, List, Optional

from repro_torch import obs
from repro_torch.serving.engine import Request, ServeEngine


class ServeCluster:
    def __init__(self, make_engine: Callable[[], ServeEngine], *,
                 n_replicas: int = 1,
                 clock: Optional[Callable[[], float]] = None,
                 recorder: Optional[obs.Recorder] = None,
                 monitor=None):
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        self._make_engine = make_engine
        self.replicas: List[ServeEngine] = []
        self.retired: List[ServeEngine] = []   # drained/revoked, kept for stats
        self.rec = recorder if recorder is not None else obs.NULL
        self.monitor = monitor                 # optional SLOMonitor, shared
        self._next_rid = 0                     # replica ids: stable, never reused
        first = make_engine()
        self.clock = clock if clock is not None else first.clock
        self._adopt(first)
        for _ in range(n_replicas - 1):
            self._adopt(self._make_engine())
        self._replica_seconds = 0.0
        self._t_last_bill = self.clock()

    def _adopt(self, eng: ServeEngine) -> None:
        """Join a replica to the fleet: assign its stable replica_id (it
        prefixes the engine's event tracks, so the merged timeline keeps
        one lane per replica incarnation) and propagate the cluster's
        recorder/monitor to engines that brought none of their own — one
        Recorder + one SLOMonitor observe the WHOLE fleet, which is what
        makes cross-replica trace merging and fleet-level burn rates
        possible."""
        eng.replica_id = self._next_rid
        self._next_rid += 1
        if not eng.rec.enabled and self.rec.enabled:
            eng.rec = self.rec
        if eng.monitor is None:
            eng.monitor = self.monitor
        self.replicas.append(eng)

    def _bill(self) -> None:
        """Integrate replica-time up to now (call before membership
        changes so the integrand is piecewise-exact)."""
        now = self.clock()
        self._replica_seconds += len(self.replicas) \
            * (now - self._t_last_bill)
        self._t_last_bill = now

    @property
    def replica_seconds(self) -> float:
        """∫ live_replicas dt on the cluster clock, up to now — the cost
        axis the serve-frontier benchmark prices into replica-hours."""
        self._bill()
        return self._replica_seconds

    @property
    def n_replicas(self) -> int:
        return len(self.replicas)

    # -- routing -------------------------------------------------------------
    def _pick(self, req: Optional[Request] = None) -> ServeEngine:
        live = [e for e in self.replicas if not e.draining]
        if not live:
            raise RuntimeError("no live replicas: every engine is draining")
        if req is not None:
            # page-budget-aware routing: prefer replicas that could admit
            # this request's worst-case page demand right now, so one
            # replica's full pool spills load to its siblings instead of
            # queueing behind it (dense engines always report headroom)
            fits = [e for e in live if e.admission_headroom(req)]
            if fits:
                live = fits
        return min(live, key=lambda e: (e.n_active + len(e.queue),
                                        e.page_utilization))

    def submit(self, req: Request) -> bool:
        return self._pick(req).submit(req)

    def _reroute(self, displaced: List[Request]) -> int:
        """Resubmit displaced work through the normal picker. Returns the
        number re-admitted (the rest were shed by admission control).
        Requests carrying a cache pack (paged drain) go first to a
        replica that can land the pack — page-table transfer instead of
        prefix replay; ``submit`` falls back to replay automatically when
        no replica can place it."""
        n = 0
        for req in displaced:
            if req._pack is not None:
                target = next((e for e in self.replicas
                               if e.can_import(req)), None)
                if target is not None:
                    n += bool(target.submit(req))
                    continue
            n += bool(self._pick(req).submit(req))
        return n

    # -- revocation ----------------------------------------------------------
    def warn(self, idx: int, *, grace_tokens: int = 4) -> int:
        """Provider warning for replica ``idx``: drain it and prefix-replay
        its long decodes onto the survivors. The drained engine keeps
        stepping (and being billed) until its grace decodes finish; call
        ``reap`` to retire it once ``drain_complete``."""
        self._bill()
        eng = self.replicas[idx]
        migrated = eng.begin_drain(grace_tokens=grace_tokens)
        if self.rec.enabled:
            rid = eng.replica_id if eng.replica_id is not None else idx
            self.rec.instant(obs.EV_DRAIN, cat=obs.CAT_SERVE,
                             track=f"replica{rid}", sim_t=self.clock(),
                             migrated=len(migrated))
        # route around the doomed replica: it refuses admission already
        return self._reroute(migrated)

    def revoke(self, idx: int) -> int:
        """Replica ``idx`` revoked with no usable warning: in-flight work
        loses its decode state and regenerates from scratch elsewhere."""
        self._bill()
        eng = self.replicas.pop(idx)
        displaced = eng.hard_revoke()
        self.retired.append(eng)
        return self._reroute(displaced)

    def reap(self) -> int:
        """Retire drained replicas whose grace decodes finished. Returns
        how many were removed from the billed fleet."""
        done = [e for e in self.replicas if e.drain_complete]
        if not done:
            return 0
        self._bill()
        self.replicas = [e for e in self.replicas if not e.drain_complete]
        self.retired.extend(done)
        return len(done)

    # -- autoscaling ---------------------------------------------------------
    def scale_to(self, n: int) -> int:
        """Reconcile the live-replica count to ``n``: grow with fresh
        engines (shared step callables), shrink by draining the least-loaded
        replicas (graceful, never a hard revoke). Returns the delta."""
        if n < 1:
            raise ValueError("cannot scale below 1 replica")
        live = [e for e in self.replicas if not e.draining]
        delta = n - len(live)
        if delta > 0:
            self._bill()
            for _ in range(delta):
                self._adopt(self._make_engine())
        elif delta < 0:
            victims = sorted(live, key=lambda e: e.n_active + len(e.queue))
            for eng in victims[:-delta]:
                # _observe=False: a voluntary shrink must not feed the
                # monitor's revocation-storm window (alert feedback loop)
                self._reroute(eng.begin_drain(grace_tokens=0,
                                              _observe=False))
        return delta

    # -- stepping ------------------------------------------------------------
    def step(self) -> None:
        for eng in list(self.replicas):
            eng.step()
        self.reap()

    def has_work(self) -> bool:
        return any(e.has_work() for e in self.replicas)

    def run_to_completion(self, max_steps: int = 10_000,
                          on_budget: str = "raise") -> int:
        steps = 0
        while self.has_work() and steps < max_steps:
            self.step()
            steps += 1
        self._bill()
        if self.has_work():
            msg = (f"cluster run_to_completion exhausted max_steps="
                   f"{max_steps} with work remaining")
            if on_budget == "raise":
                raise RuntimeError(msg)
            if on_budget == "warn":
                warnings.warn(msg, RuntimeWarning, stacklevel=2)
        return steps

    # -- fleet stats ---------------------------------------------------------
    @property
    def load(self) -> float:
        """Mean slot utilization over live replicas (autoscaler signal)."""
        live = [e for e in self.replicas if not e.draining]
        if not live:
            return 0.0
        return sum(e.n_active / e.max_batch for e in live) / len(live)

    @property
    def queue_depth(self) -> int:
        return sum(len(e.queue) for e in self.replicas)

    def _sum(self, attr: str) -> int:
        return sum(getattr(e, attr)
                   for e in self.replicas + self.retired)

    @property
    def tokens_decoded(self) -> int:
        return self._sum("tokens_decoded")

    @property
    def tokens_lost(self) -> int:
        return self._sum("tokens_lost")

    @property
    def tokens_replayed(self) -> int:
        return self._sum("tokens_replayed")

    @property
    def requests_rejected(self) -> int:
        return self._sum("requests_rejected")

    @property
    def pages_shipped(self) -> int:
        return self._sum("pages_shipped")

    @property
    def requests_imported(self) -> int:
        return self._sum("requests_imported")

    def replica_summaries(self) -> List[dict]:
        """One stats dict per replica ever billed (live + retired), in
        replica_id order — the ops report's per-replica table."""
        rows = []
        for eng in self.replicas + self.retired:
            rows.append({
                "replica": eng.replica_id,
                "state": ("draining" if eng.draining and eng.has_work()
                          else "retired" if eng in self.retired
                          else "live"),
                "tokens_decoded": eng.tokens_decoded,
                "tokens_lost": eng.tokens_lost,
                "tokens_replayed": eng.tokens_replayed,
                "requests_rejected": eng.requests_rejected,
                "pages_shipped": eng.pages_shipped,
                "requests_imported": eng.requests_imported,
                "peak_pages": (eng.allocator.peak_used
                               if eng.allocator is not None else 0),
            })
        rows.sort(key=lambda r: (r["replica"] is None, r["replica"]))
        return rows

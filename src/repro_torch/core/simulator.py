"""Event-driven transient-cluster training simulator.

A copy of ``repro.core.simulator``: the same code and the same numpy draws in the
same order, so one seed gives the same numbers in both packages.

Reproduces the paper's measured artifacts (Tables I, III, IV, V; Figs 5, 6,
8) from first principles plus a small set of calibration constants, all
taken from the paper itself:

- per-type single-worker training rates (``pricing.SERVER_TYPES``),
- per-type lifetime distributions (``transient.LIFETIMES``),
- a parameter-server capacity model (Fig 6: V100 clusters plateau at 4
  workers with one PS; 2 PS recovers up to 1.75x),
- a WAN penalty for workers in a different region than the PS (Fig 8:
  up to 48% slowdown, no extra penalty for 3 regions vs 2),
- a join overhead for dynamic (sparse-mapping) clusters (Fig 5),
- the paper's own K80 accuracy anchors vs cluster size (async staleness).

The simulator integrates piecewise-constant aggregate step rates between
events (revocations, dynamic joins, completion), bills per-second, and
reports the same metrics the paper does: time, cost, accuracy, revocations.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import pricing
from repro_torch.core.transient import (GCE_WARNING_S, LIFETIMES, TransientServer,
                                  provision)
from repro_torch.hetero.rates import aggregate_rate

# --- calibration constants (sources in module docstring) -------------------
PS_RATE_STEPS_S = 60.0          # service capacity per parameter server
PS_CONTENTION_K = 4.0           # smoothness of the saturation curve
WAN_RATE_FACTOR = 0.35          # remote worker's effective rate multiplier
JOIN_OVERHEAD_S = 810.0         # provisioning + cluster-reconfig per join
DEFAULT_TOTAL_STEPS = 64_000    # the paper's workload

# Paper accuracy anchors: K80 clusters, r=0, async training (Tables I/III/IV)
ACC_ANCHORS = {1: 93.07, 2: 91.90, 4: 91.06, 8: 88.65}


def ps_capped_rate(sum_rate: float, n_ps: int) -> float:
    """Aggregate cluster step rate under PS capacity contention (Fig 6).

    ``n_ps == 0`` means single-server training (no gradient exchange)."""
    if sum_rate <= 0:
        return 0.0
    if n_ps == 0:
        return sum_rate
    cap = n_ps * PS_RATE_STEPS_S
    return sum_rate / (1.0 + (sum_rate / cap) ** PS_CONTENTION_K) ** (1.0 / PS_CONTENTION_K)


def accuracy_model(avg_workers: float, *, dynamic: bool = False,
                   adaptive_lr: bool = True) -> float:
    """Converged top-1 accuracy vs time-weighted average worker count.

    Piecewise-linear in log2(W) through the paper's anchors; staleness in
    async PS training grows with the number of concurrent contributors,
    so a mid-run revocation *raises* expected accuracy (paper §III-D).
    Dynamic clusters with a naive LR lose 1.17%; adaptive LR recovers ~1%
    (Fig 5).
    """
    w = max(1.0, avg_workers)
    xs = sorted(ACC_ANCHORS)
    lx = math.log2(w)
    pts = [(math.log2(k), v) for k, v in sorted(ACC_ANCHORS.items())]
    if lx <= pts[0][0]:
        acc = pts[0][1]
    elif lx >= pts[-1][0]:
        # extrapolate from the last segment
        (x0, y0), (x1, y1) = pts[-2], pts[-1]
        acc = y1 + (y1 - y0) / (x1 - x0) * (lx - x1)
    else:
        acc = None
        for (x0, y0), (x1, y1) in zip(pts, pts[1:]):
            if x0 <= lx <= x1:
                acc = y0 + (y1 - y0) * (lx - x0) / (x1 - x0)
                break
    if dynamic:
        acc -= 1.17 if not adaptive_lr else 0.17
    return acc


# ---------------------------------------------------------------------------
# Cluster specification
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WorkerSpec:
    kind: str = "K80"
    transient: bool = True
    region: str = "us-east1"
    join_step: int = 0          # sparse mapping: slot filled when the
                                # cluster's cumulative steps cross this


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    workers: Tuple[WorkerSpec, ...]
    n_ps: int = 1
    ps_transient: bool = False   # paper uses an on-demand PS
    ps_region: str = "us-east1"
    total_steps: int = DEFAULT_TOTAL_STEPS
    adaptive_lr: bool = True
    master_failover: bool = False   # False = paper's TF behaviour (master
                                    # revocation kills the job); True = our
                                    # redesigned master-less checkpointing
    batching: str = "dynamic"    # mixed-fleet work division (hetero layer):
                                 # "dynamic" = throughput-proportional
                                 # shares (fleet rate = sum of rates),
                                 # "uniform" = equal shares (the slowest
                                 # device dominates: n * min rate).
                                 # Homogeneous fleets agree under both.

    @staticmethod
    def homogeneous(kind: str, n: int, *, transient: bool = True,
                    n_ps: Optional[int] = None,
                    total_steps: int = DEFAULT_TOTAL_STEPS,
                    master_failover: bool = False) -> "ClusterSpec":
        if n_ps is None:
            n_ps = 0 if n == 1 else 1     # single-server training has no PS
        return ClusterSpec(
            workers=tuple(WorkerSpec(kind, transient) for _ in range(n)),
            n_ps=n_ps, total_steps=total_steps,
            master_failover=master_failover)

    @staticmethod
    def mixed(counts, *, batching: str = "dynamic", transient: bool = True,
              n_ps: Optional[int] = None,
              total_steps: int = DEFAULT_TOTAL_STEPS,
              master_failover: bool = False) -> "ClusterSpec":
        """Heterogeneous fleet from ``{kind: count}`` (or ``(kind, count)``
        pairs); slot order follows the mapping's iteration order, so the
        first listed kind provides the master slot."""
        pairs = list(counts.items()) if isinstance(counts, dict) \
            else list(counts)
        workers = tuple(WorkerSpec(kind, transient)
                        for kind, n in pairs for _ in range(n))
        if not workers:
            raise ValueError("mixed fleet has no workers")
        if n_ps is None:
            n_ps = 0 if len(workers) == 1 else 1
        return ClusterSpec(workers=workers, n_ps=n_ps,
                           total_steps=total_steps,
                           master_failover=master_failover,
                           batching=batching)

    def fleet_label(self) -> str:
        """Human label like ``2xK80+2xV100`` (kind order of first use)."""
        comp: Dict[str, int] = {}
        for w in self.workers:
            comp[w.kind] = comp.get(w.kind, 0) + 1
        return "+".join(f"{n}x{k}" for k, n in comp.items())


@dataclasses.dataclass
class RunResult:
    completed: bool
    failure: Optional[str]            # "master_revoked" | "all_revoked" | ...
    time_h: float
    cost_usd: float
    accuracy: float
    revocations: int                  # non-fatal worker revocations
    steps_done: int
    avg_active_workers: float
    worker_lifetimes_h: List[float]   # observed (capped at run end)

    def as_row(self) -> Dict[str, float]:
        return {"time_h": self.time_h, "cost": self.cost_usd,
                "acc": self.accuracy, "r": self.revocations,
                "completed": float(self.completed)}


# ---------------------------------------------------------------------------
# The simulator
# ---------------------------------------------------------------------------

def _worker_rate(w: WorkerSpec, ps_region: str) -> float:
    r = pricing.SERVER_TYPES[w.kind].steps_per_sec
    if w.region != ps_region:
        r *= WAN_RATE_FACTOR
    return r


def simulate_run(spec: ClusterSpec, rng: np.random.Generator) -> RunResult:
    """One Monte-Carlo training run of ``spec`` to ``total_steps``."""
    servers: List[Optional[TransientServer]] = []
    active: List[bool] = []
    joined: List[bool] = []
    for w in spec.workers:
        if w.join_step == 0:
            servers.append(provision(w.kind, transient=w.transient, rng=rng,
                                     now=0.0, region=w.region))
            active.append(True)
            joined.append(True)
        else:
            servers.append(None)      # slot not yet filled (sparse mapping)
            active.append(False)
            joined.append(False)

    ps_servers = [provision("PS", transient=spec.ps_transient, rng=rng, now=0.0,
                            region=spec.ps_region) for _ in range(spec.n_ps)]

    t = 0.0
    steps = 0.0
    revocations = 0
    failure = None
    worker_time_integral = 0.0        # ∫ active_workers dt
    pending_joins: List[Tuple[int, float]] = []   # (slot index, activation t)

    def agg_rate() -> float:
        # hetero layer: uniform batching on a mixed fleet is dominated by
        # its slowest member (T_step = max_k alloc_k/rate_k); dynamic
        # batching recovers the sum of rates. Homogeneous fleets agree.
        rates = [_worker_rate(spec.workers[i], spec.ps_region)
                 for i in range(len(spec.workers))
                 if active[i] and servers[i] is not None]
        return ps_capped_rate(aggregate_rate(np.array(rates), spec.batching),
                              spec.n_ps)

    guard = 0
    while steps < spec.total_steps:
        guard += 1
        if guard > 10_000:
            failure = "no_progress"
            break
        rate = agg_rate()
        n_active = sum(active)

        # --- candidate next events -------------------------------------
        events: List[Tuple[float, str, int]] = []
        for i, srv in enumerate(servers):
            if srv is not None and active[i] and srv.transient:
                events.append((srv.revoke_s, "revoke", i))
        for ps in ps_servers:
            if ps.transient:
                events.append((ps.revoke_s, "ps_revoke", -1))
        for slot, t_act in pending_joins:
            events.append((t_act, "join_active", slot))
        # sparse-mapping slots triggered by step thresholds
        if rate > 0:
            for i, w in enumerate(spec.workers):
                if not joined[i] and steps < w.join_step:
                    t_cross = t + (w.join_step - steps) / rate
                    events.append((t_cross, "join_request", i))
            events.append((t + (spec.total_steps - steps) / rate, "done", -1))
        elif not pending_joins:
            failure = "all_revoked"
            break

        t_next, what, idx = min(events, key=lambda e: e[0])
        dt = max(0.0, t_next - t)
        steps += rate * dt
        worker_time_integral += n_active * dt
        t = t_next

        if what == "done":
            steps = spec.total_steps
            break
        if what == "revoke":
            servers[idx].end_s = t
            servers[idx].state = servers[idx].state.__class__.REVOKED
            active[idx] = False
            if idx == 0 and not spec.master_failover:
                failure = "master_revoked"
                break
            revocations += 1
        elif what == "ps_revoke":
            failure = "ps_revoked"
            break
        elif what == "join_request":
            joined[idx] = True
            pending_joins.append((idx, t + JOIN_OVERHEAD_S))
        elif what == "join_active":
            pending_joins = [(s, ta) for s, ta in pending_joins if s != idx]
            w = spec.workers[idx]
            servers[idx] = provision(w.kind, transient=w.transient, rng=rng,
                                     now=t, region=w.region)
            active[idx] = True

    completed = failure is None and steps >= spec.total_steps

    # --- billing (per-second, paper [15]) -------------------------------
    cost = 0.0
    lifetimes_h = []
    for i, srv in enumerate(servers):
        if srv is None:
            continue
        secs = srv.active_seconds(t)
        cost += pricing.server_cost(srv.kind, secs, srv.transient)
        lifetimes_h.append(secs / 3600.0)
    for ps in ps_servers:
        cost += pricing.server_cost("PS", ps.active_seconds(t), ps.transient)

    avg_w = worker_time_integral / t if t > 0 else 0.0
    dynamic = any(w.join_step > 0 for w in spec.workers)
    acc = accuracy_model(avg_w, dynamic=dynamic, adaptive_lr=spec.adaptive_lr) \
        if completed else float("nan")

    return RunResult(completed=completed, failure=failure, time_h=t / 3600.0,
                     cost_usd=cost, accuracy=acc, revocations=revocations,
                     steps_done=int(steps), avg_active_workers=avg_w,
                     worker_lifetimes_h=lifetimes_h)


# ---------------------------------------------------------------------------
# Monte-Carlo aggregation (the paper repeats each configuration 32x; the
# batched engine in core/mc.py makes >=1024 trials the cheap default)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Summary:
    n_runs: int
    n_completed: int
    failure_rate: float
    revocation_counts: Dict[int, int]          # r -> number of clusters
    time_h: Tuple[float, float]                # (mean, std) over completed
    cost: Tuple[float, float]
    acc: Tuple[float, float]
    by_r: Dict[int, Dict[str, Tuple[float, float]]]
    results: List[RunResult]

    def row(self, key: str) -> Tuple[float, float]:
        return getattr(self, key)

    def ci95(self, key: str) -> float:
        """95% CI half-width of the mean of ``key`` over completed runs."""
        _, std = getattr(self, key)
        return ci95_halfwidth(std, self.n_completed)

    # -- schema seam (shared with gym ledgers and benchmark goldens) --------

    def to_dict(self) -> Dict:
        """JSON-safe aggregate view (drops the per-run ``results``).

        This is THE reporting schema: the batched engine, the legacy loop,
        and the gym ledger all aggregate into it, so benchmarks and golden
        tests consume one shape instead of hand-rolled dict keys. Pinned
        lossless (modulo ``results``) by a round-trip test.
        """
        return {
            "n_runs": self.n_runs,
            "n_completed": self.n_completed,
            "failure_rate": self.failure_rate,
            "revocation_counts": {str(k): v
                                  for k, v in self.revocation_counts.items()},
            "time_h": list(self.time_h),
            "cost": list(self.cost),
            "acc": list(self.acc),
            "by_r": {str(r): {k: list(v) for k, v in d.items()}
                     for r, d in self.by_r.items()},
        }

    @staticmethod
    def from_dict(d: Dict) -> "Summary":
        """Inverse of ``to_dict``; ``results`` comes back empty."""
        return Summary(
            n_runs=int(d["n_runs"]),
            n_completed=int(d["n_completed"]),
            failure_rate=float(d["failure_rate"]),
            revocation_counts={int(k): int(v)
                               for k, v in d["revocation_counts"].items()},
            time_h=tuple(d["time_h"]),
            cost=tuple(d["cost"]),
            acc=tuple(d["acc"]),
            by_r={int(r): {k: tuple(v) for k, v in dd.items()}
                  for r, dd in d["by_r"].items()},
            results=[],
        )

    def stats(self) -> Dict[str, float]:
        """Flat numeric stats for golden files: means, stds, CIs, counts."""
        out = {"n_runs": float(self.n_runs),
               "n_completed": float(self.n_completed),
               "failure_rate": self.failure_rate}
        for key in ("time_h", "cost", "acc"):
            mean, std = getattr(self, key)
            out[f"{key}_mean"] = mean
            out[f"{key}_std"] = std
            out[f"{key}_ci95"] = self.ci95(key)
        return out


def ci95_halfwidth(std: float, n: int) -> float:
    """Shared CI convention for every aggregate in the repo (engine
    summaries and policy outcomes alike): 1.96·σ/√n, with degenerate
    counts (n<=1) yielding 0.0, not NaN — a single observation carries no
    spread information, callers gate significance on the count, and NaN
    would only propagate into downstream arithmetic and RuntimeWarnings.
    """
    if n <= 1 or not math.isfinite(std):
        return 0.0
    return 1.96 * std / math.sqrt(n)


def _mean_std(xs: Sequence[float]) -> Tuple[float, float]:
    if not xs:
        return (0.0, 0.0)       # degenerate: finite, gated by n_completed
    a = np.asarray(xs, dtype=float)
    return (float(a.mean()), float(a.std()))


def summarize(results: Sequence[RunResult], n_runs: int) -> Summary:
    """Aggregate per-run results into the paper's reporting shape."""
    done = [r for r in results if r.completed]
    rev_counts: Dict[int, int] = {}
    for r in done:
        rev_counts[r.revocations] = rev_counts.get(r.revocations, 0) + 1
    by_r: Dict[int, Dict[str, Tuple[float, float]]] = {}
    for rv in sorted(rev_counts):
        sel = [r for r in done if r.revocations == rv]
        by_r[rv] = {
            "time_h": _mean_std([r.time_h for r in sel]),
            "cost": _mean_std([r.cost_usd for r in sel]),
            "acc": _mean_std([r.accuracy for r in sel]),
        }
    return Summary(
        n_runs=n_runs,
        n_completed=len(done),
        failure_rate=1.0 - len(done) / n_runs if n_runs else 0.0,
        revocation_counts=rev_counts,
        time_h=_mean_std([r.time_h for r in done]),
        cost=_mean_std([r.cost_usd for r in done]),
        acc=_mean_std([r.accuracy for r in done]),
        by_r=by_r,
        results=list(results),
    )


def simulate_many(spec: ClusterSpec, n_runs: int = 32, seed: int = 0,
                  engine: str = "batched", trace=None,
                  recorder=None) -> Summary:
    """Monte-Carlo over ``n_runs`` independent trials of ``spec``.

    ``engine="batched"`` (default) runs all trials as one vectorized array
    program (core/mc.py); ``engine="legacy"`` replays the original
    per-trial Python event loop.  Both draw from the same distributions but
    consume the RNG stream in a different order, so they agree statistically
    (same means/failure rates within MC noise), not trial-for-trial.

    ``trace`` (a ``traces.Trace`` or ``traces.replay.ReplayContext``)
    switches the batched engine to trace-driven replay: lifetimes are
    bootstrap-resampled from the trace's observed revocations (per-trial
    windows) and transient billing follows the trace's spot-price path.
    Replay keeps the batched speedup — it is the same vectorized event
    loop with a different sampler — and is batched-only (the legacy loop
    predates the trace subsystem).

    ``recorder`` (an ``obs.Recorder``) records aggregate trial counters
    plus sampled per-trial event streams; batched-engine only (like
    ``trace``, it rides the vectorized loop's event dispatch).
    """
    rng = np.random.default_rng(seed)
    if engine == "batched":
        from repro_torch.core import mc      # late import: mc imports this module
        replay = None
        if trace is not None:
            from repro_torch.traces.replay import context_for
            replay = context_for(trace)
        return mc.summarize_batch(mc.simulate_batch(spec, n_runs, rng,
                                                    replay=replay,
                                                    recorder=recorder))
    if engine != "legacy":
        raise ValueError(f"unknown engine {engine!r}; "
                         "expected 'batched' or 'legacy'")
    if trace is not None:
        raise ValueError("trace replay requires engine='batched'")
    if recorder is not None and recorder.enabled:
        raise ValueError("recorder requires engine='batched'")
    return summarize([simulate_run(spec, rng) for _ in range(n_runs)], n_runs)

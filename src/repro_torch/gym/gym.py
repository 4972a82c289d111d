"""TransientGym — a trace-driven controller that trains under the trace
(counterpart of ``repro.gym.gym``).

Two phases, deliberately decoupled because training losses never feed
back into cloud scheduling:

**Phase 1 — plan** (numpy only, a copy of the reference's, so one seed
gives the same ledger in both packages): a scalar wall-clock fleet model
replays the trace from t=0 ("zero" bootstrap — the realized timeline). At
each
decision epoch the policy's ``act(observation)`` replans the fleet
(provision/release/refill); between epochs an event loop integrates the
PS-capped step rate through revocations, join activations
(``JOIN_OVERHEAD_S``), and completion — the same event semantics as
``core/mc.py``, implemented independently, which is exactly what makes
the differential validation in ``gym/validate.py`` meaningful. The
output is a ``GymLedger``: per-epoch records (spot quote via
``pricing.price_at``, billed cost, virtual steps, fleet size) plus the
realized membership timeline as ``SlotEvent``s.

**Phase 2 — execute** (torch, on the card unless the caller passes
``device="cpu"``): the timeline is rescaled from the paper's virtual
workload (64K steps) to a short training run and fed as
warn/revoke/join events into

- ``ElasticRuntime`` (masked mode, or hetero on a mixed fleet): real
  training of the config (reduced unless the caller asks for the
  published widths), eval accuracy measured on held-out data (the
  planted ``Cifar10Like`` task for the resnet family, next-token
  accuracy for LMs), revocation warnings triggering fast checkpoint
  saves;
- ``AsyncPSSimulator``: the same membership timeline in update space,
  yielding the staleness histogram of the async-PS reproduction.

Step-space mapping: an event at virtual step ``v`` lands on training
step ``round(v * train_steps / total_steps)``; wall-clock order is
preserved within a training step, so a refill that activates while the
fleet is dead (virtual steps frozen) is applied *after* the revocations
that emptied it and the cluster never goes empty mid-run.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.config import (OptimizerConfig, ScheduleConfig, TrainConfig,
                                get_config)
from repro_torch.core import mc, pricing
from repro_torch.core.cluster import SparseCluster
from repro_torch.core.elastic import ElasticRuntime, RevocationEvent
from repro_torch.core.staleness import AsyncPSSimulator, AsyncWorker
from repro_torch.data.pipeline import Cifar10Like, ShardedDataset
from repro_torch.device import resolve_device
from repro_torch.hetero import DynamicBatchAllocator
from repro_torch.models.builder import build_model
from repro_torch.core.policy import (Policy, PolicyDecision, StaticPolicy,
                               make_observation)
from repro_torch.core.simulator import (DEFAULT_TOTAL_STEPS, JOIN_OVERHEAD_S,
                                  Summary, ps_capped_rate)
from repro_torch.hetero.profiles import composition as kind_composition
from repro_torch.hetero.rates import _check_mode, aggregate_rate
from repro_torch.traces.replay import ReplayContext
from repro_torch.train.step import cross_entropy, init_state
from repro_torch.train.trainer import evaluate_accuracy

# Event-type tags on the wall-clock membership timeline.
EV_JOIN = "join"          # slot activated (initial fleet or later refill)
EV_REVOKE = "revoke"      # provider revoked the server (lifetime expired)
EV_RELEASE = "release"    # policy released the server (switch / shrink)


@dataclasses.dataclass(frozen=True)
class SlotEvent:
    """One membership change on the realized timeline."""
    t_s: float            # wall-clock seconds since trace start
    vstep: float          # cumulative virtual steps at the event
    slot: int             # cluster slot index (stable; reused after revoke)
    kind: str             # EV_JOIN | EV_REVOKE | EV_RELEASE
    server_kind: str      # "K80" | "P100" | "V100"
    region: str = "us-east1"


@dataclasses.dataclass(frozen=True)
class EpochRecord:
    """Per-decision-epoch ledger line (wall-clock model view)."""
    epoch: int
    t_s: float
    vsteps: float         # virtual steps completed at epoch start
    n_active: int         # active workers after reconciling to the decision
    decision: str         # PolicyDecision.label
    spot_price_hr: float  # pricing.price_at for the decision's kind
    cost_usd: float       # cumulative billed cost at epoch start
    revocations: int      # cumulative lifetime revocations
    n_by_kind: Dict[str, int] = dataclasses.field(default_factory=dict)
    # ^ active-fleet composition (mixed fleets: the hetero layer's view)


@dataclasses.dataclass
class GymLedger:
    """Everything one gym episode produced, summarizable as the engine's
    ``Summary`` schema (``core/mc.py`` codes in ``status``)."""
    trace: str
    policy: str
    total_steps: int              # virtual workload (engine scale)
    status: int                   # mc.COMPLETED / mc.ALL_REVOKED / ...
    time_h: float
    cost_usd: float
    vsteps_done: float
    avg_active_workers: float
    revocations: int
    max_slots: int
    epochs: List[EpochRecord]
    schedule: List[SlotEvent]
    # per-kind billed cost breakout ("PS" included) — heterogeneous fleets
    # are priced per kind, so the ledger shows where the dollars went
    cost_by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    batching: str = "dynamic"     # work-division mode the plan priced;
                                  # phase-2 execution must match it
    # phase-2 results (filled by the executors; NaN/0 when plan-only)
    executed_steps: int = 0
    accuracy: float = float("nan")        # real eval accuracy in [0, 1]
    final_loss: float = float("nan")
    fast_saves: int = 0
    staleness_hist: Dict[int, int] = dataclasses.field(default_factory=dict)
    mean_staleness: float = 0.0
    # the port's own results, not part of ``to_dict`` (which keeps the
    # reference's keys): the masked execution's per-step loss and wall
    # seconds, and the async PS's final params
    losses: List[float] = dataclasses.field(default_factory=list)
    step_s: List[float] = dataclasses.field(default_factory=list)
    ps_params: Optional[Dict[str, torch.Tensor]] = None

    @property
    def completed(self) -> bool:
        return self.status == mc.COMPLETED

    @property
    def failure(self) -> Optional[str]:
        return mc.FAILURE_NAMES.get(self.status, "unknown")

    def summary(self) -> Summary:
        return summarize_ledgers([self])

    def to_dict(self) -> Dict:
        """JSON view for the CLI / benchmark artifacts."""
        return {
            "trace": self.trace, "policy": self.policy,
            "total_steps": self.total_steps,
            "completed": self.completed, "failure": self.failure,
            "time_h": self.time_h, "cost_usd": self.cost_usd,
            "vsteps_done": self.vsteps_done,
            "avg_active_workers": self.avg_active_workers,
            "revocations": self.revocations, "max_slots": self.max_slots,
            "cost_by_kind": dict(self.cost_by_kind),
            "batching": self.batching,
            "executed_steps": self.executed_steps,
            "accuracy": None if math.isnan(self.accuracy) else self.accuracy,
            "final_loss": (None if math.isnan(self.final_loss)
                           else self.final_loss),
            "fast_saves": self.fast_saves,
            "mean_staleness": self.mean_staleness,
            "staleness_hist": {str(k): v
                               for k, v in self.staleness_hist.items()},
            "epochs": [dataclasses.asdict(e) for e in self.epochs],
            "schedule": [dataclasses.asdict(e) for e in self.schedule],
        }


def summarize_ledgers(ledgers: List[GymLedger]) -> Summary:
    """Aggregate gym episodes into the engine's ``Summary`` schema via the
    shared ``mc.summarize_arrays`` seam — field-for-field comparable with
    ``simulate_many`` output. ``acc`` aggregates the *real* eval accuracy
    (fraction in [0, 1]) over the completed ledgers that measured one;
    plan-only ledgers carry a NaN placeholder, which the aggregation
    skips (all-plan-only input yields the finite degenerate (0, 0))."""
    status = np.array([l.status for l in ledgers], dtype=np.int64)
    acc = np.array([l.accuracy for l in ledgers])
    acc = np.where(status == mc.COMPLETED, acc, np.nan)
    return mc.summarize_arrays(
        status,
        np.array([l.time_h for l in ledgers]),
        np.array([l.cost_usd for l in ledgers]),
        acc,
        np.array([l.revocations for l in ledgers], dtype=np.int64))


# ---------------------------------------------------------------------------
# Phase 1: the wall-clock fleet model
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Slot:
    """Internal per-server state of the fleet model."""
    kind: str
    cid: int                      # cluster slot index
    region: str = "us-east1"
    t_pending: float = np.inf     # activation due time; inf = not pending
    t_start: float = np.nan       # activation time; NaN = never activated
    t_revoke: float = np.inf      # drawn lifetime expiry (absolute)
    t_release: float = np.inf     # policy released it (absolute)
    active: bool = False

    @property
    def live(self) -> bool:
        return self.active or np.isfinite(self.t_pending)


class TransientGym:
    """One policy episode over one trace: plan, then optionally train.

    ``refill=False`` reproduces the engine's static-fleet semantics
    (provision once at t=0, revoked slots stay dead — the differential-
    validation mode); ``refill=True`` is the online-policy flow of
    ``evaluate_policy`` (reconcile the fleet to the decision every
    epoch). Parameter servers are on-demand, like the policy evaluator.
    """

    def __init__(self, trace, policy: Optional[Policy] = None, *,
                 total_steps: int = DEFAULT_TOTAL_STEPS,
                 epoch_s: float = 1800.0, max_h: float = 24.0,
                 refill: bool = False, seed: int = 0,
                 batching: str = "dynamic",
                 recorder: Optional[obs.Recorder] = None):
        _check_mode(batching)
        if isinstance(trace, ReplayContext):
            self.ctx = trace
        else:
            # "zero" bootstrap: the gym replays the one realized timeline
            self.ctx = ReplayContext(trace, bootstrap="zero")
        self.policy = policy if policy is not None \
            else StaticPolicy(PolicyDecision("K80", 4))
        self.total_steps = int(total_steps)
        self.epoch_s = float(epoch_s)
        self.max_h = float(max_h)
        self.refill = bool(refill)
        self.seed = int(seed)
        self.batching = batching      # mixed-fleet work division model
        # observability: events/metrics route through here; the NULL
        # recorder keeps every emission a constant-time no-op
        self.rec = recorder if recorder is not None else obs.NULL

    # -- wall-clock model -------------------------------------------------

    def plan(self) -> GymLedger:
        rng = np.random.default_rng(self.seed)
        self.policy.reset(rng)
        bound = self.ctx.bind(1, rng, bootstrap="zero")
        zero = np.zeros(1, dtype=np.int64)

        slots: List[_Slot] = []
        free_cids: List[int] = []
        next_cid = 0
        events: List[SlotEvent] = []
        epochs: List[EpochRecord] = []

        t = 0.0
        vsteps = 0.0
        worker_int = 0.0              # ∫ active_workers dt
        ps_int = 0.0                  # ∫ n_ps dt (on-demand billing)
        revocations = 0
        status = mc.RUNNING
        total = float(self.total_steps)
        max_s = self.max_h * 3600.0

        def alloc_cid() -> int:
            nonlocal next_cid
            if free_cids:
                return free_cids.pop(0)
            next_cid += 1
            return next_cid - 1

        def draw_lifetime(kind: str, at: float) -> float:
            return float(bound.lifetimes(kind, zero, at, rng)[0])

        def cost_by_kind_until(tq: float) -> Dict[str, float]:
            by_kind: Dict[str, float] = {}
            for s in slots:
                if not np.isfinite(s.t_start):
                    continue
                end = min(s.t_revoke, s.t_release, tq)
                secs = max(0.0, end - s.t_start)
                if self.ctx.has_prices(s.kind):
                    c = float(bound.cost_usd(s.kind,
                                             np.array([s.t_start]),
                                             np.array([s.t_start + secs]))[0])
                else:
                    c = secs * pricing.SERVER_TYPES[s.kind].transient_hr \
                        / 3600.0
                by_kind[s.kind] = by_kind.get(s.kind, 0.0) + c
            by_kind["PS"] = ps_int * pricing.SERVER_TYPES["PS"].ondemand_hr \
                / 3600.0
            return by_kind

        def cost_until(tq: float) -> float:
            return sum(cost_by_kind_until(tq).values())

        rec = self.rec
        k = 0
        dec: Optional[PolicyDecision] = None
        while status == mc.RUNNING:
            t_epoch = k * self.epoch_s
            if t_epoch >= max_s:
                break

            # --- observe + act (the online policy interface) -------------
            fleet_now = kind_composition(s.kind for s in slots if s.active)
            observation = make_observation(self.ctx, t_s=t_epoch,
                                           steps_done=vsteps,
                                           total_steps=self.total_steps,
                                           fleet_by_kind=fleet_now)
            with rec.span(obs.EV_REPLAN, cat=obs.CAT_POLICY,
                          sim_t=t_epoch, epoch=k) as replan_args:
                dec = self.policy.act(observation, self.ctx)
                if rec.enabled:
                    replan_args["decision"] = dec.label
                    replan_args["vsteps"] = vsteps
                    replan_args["fleet_by_kind"] = dict(fleet_now)
                    scores = getattr(self.policy, "last_scores", None)
                    if scores:                # considered-candidate metadata
                        replan_args["candidates"] = dict(scores)

            # --- reconcile the fleet to the decision (per target kind) ----
            if k == 0 or self.refill:
                target = dec.composition()
                # release live slots of untargeted types
                for s in slots:
                    if s.live and s.kind not in target:
                        if s.active:
                            s.t_release = t_epoch
                            s.active = False
                            events.append(SlotEvent(t_epoch, vsteps, s.cid,
                                                    EV_RELEASE, s.kind,
                                                    s.region))
                            rec.instant(obs.EV_SLOT_RELEASE, cat=obs.CAT_GYM,
                                        track=f"slot{s.cid}", sim_t=t_epoch,
                                        kind=s.kind, region=s.region)
                        s.t_pending = np.inf
                        free_cids.append(s.cid)
                for tkind, t_n in target.items():
                    # shrink surplus of this type, last-provisioned first
                    live = [s for s in slots if s.live and s.kind == tkind]
                    for s in reversed(live[t_n:]):
                        if s.active:
                            s.t_release = t_epoch
                            s.active = False
                            events.append(SlotEvent(t_epoch, vsteps, s.cid,
                                                    EV_RELEASE, s.kind,
                                                    s.region))
                            rec.instant(obs.EV_SLOT_RELEASE, cat=obs.CAT_GYM,
                                        track=f"slot{s.cid}", sim_t=t_epoch,
                                        kind=s.kind, region=s.region)
                        s.t_pending = np.inf
                        free_cids.append(s.cid)
                    # grow: initial provisioning (k=0) is free, like the
                    # engine's slot 0; later joins pay sparse-mapping cost
                    need = t_n - min(len(live), t_n)
                    overhead = 0.0 if k == 0 else JOIN_OVERHEAD_S
                    for _ in range(need):
                        slots.append(_Slot(kind=tkind, cid=alloc_cid(),
                                           t_pending=t_epoch + overhead))

            n_act = sum(1 for s in slots if s.active)
            n_by_kind = kind_composition(s.kind for s in slots if s.active)
            by_kind_epoch = cost_by_kind_until(max(t, t_epoch))
            epochs.append(EpochRecord(
                epoch=k, t_s=t_epoch, vsteps=vsteps, n_active=n_act,
                decision=dec.label,
                spot_price_hr=float(pricing.price_at(dec.kind, t_epoch,
                                                     trace=self.ctx)),
                cost_usd=sum(by_kind_epoch.values()),
                revocations=revocations,
                n_by_kind=n_by_kind))
            if rec.enabled:
                # per-epoch ledger fields as labeled series (previously
                # computed here and dropped): billed dollars and active
                # workers per server kind
                for kd, c in by_kind_epoch.items():
                    rec.metrics.gauge("cost_usd", kind=kd).set(c)
                for kd, n in n_by_kind.items():
                    rec.metrics.gauge("workers", kind=kd).set(n)
                rec.metrics.gauge("vsteps").set(vsteps)

            # --- advance the segment [t_epoch, t_epoch + epoch_s) ---------
            t = max(t, t_epoch)
            t_seg_end = min(t_epoch + self.epoch_s, max_s)
            for _ in range(mc._MAX_EVENTS):
                # hetero layer: uniform batching on a mixed fleet runs at
                # the slowest member's pace; dynamic recovers sum-of-rates
                rate = ps_capped_rate(
                    aggregate_rate(
                        np.array([pricing.SERVER_TYPES[s.kind].steps_per_sec
                                  for s in slots if s.active]),
                        self.batching), dec.n_ps)
                n_active = sum(1 for s in slots if s.active)
                t_rev = min((s.t_revoke for s in slots if s.active),
                            default=np.inf)
                t_act = min((s.t_pending for s in slots
                             if np.isfinite(s.t_pending)), default=np.inf)
                t_done = t + (total - vsteps) / rate if rate > 0 else np.inf

                if rate <= 0 and not np.isfinite(t_act) and not self.refill:
                    status = mc.ALL_REVOKED        # engine's dead criterion
                    break
                # tie-break order mirrors the engine: revoke < activate <
                # done (< segment boundary)
                t_next, what = min((t_rev, "revoke"), (t_act, "activate"),
                                   (t_done, "done"), (t_seg_end, "seg_end"),
                                   key=lambda e: e[0])
                dt = max(0.0, t_next - t)
                vsteps += rate * dt
                worker_int += n_active * dt
                ps_int += dec.n_ps * dt
                if rec.enabled and dt > 0 and rate > 0:
                    # one constant-rate segment of virtual progress
                    rec.sim_span(obs.EV_STEP, cat=obs.CAT_GYM, t0=t,
                                 t1=t_next, rate=rate, vsteps=rate * dt,
                                 n_active=n_active)
                t = t_next

                if what == "done":
                    vsteps = total
                    status = mc.COMPLETED
                    break
                if what == "seg_end":
                    break
                if what == "revoke":
                    s = min((s for s in slots if s.active),
                            key=lambda s: s.t_revoke)
                    s.active = False
                    revocations += 1
                    events.append(SlotEvent(t, vsteps, s.cid, EV_REVOKE,
                                            s.kind, s.region))
                    free_cids.append(s.cid)
                    if rec.enabled:
                        rec.instant(obs.EV_REVOKE_FIRE, cat=obs.CAT_GYM,
                                    track=f"slot{s.cid}", sim_t=t,
                                    kind=s.kind, region=s.region,
                                    vstep=vsteps)
                        rec.metrics.counter("revocations_total", kind=s.kind,
                                            region=s.region).inc()
                elif what == "activate":
                    s = min((s for s in slots if np.isfinite(s.t_pending)),
                            key=lambda s: s.t_pending)
                    s.t_pending = np.inf
                    s.t_start = t
                    s.active = True
                    s.t_revoke = t + draw_lifetime(s.kind, t)
                    events.append(SlotEvent(t, vsteps, s.cid, EV_JOIN,
                                            s.kind, s.region))
                    if rec.enabled:
                        rec.instant(obs.EV_SLOT_JOIN, cat=obs.CAT_GYM,
                                    track=f"slot{s.cid}", sim_t=t,
                                    kind=s.kind, region=s.region,
                                    vstep=vsteps)
            k += 1

        if status == mc.RUNNING:                   # hit the max_h wall
            status = mc.NO_PROGRESS
        t_end = min(t, max_s)
        avg_w = worker_int / t_end if t_end > 0 else 0.0
        by_kind = cost_by_kind_until(t_end)
        if rec.enabled:
            # final ledger totals as metrics: the gauges are set from the
            # very same by_kind dict / vsteps float the ledger is built
            # from, so registry.total("cost_usd") == ledger.cost_usd and
            # gauge("vsteps") == ledger.vsteps_done bit-for-bit
            for kd, c in by_kind.items():
                rec.metrics.gauge("cost_usd", kind=kd).set(c)
            rec.metrics.gauge("vsteps").set(vsteps)
            rec.metrics.counter("steps_total", kind="virtual").inc(vsteps)
            rec.metrics.gauge("time_h").set(t_end / 3600.0)
            rec.sim_span(obs.EV_EPISODE, cat=obs.CAT_GYM, t0=0.0, t1=t_end,
                         trace=self.ctx.trace.name, policy=self.policy.name,
                         status=int(status),
                         completed=status == mc.COMPLETED)
        return GymLedger(
            trace=self.ctx.trace.name, policy=self.policy.name,
            total_steps=self.total_steps, status=int(status),
            time_h=t_end / 3600.0, cost_usd=sum(by_kind.values()),
            vsteps_done=vsteps, avg_active_workers=avg_w,
            revocations=revocations, max_slots=max(next_cid, 1),
            epochs=epochs, schedule=events, cost_by_kind=by_kind,
            batching=self.batching)

    # -- full episode: plan + train + async staleness ----------------------

    def run(self, *, arch: str = "resnet32-cifar10", train_steps: int = 96,
            per_slot: int = 4, seq_len: int = 32,
            async_updates: int = 0, ckpt=None, reduced: bool = True,
            device="cuda") -> GymLedger:
        """Plan, then execute the realized timeline as real training on
        ``device``.

        ``async_updates > 0`` additionally replays the timeline through
        ``AsyncPSSimulator`` to fill the staleness histogram.
        ``reduced=False`` trains the config at its published widths.
        """
        ledger = self.plan()
        execute_masked(ledger, arch=arch, train_steps=train_steps,
                       per_slot=per_slot, seq_len=seq_len, seed=self.seed,
                       ckpt=ckpt, recorder=self.rec, reduced=reduced,
                       device=device)
        if async_updates > 0:
            execute_async_ps(ledger, updates=async_updates, seed=self.seed,
                             recorder=self.rec, device=device)
        return ledger


# ---------------------------------------------------------------------------
# Timeline -> training-step schedule
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TrainingSchedule:
    """The wall-clock timeline rescaled to a reduced training run."""
    executed_steps: int                       # training steps to actually run
    initial: Tuple[Tuple[int, str], ...]      # (slot, server_kind) at step 0
    events: Tuple                             # elastic.RevocationEvent, ...


def training_schedule(ledger: GymLedger, train_steps: int
                      ) -> TrainingSchedule:
    """Map virtual-step events onto ``train_steps`` real training steps.

    Events keep their wall-clock order within a training step (see the
    module docstring for why that keeps the cluster non-empty); lifetime
    revocations get a GCE-style warning event one step earlier so the
    elastic runtime exercises the fast-save path.
    """
    scale = train_steps / float(ledger.total_steps)
    if ledger.completed:
        executed = train_steps
    else:
        executed = min(train_steps, int(ledger.vsteps_done * scale))
    initial: List[Tuple[int, str]] = []
    events: List = []
    warned = set()
    for ev in ledger.schedule:
        step = int(round(ev.vstep * scale))
        if ev.kind == EV_JOIN and ev.t_s == 0.0:
            initial.append((ev.slot, ev.server_kind))
            continue
        if step >= executed:
            continue                     # after the run's end: never executed
        if ev.kind == EV_JOIN:
            events.append(RevocationEvent(step=step, slot=ev.slot,
                                          kind="join",
                                          server_kind=ev.server_kind,
                                          region=ev.region))
        else:
            if ev.kind == EV_REVOKE:     # 30 s warning -> fast checkpoint
                wstep = max(step - 1, 0)
                if (ev.slot, step) not in warned:
                    events.append(RevocationEvent(step=wstep, slot=ev.slot,
                                                  kind="warn",
                                                  server_kind=ev.server_kind,
                                                  region=ev.region))
                    warned.add((ev.slot, step))
            events.append(RevocationEvent(step=step, slot=ev.slot,
                                          kind="revoke",
                                          server_kind=ev.server_kind,
                                          region=ev.region))
    return TrainingSchedule(executed_steps=executed, initial=tuple(initial),
                            events=tuple(events))


# ---------------------------------------------------------------------------
# Phase 2a: masked elastic training
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _PlantedSharded:
    """``ShardedDataset``-compatible view of ``Cifar10Like`` — planted
    signal so eval accuracy actually moves with executed steps."""
    task: object
    global_batch: int

    def shard_batch(self, step: int, shard: int, num_shards: int):
        if self.global_batch % num_shards:
            raise ValueError(f"global batch {self.global_batch} not "
                             f"divisible by {num_shards} shards")
        return self.task.batch(step, self.global_batch // num_shards,
                               shard=shard, num_shards=num_shards)

    def global_batch_at(self, step: int):
        return self.task.batch(step, self.global_batch)


def _build_training(arch: str, ledger: GymLedger, train_steps: int,
                    per_slot: int, seq_len: int, seed: int,
                    base_workers: int = 1, reduced: bool = True,
                    device="cuda"):
    """Model + dataset + train config for one gym execution on
    ``device``. The model runs the plain paths, which training
    differentiates (the kernels have no backward) and the held-out
    evaluation reuses. ``reduced=False`` builds the published widths."""
    cfg = get_config(arch, reduced=reduced).replace(
        attn_impl="torch", ssm_impl="torch", rwkv_impl="torch")
    model = build_model(cfg, device)
    dev = str(model.device)
    global_batch = per_slot * ledger.max_slots
    if cfg.family == "resnet":
        # color_signal: the planted class signal must survive the resnet's
        # global average pool for eval accuracy to track training progress
        task = Cifar10Like(num_classes=cfg.num_classes,
                           image_size=cfg.image_size, seed=seed,
                           color_signal=1.5, device=dev)
        dataset = _PlantedSharded(task, global_batch)
        opt = OptimizerConfig(name="momentum", lr=0.05, adaptive_lr=True,
                              base_workers=base_workers, grad_clip=1.0)
    else:
        dataset = ShardedDataset(cfg, global_batch=global_batch,
                                 seq_len=seq_len, seed=seed, device=dev)
        opt = OptimizerConfig(name="adamw", lr=3e-4, adaptive_lr=True,
                              base_workers=base_workers)
    tcfg = TrainConfig(optimizer=opt,
                       schedule=ScheduleConfig(kind="constant",
                                               warmup_steps=1,
                                               total_steps=train_steps),
                       checkpoint_every=0, seed=seed)
    return cfg, model, dataset, tcfg


def _eval_batch(cfg, dataset):
    if cfg.family == "resnet":
        return dataset.task.eval_batch(512)
    return dataset.global_batch_at(10_000_019)    # held-out step namespace


def execute_masked(ledger: GymLedger, *, arch: str = "resnet32-cifar10",
                   train_steps: int = 96, per_slot: int = 4,
                   seq_len: int = 32, seed: int = 0, ckpt=None,
                   recorder: Optional[obs.Recorder] = None,
                   reduced: bool = True, device="cuda") -> GymLedger:
    """Train the realized timeline with the masked elastic runtime.

    Fills ``executed_steps``, ``accuracy`` (held-out eval), ``final_loss``
    and ``fast_saves`` on the ledger, in place, and the port's per-step
    ``losses`` and ``step_s``. ``recorder`` observes the real training
    steps (step spans on the step-index sim clock, the warn/revoke/join
    membership events) alongside the plan's sim events. The float32
    masters are ``init_state``'s, drawn on ``device`` from ``seed``.
    """
    sched = training_schedule(ledger, train_steps)
    cfg, model, dataset, tcfg = _build_training(
        arch, ledger, train_steps, per_slot, seq_len, seed,
        base_workers=max(len(sched.initial), 1), reduced=reduced,
        device=device)
    cluster = SparseCluster(max_slots=ledger.max_slots)
    for slot, kind in sched.initial:
        cluster.fill_and_activate(slot, 0, kind=kind)
    # mixed-kind timeline -> heterogeneity-aware execution: throughput-
    # proportional per-slot batch counts + aggregate-throughput LR rule.
    # The allocator's global batch leaves 2x layout headroom so fast slots
    # can actually take a larger-than-uniform share (rows are capped at
    # per_slot). Homogeneous timelines — and mixed plans priced under
    # "uniform" batching, whose equal-shares semantics IS the plain
    # masked step — keep the masked execution path.
    kinds_seen = {kind for _, kind in sched.initial} \
        | {e.server_kind for e in sched.events if e.kind == "join"}
    allocator = None
    if len(kinds_seen) > 1 and ledger.batching == "dynamic":
        allocator = DynamicBatchAllocator(
            cluster,
            global_batch=max(per_slot * ledger.max_slots // 2, 1),
            cap_per_slot=per_slot,
            base_workers=max(len(sched.initial), 1),
            base_kind=sched.initial[0][1] if sched.initial else "K80")
    rt = ElasticRuntime(model, tcfg, dataset, cluster, ckpt,
                        allocator=allocator, recorder=recorder)
    rt.add_events(sched.events)
    state = init_state(model, tcfg)
    if sched.executed_steps > 0:
        state = rt.run(state, sched.executed_steps)
    ledger.executed_steps = sched.executed_steps
    ledger.fast_saves = rt.fast_saves
    ledger.losses = [r["loss"] for r in rt.metrics_log]
    ledger.step_s = list(rt.step_seconds)
    if rt.metrics_log:
        ledger.final_loss = float(rt.metrics_log[-1]["loss"])
    ledger.accuracy = evaluate_accuracy(model, state.params,
                                        _eval_batch(cfg, dataset))
    return ledger


# ---------------------------------------------------------------------------
# Phase 2b: async-PS staleness replay of the same timeline
# ---------------------------------------------------------------------------

def _linear_init(dim: int, num_classes: int, seed: int, device
                 ) -> Dict[str, torch.Tensor]:
    """The async-PS linear model's initial weights, drawn on the CPU from
    a ``torch.Generator`` seeded with ``seed`` (so every device starts
    from the same numbers), then moved to ``device``. The reference draws
    them with ``jax.random.key(seed)``: the numbers differ, the law is
    the same."""
    gen = torch.Generator().manual_seed(seed)
    w = torch.randn((dim, num_classes), generator=gen) * 0.01
    return {"w": w.to(device), "b": torch.zeros((num_classes,),
                                                device=device)}


def execute_async_ps(ledger: GymLedger, *, updates: int = 384,
                     seed: int = 0,
                     recorder: Optional[obs.Recorder] = None,
                     device="cuda") -> GymLedger:
    """Replay the membership timeline through ``AsyncPSSimulator``.

    Events are rescaled to PS-update counts (update ``u`` of ``updates``
    corresponds to virtual step ``u / updates * total_steps``) and then
    to the async simulator's own clock by walking the timeline at the
    fleet's aggregate step rate. Fills ``staleness_hist``,
    ``mean_staleness`` and the port's ``ps_params`` on the ledger, in
    place. The PS trains a linear model over ``Cifar10Like`` images on
    ``device``.
    """
    total_updates = updates if ledger.completed else int(
        ledger.vsteps_done / ledger.total_steps * updates)
    if total_updates <= 0:
        ledger.staleness_hist, ledger.mean_staleness = {}, 0.0
        return ledger

    # --- rescale the timeline to the async clock -------------------------
    scale = updates / float(ledger.total_steps)
    workers: List = []
    open_by_cid: Dict[int, object] = {}
    t_async, u_prev = 0.0, 0.0
    agg = 0.0
    for ev in ledger.schedule:
        u = min(ev.vstep * scale, float(updates))
        if agg > 0:
            t_async += max(0.0, u - u_prev) / agg
        u_prev = u
        rate = pricing.SERVER_TYPES[ev.server_kind].steps_per_sec
        if ev.kind == EV_JOIN:
            w = AsyncWorker(wid=len(workers), kind=ev.server_kind,
                            join_t=t_async)
            workers.append(w)
            open_by_cid[ev.slot] = w
            agg += rate
        else:
            w = open_by_cid.pop(ev.slot, None)
            if w is not None:
                w.revoke_t = max(t_async, w.join_t + 1e-6)
                agg = max(0.0, agg - rate)
    if not workers:
        ledger.staleness_hist, ledger.mean_staleness = {}, 0.0
        return ledger

    dev = resolve_device(device)
    task = Cifar10Like(seed=seed, device=str(dev))
    dim = task.image_size * task.image_size * 3
    params = _linear_init(dim, task.num_classes, seed, dev)

    def loss(p, batch):
        x = batch["images"].reshape(batch["images"].shape[0], -1)
        return cross_entropy(x @ p["w"] + p["b"], batch["labels"])

    sim = AsyncPSSimulator(
        loss, params,
        OptimizerConfig(name="momentum", lr=0.05, base_workers=1,
                        grad_clip=0),
        ScheduleConfig(kind="constant", warmup_steps=1,
                       total_steps=total_updates))
    res = sim.run(workers, lambda u, w: task.batch(u * 64 + w, 64),
                  total_updates, seed=seed)
    ledger.staleness_hist = res.staleness_histogram()
    ledger.mean_staleness = res.mean_staleness
    ledger.ps_params = res.params
    rec = recorder if recorder is not None else obs.NULL
    if rec.enabled and ledger.staleness_hist:
        # the async-PS staleness distribution as a metrics histogram
        # (integer staleness values -> integer-ish bucket bounds)
        rec.metrics.histogram(
            "staleness", bounds=(0, 1, 2, 4, 8, 16, 32, 64)
        ).observe_counts(ledger.staleness_hist)
    return ledger

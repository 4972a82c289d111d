"""Elastic runtime — dynamic cluster membership without new shapes
(C3/C5), counterpart of ``repro.core.elastic``.

The paper's sparse mapping fills worker *slots* opportunistically; training
must keep stepping as slots fill and empty. Two execution modes:

**masked** (default)
    The global batch is laid out as ``(max_slots, per_slot, ...)`` with an
    ``active_mask`` of shape ``(max_slots,)``. Inactive slots contribute
    zero weight to the loss, and the adaptive-LR multiplier (paper C6) is
    ``n_active / base_workers``. The mask is built on the host, so
    ``n_active`` is a Python number and the step needs no device sync to
    compute its LR; every slot's rows are computed, inactive ones
    included, as in the reference, so shapes never change.

**hetero**
    ``slot_counts`` (the allocator's per-slot example counts) masks the
    rows of each slot past its count, and the LR multiplier is the
    allocator's aggregate-throughput ratio.

``RemeshCache`` keeps the reference's per-size step cache (its multi-slice
remesh path). Revocation flow (GCE gives a 30 s warning):
    warn(slot) -> fast save (one replica, fsync'd)   [checkpoint.py]
               -> revoke(slot) -> mask update -> LR rescale
               -> shard reassignment is implicit: batches are pure
                  functions of (step, shard, num_shards)   [data/pipeline.py]

The steps differentiate the plain paths and update the float32 masters
in place (``train/step.py``), as ``make_train_step`` does. An
``obs.Recorder`` observes the run as the reference's does: warn, revoke
and join instants and step spans on the step-index sim clock, and the
``fast_saves_total``, ``revocations_total``, ``steps_total``,
``step_latency_ms``, ``workers`` and ``examples_per_step`` series.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.core.cluster import SparseCluster
from repro_torch.models.builder import Model
from repro_torch.optim import make_optimizer, make_schedule
from repro_torch.train.step import (TrainState, _token_weights,
                                    apply_gradients, cross_entropy,
                                    value_and_grad)

Tree = Dict[str, Any]


# ---------------------------------------------------------------------------
# Masked-membership train steps (fixed shapes)
# ---------------------------------------------------------------------------

def _make_row_weighted_loss(model: Model, tcfg: TrainConfig) -> Callable:
    """Loss over a slot-major batch with arbitrary per-row weights.

    ``row_w`` has shape ``(max_slots * per_slot,)``; a row's weight is its
    share of the loss mean, so a slot's contribution is proportional to
    its weighted row count — the seam both the masked (0/1 slot mask) and
    the hetero (per-slot example counts) steps build on.
    """
    cfg = model.cfg
    remat = tcfg.remat != "none"

    def loss_fn(params, batch, row_w):
        flat = {k: x.reshape((x.shape[0] * x.shape[1],) + x.shape[2:])
                for k, x in batch.items()}
        logits, aux = model.apply(params, flat, remat=remat)
        if cfg.family == "resnet":
            loss = cross_entropy(logits, flat["labels"], row_w)
        else:
            w = _token_weights(cfg, flat, logits.shape[1]) * row_w[:, None]
            loss = cross_entropy(logits, flat["labels"], w)
        return loss, {"loss": loss, "aux": aux}

    return loss_fn


def _rows(weights: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(weights, np.float32)
                            .reshape(-1)).to(device)


def make_masked_train_step(model: Model, tcfg: TrainConfig
                           ) -> Callable[..., Tuple[TrainState, Dict]]:
    """Elastic train step over a slot-major batch.

    ``train_step(state, batch, active_mask)``: batch leaves
    ``(max_slots, per_slot, ...)``, ``active_mask`` ``(max_slots,)`` in
    {0, 1} on the host. Loss averages over *active* rows only; the LR
    multiplier follows the paper's adaptive rule when
    ``tcfg.optimizer.adaptive_lr``, else the naive (configured-slots)
    rule. Metrics: ``loss``, ``aux``, ``grad_norm`` (device scalars),
    ``lr`` and ``active`` (floats).
    """
    opt = make_optimizer(tcfg.optimizer)
    sched = make_schedule(tcfg.schedule)
    loss_fn = _make_row_weighted_loss(model, tcfg)
    base = tcfg.optimizer.base_workers

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   active_mask: Sequence[float]
                   ) -> Tuple[TrainState, Dict[str, Any]]:
        mask = np.asarray(active_mask, np.float32)
        per = next(iter(batch.values())).shape[1]
        row_w = _rows(np.repeat(mask, per), model.device)
        grads, metrics = value_and_grad(
            lambda p: loss_fn(p, batch, row_w), state.params)
        n_active = max(float(mask.sum()), 1.0)
        if tcfg.optimizer.adaptive_lr:
            lr_scale = n_active / base                     # C6: the fix
        else:
            lr_scale = mask.shape[0] / base                # naive TF
        new_state, out = apply_gradients(state, grads, metrics, lr_scale,
                                         tcfg, opt, sched)
        return new_state, dict(out, active=n_active)

    return train_step


def make_hetero_train_step(model: Model, tcfg: TrainConfig
                           ) -> Callable[..., Tuple[TrainState, Dict]]:
    """Heterogeneity-aware elastic step: ragged slot batches, fixed shapes.

    ``train_step(state, batch, slot_counts, lr_ratio)``: ``slot_counts``
    ``(max_slots,)`` (host) is the allocator's per-slot example count;
    slot ``s`` contributes its first ``slot_counts[s]`` rows, so the
    weighted mean over live rows equals the plain mean over the dynamic
    global batch. ``lr_ratio`` is the allocator's aggregate-throughput
    ratio, the adaptive-LR rule (C6) beyond worker counts. Metrics as the
    masked step's, plus ``examples``.
    """
    opt = make_optimizer(tcfg.optimizer)
    sched = make_schedule(tcfg.schedule)
    loss_fn = _make_row_weighted_loss(model, tcfg)
    base = tcfg.optimizer.base_workers

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   slot_counts: Sequence[float], lr_ratio: float
                   ) -> Tuple[TrainState, Dict[str, Any]]:
        counts = np.asarray(slot_counts, np.float32)
        slots, per = next(iter(batch.values())).shape[:2]
        live = np.arange(per, dtype=np.float32)[None, :] < counts[:, None]
        row_w = _rows(live, model.device)
        grads, metrics = value_and_grad(
            lambda p: loss_fn(p, batch, row_w), state.params)
        if tcfg.optimizer.adaptive_lr:
            lr_scale = max(float(np.float32(lr_ratio)), 1e-9)
        else:
            lr_scale = slots / base
        new_state, out = apply_gradients(state, grads, metrics, lr_scale,
                                         tcfg, opt, sched)
        return new_state, dict(out, active=float((counts > 0).sum()),
                               examples=float(counts.sum()))

    return train_step


def slot_batch(cfg: ModelConfig, dataset, step: int, cluster: SparseCluster
               ) -> Tuple[Dict[str, torch.Tensor], np.ndarray]:
    """Assemble the ``(max_slots, per_slot, ...)`` batch (on the dataset's
    device) + the host active mask.

    Every slot's rows are generated from its *own* deterministic stream
    (pure in (step, shard, num_shards=max_slots)); inactive slots still
    get placeholder rows (masked out) so shapes never change.
    """
    slots = cluster.max_slots
    parts = [dataset.shard_batch(step, s, slots) for s in range(slots)]
    batch = {k: torch.stack([p[k] for p in parts]) for k in parts[0]}
    mask = np.zeros((slots,), np.float32)
    for s in cluster.active_slots():
        mask[s] = 1.0
    return batch, mask


# ---------------------------------------------------------------------------
# Remesh-mode template cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RemeshCache:
    """Train steps keyed by active-slice count: growing or shrinking to a
    previously seen size reuses the step built for it."""
    build: Callable[[int], Callable]          # n_active -> step
    _cache: Dict[int, Callable] = dataclasses.field(default_factory=dict)
    compile_count: int = 0

    def step_for(self, n_active: int) -> Callable:
        if n_active not in self._cache:
            self._cache[n_active] = self.build(n_active)
            self.compile_count += 1
        return self._cache[n_active]


# ---------------------------------------------------------------------------
# ElasticRuntime: event plumbing between cluster, checkpoint, and the step
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RevocationEvent:
    step: int
    slot: int
    kind: str            # "warn" | "revoke" | "join"
    server_kind: str = "K80"
    region: str = "us-east1"


class ElasticRuntime:
    """Drives masked elastic training through a revocation/join event trace.

    ``metrics_log`` has the reference's keys (``step``, ``loss``,
    ``active``, ``lr``); ``step_seconds`` holds each step's wall time
    (events excluded, ending in the sync that reads the loss), and
    ``fast_save_log`` each fast save's step, slot, bytes and seconds.
    """

    def __init__(self, model: Model, tcfg: TrainConfig, dataset,
                 cluster: SparseCluster, ckpt=None, allocator=None,
                 recorder: Optional[obs.Recorder] = None):
        self.model = model
        self.tcfg = tcfg
        self.dataset = dataset
        self.cluster = cluster
        self.ckpt = ckpt
        # allocator (hetero.DynamicBatchAllocator): per-slot example counts
        # re-solved on membership bumps; None = homogeneous masked mode
        self.allocator = allocator
        self.rec = recorder if recorder is not None else obs.NULL
        self.mode = "masked" if allocator is None else "hetero"
        if allocator is None:
            self.step_fn = make_masked_train_step(model, tcfg)
        else:
            self.step_fn = make_hetero_train_step(model, tcfg)
        self.events: Dict[int, list] = {}
        self.fast_saves = 0
        self.metrics_log: List[Dict[str, Any]] = []
        self.step_seconds: List[float] = []
        self.fast_save_log: List[Dict[str, Any]] = []

    def add_events(self, events) -> None:
        for e in events:
            self.events.setdefault(e.step, []).append(e)

    def _apply_events(self, state: TrainState, step: int) -> None:
        rec = self.rec
        for e in self.events.get(step, ()):
            # training's sim clock is the step index: membership events
            # share an axis with the EV_STEP spans in the timeline
            if e.kind == "warn":
                rec.instant(obs.EV_REVOKE_WARN, cat=obs.CAT_TRAIN,
                            track=f"slot{e.slot}", sim_t=float(step),
                            kind=e.server_kind, region=e.region,
                            fast_save=self.ckpt is not None)
                if self.ckpt is not None:       # 30 s window: one fsync'd copy
                    self.ckpt.save(step, state, fast=True,
                                   extra={"reason": "revocation_warning",
                                          "slot": e.slot})
                    self.fast_saves += 1
                    self.fast_save_log.append(
                        {"slot": e.slot, **self.ckpt.last_save})
                    rec.metrics.counter("fast_saves_total").inc()
            elif e.kind == "revoke":
                rec.instant(obs.EV_REVOKE_FIRE, cat=obs.CAT_TRAIN,
                            track=f"slot{e.slot}", sim_t=float(step),
                            kind=e.server_kind, region=e.region)
                rec.metrics.counter("revocations_total", kind=e.server_kind,
                                    region=e.region).inc()
                self.cluster.revoke(e.slot, step)
            elif e.kind == "join":
                rec.instant(obs.EV_SLOT_JOIN, cat=obs.CAT_TRAIN,
                            track=f"slot{e.slot}", sim_t=float(step),
                            kind=e.server_kind, region=e.region)
                self.cluster.fill_and_activate(e.slot, step,
                                               kind=e.server_kind,
                                               region=e.region)

    def run(self, state: TrainState, num_steps: int, start_step: int = 0,
            on_step: Optional[Callable[[int, Dict], None]] = None
            ) -> TrainState:
        rec = self.rec
        for step in range(start_step, start_step + num_steps):
            self._apply_events(state, step)
            if self.cluster.n_active == 0:
                raise RuntimeError(f"no active workers at step {step}")
            t0 = time.monotonic()
            t_rec = rec.now()
            batch, mask = slot_batch(self.model.cfg, self.dataset, step,
                                     self.cluster)
            if self.allocator is not None:
                per = next(iter(batch.values())).shape[1]
                alloc = self.allocator.allocation()
                counts = np.minimum(alloc.counts, per)   # layout capacity
                state, m = self.step_fn(state, batch, counts, alloc.lr_ratio)
            else:
                state, m = self.step_fn(state, batch, mask)
            loss = float(m["loss"])
            n_active = int(m["active"])
            self.step_seconds.append(time.monotonic() - t0)
            self.metrics_log.append(
                {"step": step, "loss": loss,
                 "active": n_active, "lr": float(m["lr"])})
            if rec.enabled:
                dt = rec.now() - t_rec
                rec.span_at(obs.EV_STEP, cat=obs.CAT_TRAIN,
                            t_wall=t_rec, dur_wall=dt,
                            sim_t=float(step), dur_sim=1.0,
                            loss=loss, n_active=n_active, mode=self.mode)
                rec.metrics.counter("steps_total", mode=self.mode).inc()
                rec.metrics.histogram("step_latency_ms").observe(dt * 1e3)
                rec.metrics.gauge("workers", mode=self.mode).set(n_active)
                if self.allocator is not None:
                    rec.metrics.gauge("examples_per_step").set(
                        float(m["examples"]))
            if on_step is not None:
                on_step(step, m)
            if (self.ckpt is not None and self.tcfg.checkpoint_every
                    and (step + 1) % self.tcfg.checkpoint_every == 0):
                self.ckpt.save(step + 1, state)
        return state

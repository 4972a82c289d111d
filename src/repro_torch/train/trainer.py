"""Trainer: checkpointed, restartable training loop (counterpart of
``repro.train.trainer``), and the held-out accuracy the gym reads.

A thin loop over ``make_train_step``: restore-on-start (the master-less
checkpoint scan of ``core/checkpoint.py``), periodic saves every
``tcfg.checkpoint_every`` steps, and the revocation warning's fast save.
Elastic membership is layered on top by ``core.elastic.ElasticRuntime``;
this class is the static-cluster loop the paper starts from and the
restart harness both paths share.

Restart contract (paper C3): the data pipeline is pure in (step, shard,
num_shards), and ``step`` rides inside the checkpoint payload, so a
revocation + restore replays from the exact next batch — at most one
global batch of work is lost.

Not ported yet: the ``obs`` recorder (ROADMAP.md Queue 1 item 4); a
``recorder`` raises. The ``metrics_log`` list keeps the reference's keys.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.config import TrainConfig
from repro_torch.core.checkpoint import CheckpointManager
from repro_torch.core.elastic import RECORDER
from repro_torch.data.pipeline import ShardedDataset
from repro_torch.models.builder import Model
from repro_torch.train.step import TrainState, init_state, make_train_step

Tree = Dict[str, Any]


@torch.no_grad()
def evaluate_accuracy(model: Model, params: Tree,
                      batch: Dict[str, torch.Tensor]) -> float:
    """Held-out top-1 accuracy of ``params`` on one batch: classification
    accuracy for the resnet family, next-token accuracy for the others.

    Needs no gradient, so a model built with ``attn_impl="cuda"`` runs
    the flash kernel here."""
    logits, _aux = model.apply(params, batch)
    pred = torch.argmax(logits, dim=-1)
    return float((pred == batch["labels"]).float().mean())


@dataclasses.dataclass
class Trainer:
    model: Model
    tcfg: TrainConfig
    dataset: ShardedDataset
    ckpt: Optional[CheckpointManager] = None
    log_every: int = 50
    recorder: Optional[Any] = None

    def __post_init__(self):
        if self.recorder is not None:
            raise NotImplementedError(RECORDER)
        if self.ckpt is not None and not isinstance(self.ckpt,
                                                    CheckpointManager):
            raise TypeError(f"ckpt must be a CheckpointManager, not "
                            f"{type(self.ckpt).__name__}")
        self.step_fn = make_train_step(self.model, self.tcfg)
        self.metrics_log: List[Dict[str, float]] = []

    # -- lifecycle ----------------------------------------------------------
    def init_or_restore(self, generator: Optional[torch.Generator] = None
                        ) -> TrainState:
        """The newest valid checkpoint, restored onto the model's device;
        without one, float32 masters from ``generator`` (by default seeded
        with ``tcfg.seed``)."""
        if self.ckpt is not None:
            got = self.ckpt.restore_latest(self.model.device)
            if got is not None:
                _step, state, _extra = got
                return state
        return init_state(self.model, self.tcfg, generator)

    def fit(self, state: TrainState, num_steps: int, lr_scale: float = 1.0,
            on_step: Optional[Callable[[int, Dict], None]] = None
            ) -> TrainState:
        start = int(state.step)
        t0 = time.monotonic()
        for step in range(start, start + num_steps):
            batch = self.dataset.global_batch_at(step)
            state, m = self.step_fn(state, batch, lr_scale)
            if on_step is not None:
                on_step(step, m)
            if (step + 1) % self.log_every == 0 or step == start:
                self.metrics_log.append({
                    "step": step, "loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"]), "lr": float(m["lr"]),
                    "wall_s": time.monotonic() - t0,
                })
            if (self.ckpt is not None and self.tcfg.checkpoint_every
                    and (step + 1) % self.tcfg.checkpoint_every == 0):
                self.ckpt.save(step + 1, state)
        return state

    # revocation-warning hook (GCE: 30 s). One replica, fsync'd, returns.
    def on_revocation_warning(self, state: TrainState) -> None:
        if self.ckpt is not None:
            self.ckpt.save(int(state.step), state, fast=True,
                           extra={"reason": "revocation_warning"})

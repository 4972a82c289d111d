"""Trainer: the static-cluster training loop (counterpart of
``repro.train.trainer``), and the held-out accuracy the gym reads.

A thin loop over ``make_train_step``: batch ``step`` of the dataset is a
pure function of the step, so a restart would replay from the exact next
batch. Not ported yet: checkpointing (``ckpt``, restore on start, the
periodic and revocation-warning saves; ROADMAP.md Queue 1 item 2,
``core/checkpoint.py``) and the ``obs`` recorder (Queue 1 item 4). The
``metrics_log`` list keeps the reference's keys.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.config import TrainConfig
from repro_torch.data.pipeline import ShardedDataset
from repro_torch.models.builder import Model
from repro_torch.train.step import TrainState, init_state, make_train_step

Tree = Dict[str, Any]


@torch.no_grad()
def evaluate_accuracy(model: Model, params: Tree,
                      batch: Dict[str, torch.Tensor]) -> float:
    """Held-out next-token top-1 accuracy of ``params`` on one batch.

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
    ckpt: Optional[Any] = None
    log_every: int = 50

    def __post_init__(self):
        if self.ckpt is not None:
            raise NotImplementedError(
                "checkpointing is not ported to PyTorch yet; see ROADMAP.md "
                "Queue 1 item 2 (core/checkpoint.py)")
        self.step_fn = make_train_step(self.model, self.tcfg)
        self.metrics_log: List[Dict[str, float]] = []

    def init_or_restore(self, generator: Optional[torch.Generator] = None
                        ) -> TrainState:
        """A fresh state (no checkpoint to restore from): float32 masters
        from ``generator``, by default seeded with ``tcfg.seed``."""
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
        return state

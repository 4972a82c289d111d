"""Deterministic sharded data pipeline (counterpart of
``repro.data.pipeline``), for the language-model families the port runs.

Batches are a pure function of ``(step, shard_id, num_shards, seed)``, so
a restart from a checkpointed step replays the exact stream and a change
of membership re-partitions it with no coordination (the paper's C3
bound). The draws are numpy's, bit-identical to the reference's: the same
``SeedSequence``, the same calls in the same order. Only then do the
arrays become ``torch.int64`` tensors on the device.

Not ported yet: the ResNet/CIFAR batches and ``Cifar10Like`` (ROADMAP.md
Queue 1 item 2, with ResNet-32), and the multimodal and encoder-decoder
batches (Queue 1 item 6).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device

# Families whose batches the port does not build yet, and the ROADMAP.md
# Queue 1 item that ports each.
_UNPORTED = {
    "resnet": "Queue 1 item 2 (the paper's ResNet-32)",
    "vlm": "Queue 1 item 6 (MoE, multimodal and encoder-decoder)",
    "encdec": "Queue 1 item 6 (MoE, multimodal and encoder-decoder)",
}


def _fold(seed: int, *vals: int) -> np.random.Generator:
    # counter-based: a fresh generator per (seed, step, shard); cheap & pure
    ss = np.random.SeedSequence([seed, *[int(v) & 0x7FFFFFFF for v in vals]])
    return np.random.default_rng(ss)


def lm_batch_keys(cfg: ModelConfig) -> Tuple[str, ...]:
    if cfg.family == "vlm":
        return ("tokens", "patch_embeds", "mrope_positions", "labels")
    if cfg.family == "encdec":
        return ("frame_embeds", "tokens", "labels")
    if cfg.family == "resnet":
        return ("images", "labels")
    return ("tokens", "labels")


def make_batch(cfg: ModelConfig, batch: int, seq_len: int, *, seed: int = 0,
               step: int = 0, np_rng: Optional[np.random.Generator] = None,
               device="cuda") -> Dict[str, torch.Tensor]:
    """One synthetic next-token batch: tokens (B, S) and labels (B, S),
    the labels the tokens shifted by one, int64 on ``device``."""
    if cfg.family in _UNPORTED:
        raise NotImplementedError(
            f"{cfg.name}: {cfg.family!r} batches are not ported to PyTorch "
            f"yet; see ROADMAP.md {_UNPORTED[cfg.family]}")
    device = resolve_device(device)
    rng = np_rng or _fold(seed, step)
    V = max(2, cfg.vocab_size)
    tokens = rng.integers(0, V, size=(batch, seq_len + 1))
    tokens = torch.from_numpy(tokens).to(device=device, dtype=torch.int64)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


@dataclasses.dataclass(frozen=True)
class ShardedDataset:
    """Pure-function dataset: batch = f(step, shard, num_shards, seed),
    delivered on ``device``."""
    cfg: ModelConfig
    global_batch: int
    seq_len: int
    seed: int = 0
    device: str = "cuda"

    def shard_batch(self, step: int, shard: int, num_shards: int
                    ) -> Dict[str, torch.Tensor]:
        if self.global_batch % num_shards:
            raise ValueError(f"global batch {self.global_batch} not divisible "
                             f"by {num_shards} shards")
        per = self.global_batch // num_shards
        rng = _fold(self.seed, step, shard, num_shards)
        return make_batch(self.cfg, per, self.seq_len, np_rng=rng,
                          device=self.device)

    def global_batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        rng = _fold(self.seed, step, 0, 1)
        return make_batch(self.cfg, self.global_batch, self.seq_len,
                          np_rng=rng, device=self.device)

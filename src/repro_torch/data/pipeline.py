"""Deterministic sharded data pipeline (counterpart of
``repro.data.pipeline``), for every family the port runs, and the
learnable ``Cifar10Like`` task.

Batches are a pure function of ``(step, shard_id, num_shards, seed)``, so
a restart from a checkpointed step replays the exact stream and a change
of membership re-partitions it with no coordination (the paper's C3
bound). The draws are numpy's, bit-identical to the reference's: the same
``SeedSequence``, the same calls in the same order. Only then do the
arrays become tensors on the device: ``torch.int64`` tokens, labels and
M-RoPE positions, ``float32`` images (B, H, W, 3), patch and frame
embeddings in ``cfg.dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import modality
from repro_torch.models.layers import torch_dtype

# the families whose batches are token streams
_TOKEN_FAMILIES = ("dense", "moe", "hybrid", "ssm")


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
    """One synthetic batch with the input layout of ``cfg``, on
    ``device``:
    - the token families: tokens (B, S) and labels (B, S), the labels the
      tokens shifted by one;
    - vlm: text tokens (B, S_txt), patch embeddings (B, S_img, d) in
      ``cfg.dtype``, M-RoPE positions (B, S, 3) and labels (B, S), drawn
      in that order (the image prefix's labels are masked by the loss);
    - encdec: frame embeddings (B, S_enc, d) in ``cfg.dtype``, decoder
      tokens and labels (B, S_dec), drawn in that order;
    - resnet: normal images (B, H, W, 3) float32 and class labels (B,)
      (``seq_len`` unused).
    Integers are int64. The embeddings are normal draws, float32 x 0.02,
    then cast, as the reference's. On the ``meta`` device nothing is
    drawn: the leaves are the same shapes and dtypes, without data
    (``repro_torch.launch.specs``). ValueError for an unknown family."""
    if cfg.family not in _TOKEN_FAMILIES + ("vlm", "encdec", "resnet"):
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
    device = torch.device(device)
    meta = device.type == "meta"
    if not meta:
        device = resolve_device(device)
    rng = None if meta else (np_rng or _fold(seed, step))

    def ints(high, shape):
        if meta:
            return torch.empty(shape, dtype=torch.int64, device=device)
        return torch.from_numpy(rng.integers(0, high, size=shape)).to(
            device=device, dtype=torch.int64)

    def normal(shape, dtype, scale=None):
        if meta:
            return torch.empty(shape, dtype=dtype, device=device)
        a = rng.normal(size=shape)
        if scale is not None:
            a = a.astype(np.float32) * scale
        return torch.from_numpy(a).to(device=device, dtype=dtype)

    def embeds(shape):
        return normal(shape, torch_dtype(cfg.dtype), 0.02)

    V = max(2, cfg.vocab_size)
    if cfg.family == "vlm":
        n_img, n_txt = modality.vlm_split(cfg, seq_len)
        tokens = ints(V, (batch, n_txt))
        patches = embeds((batch, n_img, cfg.d_model))
        return {"tokens": tokens, "patch_embeds": patches,
                "mrope_positions": modality.mrope_positions(
                    cfg, batch, seq_len, device),
                "labels": ints(V, (batch, seq_len))}
    if cfg.family == "encdec":
        ne, nd = modality.encdec_split(cfg, seq_len)
        frames = embeds((batch, ne, cfg.d_model))
        return {"frame_embeds": frames, "tokens": ints(V, (batch, nd)),
                "labels": ints(V, (batch, nd))}
    if cfg.family == "resnet":
        images = normal((batch, cfg.image_size, cfg.image_size, 3),
                        torch.float32)
        return {"images": images,
                "labels": ints(cfg.num_classes, (batch,))}
    tokens = ints(V, (batch, seq_len + 1))
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


# ---------------------------------------------------------------------------
# A learnable CIFAR-10-like task (planted signal) for accuracy experiments
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Cifar10Like:
    """32x32x3 images whose class plants a low-rank directional signal
    (a copy of the reference's, drawn with the same numpy calls, so one
    seed gives the same images in both packages).

    Small models reach high accuracy quickly, and *ordering/staleness of
    updates changes the outcome*. Deterministic in (seed, step); batches
    land on ``device``.
    """
    num_classes: int = 10
    image_size: int = 32
    signal: float = 3.0
    seed: int = 0
    # per-class channel-mean (color) shift: a random pixel-space direction
    # has ~zero spatial mean, so global-average-pool architectures (the
    # resnet family) never see it; the color component survives pooling
    color_signal: float = 0.0
    device: str = "cuda"

    def _dirs(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed + 1234)
        d = rng.normal(size=(self.num_classes,
                             self.image_size * self.image_size * 3))
        return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)

    def _colors(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed + 4321)
        c = rng.normal(size=(self.num_classes, 3))
        return (c / np.linalg.norm(c, axis=1, keepdims=True)).astype(np.float32)

    def batch(self, step: int, batch: int, *, shard: int = 0,
              num_shards: int = 1) -> Dict[str, torch.Tensor]:
        rng = _fold(self.seed, step, shard, num_shards)
        y = rng.integers(0, self.num_classes, size=(batch,))
        x = rng.normal(size=(batch, self.image_size * self.image_size * 3)
                       ).astype(np.float32)
        x = x + self.signal * self._dirs()[y]
        x = x.reshape(batch, self.image_size, self.image_size, 3)
        if self.color_signal:
            x = x + self.color_signal * self._colors()[y][:, None, None, :]
        device = resolve_device(self.device)
        return {"images": torch.from_numpy(x).to(device),
                "labels": torch.from_numpy(y).to(device=device,
                                                 dtype=torch.int64)}

    def eval_batch(self, batch: int = 512) -> Dict[str, torch.Tensor]:
        return self.batch(10_000_019, batch)   # held-out step namespace

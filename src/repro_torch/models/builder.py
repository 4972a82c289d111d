"""Model builder (counterpart of ``repro.models.builder``): a uniform
callable surface over the ported stacks (init, apply, decode), bound to
one device. The resnet family (``models/resnet.py``) has init and apply
and no decode cache, as in the reference (``init_cache`` and ``decode``
raise for it); every other ported family is a ``models/transformer.py``
stack.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import resnet, transformer
from repro_torch.tree import tree_map

Tree = Dict[str, Any]


def init_params(cfg: ModelConfig, generator, device,
                dtype: Optional[torch.dtype] = None) -> Tree:
    """The family's ``init_params`` (``None`` generator on ``meta``)."""
    stack = resnet if cfg.family == "resnet" else transformer
    return stack.init_params(cfg, generator, device, dtype)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device

    def init(self, generator: Optional[torch.Generator],
             dtype: Optional[torch.dtype] = None) -> Tree:
        """Parameters drawn from ``generator`` (which lives on
        ``self.device``), stored in ``cfg.dtype`` or, for training's
        masters, in ``dtype=torch.float32``."""
        return init_params(self.cfg, generator, self.device, dtype)

    def apply(self, params: Tree, batch: Dict[str, torch.Tensor],
              remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full forward: (logits (B, S, V), or (B, classes) for resnet,
        aux loss)."""
        stack = resnet if self.cfg.family == "resnet" else transformer
        return stack.forward(params, self.cfg, batch, remat=remat)

    def init_cache(self, batch: int, max_len: int,
                   device: Optional[torch.device] = None) -> Tree:
        return transformer.init_decode_cache(
            self.cfg, batch, max_len, device or self.device)

    def decode(self, params: Tree, cache: Tree,
               batch: Dict[str, torch.Tensor],
               advance: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Tree]:
        return transformer.decode_step(params, self.cfg, cache, batch,
                                       advance)

    def generator(self, seed: int) -> torch.Generator:
        """A seeded generator on this model's device, for ``init``."""
        return torch.Generator(device=self.device).manual_seed(seed)


def cache_batch_axes(model: Model, max_len: int = 8) -> Tree:
    """Per-leaf batch-axis index of the decode cache, derived from the
    cache layout itself: the cache is built on the ``meta`` device (no
    allocation) at two batch sizes, and the one axis whose extent differs
    is the batch axis. A non-batch dimension that happens to equal the
    batch size cannot be mistaken for it."""
    b1, b2 = 3, 5
    c1 = model.init_cache(b1, max_len, device=torch.device("meta"))
    c2 = model.init_cache(b2, max_len, device=torch.device("meta"))

    def axis(a, b):
        diffs = [i for i, (x, y) in enumerate(zip(a.shape, b.shape))
                 if x != y]
        if len(diffs) != 1:
            raise ValueError(f"cannot derive batch axis: shapes "
                             f"{tuple(a.shape)} vs {tuple(b.shape)} differ "
                             f"on axes {diffs}")
        return diffs[0]

    return tree_map(axis, c1, c2)


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    if cfg.family != "resnet":
        transformer.require_ported(cfg)
    return Model(cfg=cfg, device=resolve_device(device))

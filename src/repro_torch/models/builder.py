"""Model builder (counterpart of ``repro.models.builder``): a uniform
callable surface over the ported stacks (init, apply, decode, paged
decode), bound to one device. The resnet family (``models/resnet.py``)
has init and apply and no decode cache, as in the reference (the cache
and decode methods raise for it); every other ported family is a
``models/transformer.py`` stack.
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
                   device: Optional[torch.device] = None, *,
                   enc_len: int = 0, kv_heads: Optional[int] = None,
                   recurrent_split: int = 1) -> Tree:
        """The decode cache; ``enc_len`` sizes encdec's cross caches;
        ``kv_heads`` and ``recurrent_split`` make a tensor-parallel rank's
        block of it (``launch.specs.cache_block`` gives them)."""
        return transformer.init_decode_cache(
            self.cfg, batch, max_len, device or self.device, enc_len=enc_len,
            kv_heads=kv_heads, recurrent_split=recurrent_split)

    def decode(self, params: Tree, cache: Tree,
               batch: Dict[str, torch.Tensor],
               advance: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Tree]:
        return transformer.decode_step(params, self.cfg, cache, batch,
                                       advance)

    def init_paged_cache(self, batch: int, max_len: int, *, page_size: int,
                         num_pages: int,
                         device: Optional[torch.device] = None,
                         enc_len: int = 0,
                         kv_heads: Optional[int] = None,
                         recurrent_split: int = 1) -> Tree:
        return transformer.init_paged_decode_cache(
            self.cfg, batch, max_len, page_size=page_size,
            num_pages=num_pages, device=device or self.device,
            enc_len=enc_len, kv_heads=kv_heads,
            recurrent_split=recurrent_split)

    def decode_paged(self, params: Tree, cache: Tree,
                     batch: Dict[str, torch.Tensor], advance=None
                     ) -> Tuple[torch.Tensor, Tree]:
        return transformer.decode_step_paged(params, self.cfg, cache, batch,
                                             advance)

    def generator(self, seed: int) -> torch.Generator:
        """A seeded generator on this model's device, for ``init``."""
        return torch.Generator(device=self.device).manual_seed(seed)


def cache_batch_axes(model: Model, max_len: int = 8,
                     enc_len: int = 0) -> Tree:
    """Per-leaf batch-axis index of the decode cache, derived from the
    cache layout itself: the cache is built on the ``meta`` device (no
    allocation) at two batch sizes, and the one axis whose extent differs
    is the batch axis. A non-batch dimension that happens to equal the
    batch size cannot be mistaken for it."""
    meta = torch.device("meta")
    return tree_map(_batch_axis, *(
        model.init_cache(b, max_len, device=meta, enc_len=enc_len)
        for b in (3, 5)))


def paged_cache_axes(model: Model, max_len: int = 8, *, page_size: int = 4,
                     num_pages: int = 8, enc_len: int = 0) -> Tree:
    """Per-leaf batch axis of the PAGED decode cache, by the same two
    probes as :func:`cache_batch_axes`, except that leaves whose shape
    does not scale with the batch (the physical page pools, shared across
    rows) map to the sentinel ``-1``
    (``repro_torch.serving.paging.POOL_AXIS_SENTINEL``)."""
    meta = torch.device("meta")
    c1, c2 = (model.init_paged_cache(b, max_len, page_size=page_size,
                                     num_pages=num_pages, device=meta,
                                     enc_len=enc_len)
              for b in (3, 5))
    return tree_map(lambda a, b: _batch_axis(a, b, pool=-1), c1, c2)


def _batch_axis(a: torch.Tensor, b: torch.Tensor,
                pool: Optional[int] = None) -> int:
    """The one axis on which two probes of a leaf differ; ``pool`` if they
    differ on none and a pool leaf is allowed there."""
    diffs = [i for i, (x, y) in enumerate(zip(a.shape, b.shape)) if x != y]
    if not diffs and pool is not None:
        return pool
    if len(diffs) != 1:
        raise ValueError(f"cannot derive batch axis: shapes "
                         f"{tuple(a.shape)} vs {tuple(b.shape)} differ on "
                         f"axes {diffs}")
    return diffs[0]


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    """The model of ``cfg`` on ``device``; ValueError for an unknown
    family."""
    if cfg.family != "resnet":
        transformer.check_family(cfg)
    return Model(cfg=cfg, device=resolve_device(device))

"""Optimizers over nested-dict trees (counterpart of
``repro.optim.optimizers``): SGD with momentum (the paper's, Table II)
and AdamW for the language models.

The reference's optimizers are pure: ``update`` returns updates and a new
state, and the step adds the updates to the parameters. At full width
that purity costs memory the card does not have: starcoder2-3b's stacked
MLP weights are 30 x 3072 x 12288 float32, 4.5 GB a leaf, and every
out-of-place temporary of the masters, gradients and moments would add
tens of GB. So here ``update(grads, state, params, lr)`` updates the
float32 masters and moments IN PLACE, under ``torch.no_grad()``, with
``mul_``/``add_``/``addcmul_``-style ops on chunks of at most ``CHUNK``
elements of each flattened leaf (the only temporaries), and returns the
new state. The arithmetic is the reference's, term for term: AdamW's
bias correction from an int count, weight decay as ``-lr * wd * p``.
"""
from __future__ import annotations

from typing import (Any, Callable, Dict, Iterator, NamedTuple, Optional,
                    Tuple)

import numpy as np
import torch

from repro_torch.config import OptimizerConfig
from repro_torch.tree import tree_leaves, tree_map

Tree = Dict[str, Any]
CHUNK = 1 << 24          # elements per in-place step: 64 MB of float32


class Optimizer(NamedTuple):
    init: Callable[[Tree], Tree]
    update: Callable[..., Tree]      # (grads, state, params, lr) -> state


def _chunks(*leaves: torch.Tensor) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Matching chunks of the flattened leaves; views, so in-place ops on
    a chunk write the leaf."""
    return zip(*(t.view(-1).split(CHUNK) for t in leaves))


def _zeros_like(params: Tree) -> Tree:
    return tree_map(torch.zeros_like, params)


def _each(fn: Callable, params: Tree, *trees: Tree) -> None:
    """``fn(p, *others)`` on matching chunks of every leaf."""
    def leaf(p, *others):
        for parts in _chunks(p, *others):
            fn(*parts)
    tree_map(leaf, params, *trees)


def sgd_momentum(momentum: float = 0.9, weight_decay: float = 0.0,
                 nesterov: bool = False) -> Optimizer:
    def init(params):
        return {"mu": _zeros_like(params)}

    @torch.no_grad()
    def update(grads, state, params, lr):
        def one(p, g, mu):
            if weight_decay:
                g = g + weight_decay * p
            mu.mul_(momentum).add_(g)                 # momentum * mu + g
            step = g + momentum * mu if nesterov else mu
            p.add_(step, alpha=-lr)                   # p + (-lr * step)
        _each(one, params, grads, state["mu"])
        return state

    return Optimizer(init, update)


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"m": _zeros_like(params), "v": _zeros_like(params),
                "count": 0}

    @torch.no_grad()
    def update(grads, state, params, lr):
        count = state["count"] + 1
        # float32 bias corrections, as the reference computes them
        c1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        c2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))

        def one(p, g, m, v):
            m.mul_(b1).add_(g, alpha=1 - b1)          # b1 m + (1-b1) g
            v.mul_(b2).addcmul_(g, g, value=1 - b2)   # b2 v + (1-b2) g^2
            upd = (m / c1).div_((v / c2).sqrt_().add_(eps))
            if weight_decay:
                upd.add_(p, alpha=weight_decay)
            p.add_(upd, alpha=-lr)                    # p + (-lr * upd)
        _each(one, params, grads, state["m"], state["v"])
        return {**state, "count": count}

    return Optimizer(init, update)


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, without a
    squared copy of any leaf."""
    total = sum(torch.linalg.vector_norm(x.float()) ** 2
                for _, x in tree_leaves(tree))
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads: Tree, max_norm: float,
                        norm: Optional[torch.Tensor] = None
                        ) -> Tuple[Tree, torch.Tensor]:
    """Scale ``grads`` IN PLACE so their global norm is at most
    ``max_norm``; returns (grads, the norm before clipping). ``norm`` is
    that norm when the caller has it (a sharded tree's, over all ranks);
    by default this tree's ``global_norm``."""
    if norm is None:
        norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    for _, g in tree_leaves(grads):
        g.mul_(scale.to(g.dtype))
    return grads, norm


def make_optimizer(cfg: OptimizerConfig) -> Optimizer:
    if cfg.name == "momentum":
        return sgd_momentum(cfg.momentum, cfg.weight_decay)
    if cfg.name == "adamw":
        return adamw(cfg.beta1, cfg.beta2, cfg.eps, cfg.weight_decay)
    raise ValueError(f"unknown optimizer {cfg.name!r}")

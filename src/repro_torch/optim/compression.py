"""Gradient compression for the slow (cross-pod) link (counterpart of
``repro.optim.compression``), on nested-dict trees of tensors.

Two schemes from the distributed-training literature the paper cites:
- top-k sparsification with error feedback (Deep Gradient Compression,
  Lin et al. [28]): keep the largest-magnitude k fraction, accumulate the
  residual locally so dropped mass is not lost. It draws nothing, so it
  equals the reference's result exactly, ties at the threshold included
  (``>=``).
- TernGrad (Wen et al. [29]): stochastic ternarization {-s, 0, +s}. The
  reference draws its Bernoulli mask with ``jax.random``; here the draws
  come from an explicit ``torch.Generator`` (one uniform per element,
  leaves in key order), so the mask differs from the reference's while
  keeping its law: ``P(+-s) = |g| / s``.

Both are pure per-leaf transforms: no input is modified.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.tree import tree_map

Tree = Dict[str, Any]


class CompressionState(NamedTuple):
    error: Tree      # error-feedback residual (zeros for ternary)


def init_state(params: Tree) -> CompressionState:
    return CompressionState(error=tree_map(torch.zeros_like, params))


def _topk_leaf(g: torch.Tensor, err: torch.Tensor, ratio: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return (sparse gradient with only top-k kept, new residual)."""
    acc = g + err
    flat = acc.reshape(-1)
    k = max(1, int(flat.numel() * ratio))
    thresh = torch.topk(flat.abs(), k).values[-1]
    kept = torch.where(acc.abs() >= thresh, acc, torch.zeros_like(acc))
    return kept, acc - kept


def topk_compress(grads: Tree, state: CompressionState, ratio: float
                  ) -> Tuple[Tree, CompressionState]:
    out = tree_map(lambda g, e: _topk_leaf(g, e, ratio), grads, state.error)
    kept = tree_map(lambda t: t[0], out)
    err = tree_map(lambda t: t[1], out)
    return kept, CompressionState(error=err)


def topk_decompress(kept: Tree) -> Tree:
    return kept   # dense carrier; sparsity is what shrinks the collective


def _ternary_leaf(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Ternarize ``g`` with the uniform draws ``u`` (same shape, in
    [0, 1)): an element keeps ``sign(g) * s`` where ``u < |g| / s``."""
    s = g.abs().max()
    p = torch.where(s > 0, g.abs() / s, torch.zeros_like(g)).float()
    b = (u < p).to(g.dtype)
    return (torch.sign(g) * b * s).to(g.dtype)


def ternary_compress(grads: Tree,
                     generator: Optional[torch.Generator] = None) -> Tree:
    """TernGrad of every leaf, one uniform per element drawn from
    ``generator`` (which lives on the leaves' device)."""
    return tree_map(lambda g: _ternary_leaf(g, torch.rand(
        g.shape, generator=generator, device=g.device)), grads)


def ternary_decompress(t: Tree) -> Tree:
    return t


def compression_bytes_ratio(scheme: str, ratio: float = 0.01) -> float:
    """Approximate on-the-wire bytes vs dense fp32 (for the roofline model)."""
    if scheme == "none":
        return 1.0
    if scheme == "topk":
        # value+index per kept entry: 8 bytes vs 4 -> 2 * ratio
        return 2.0 * ratio
    if scheme == "ternary":
        return 2.0 / 32.0   # 2 bits per entry + scalar scale
    raise ValueError(scheme)

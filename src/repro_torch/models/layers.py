"""Shared building blocks: parameter init, RMS norm, rotary embeddings,
embedding and unembedding.

Parameters are nested dicts of tensors laid out like the reference's
unboxed pytrees (``repro.models.layers``). The reference keeps float32
masters and casts each weight to the activation dtype where it is used
(``.astype(dt)``); the port does the same, so training holds float32
masters. For serving, weight matrices, biases and embeddings are stored
once in ``cfg.dtype``, which makes every cast at use a no-op and gives
the same values without the per-use copy. RMS gammas stay float32 either
way, because the reference reads them in float32 (``rms_norm`` upcasts
``gamma``, never downcasts it).

The weights may be ``sharding.Sharded`` leaves, gathered where they are
used. Under the ``tp`` layout the embedding is vocabulary-parallel (the
rank's rows of ``tok``: ids outside them give 0, then one all-reduce) and
the unembedding column-parallel (the rank's vocabulary block of the
logits), and an RMS norm over channels split across ranks sums its
statistic over them (``rms_norm(split=)``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch

from repro_torch import sharding as SH

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


def param(gen: Optional[torch.Generator], shape: Sequence[int], *,
          dtype: torch.dtype, device: torch.device,
          scale: Optional[float] = None, init: str = "normal") -> torch.Tensor:
    """One parameter, initialised like ``repro.models.layers.param``:
    ``scale=None`` means normal x 1/sqrt(fan_in), with fan_in the first
    axis of a matrix; ``init="zeros"`` for biases and gammas, ``"ones"``
    for Mamba-2's skip gains. The draw is float32 from ``gen``, then cast
    to ``dtype``."""
    shape = tuple(shape)
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if scale is None:
        fan_in = shape[0] if len(shape) > 1 else shape[-1]
        scale = 1.0 / math.sqrt(max(1, fan_in))
    v = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (v * scale).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5, split=(None, ())) -> torch.Tensor:
    """fp32 RMS norm scaled by ``1 + gamma`` (gamma stored zero-centred).
    ``split`` (mesh, axes): ``x``'s last dim (and ``gamma``) is this
    rank's block of one split over the ranks of ``axes``, and the mean
    of squares is over all of it: one all-reduce of the rank's sums,
    whose backward sums too (every rank's statistic reads every
    rank's channels)."""
    gamma = SH.take(gamma)
    x32 = x.float()
    mesh, axes = split
    if axes:
        sq = SH.all_reduce(x32.square().sum(dim=-1, keepdim=True), mesh,
                           axes)
        var = sq / (x.shape[-1] * mesh.group_size(axes))
    else:
        var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + gamma.float())).to(x.dtype)


def init_rms(gen, d: int, device) -> Dict[str, torch.Tensor]:
    return {"gamma": param(gen, (d,), dtype=torch.float32, device=device,
                           init="zeros")}


# ---------------------------------------------------------------------------
# Rotary position embeddings (half-split, not interleaved)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)            # (D/2,)
    ang = positions[..., None].float() * freqs                  # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]                          # (..., S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions_thw: torch.Tensor,
                theta: float) -> torch.Tensor:
    """Qwen2-VL multimodal rotary. x: (..., S, H, D); positions_thw:
    (..., S, 3) = (t, h, w) ids. The D/2 frequency channels split 2:1:1
    across the (t, h, w) sections (32/16/16 at D = 128); the angles are
    float32 and the result is cast back to ``x.dtype``, as ``apply_rope``
    does."""
    D = x.shape[-1]
    half = D // 2
    sec_t = half // 2
    sec_h = (half - sec_t) // 2
    freqs = rope_freqs(D, theta, x.device)                      # (D/2,)
    # each channel's position: t for the first section, then h, then w
    which = torch.cat([torch.full((n,), i, device=x.device) for i, n in
                       enumerate((sec_t, sec_h, half - sec_t - sec_h))])
    ang = positions_thw.float().index_select(-1, which) * freqs   # (.., S, D/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def init_embed(gen, vocab: int, d_model: int, tie: bool, *, dtype,
               device) -> Dict[str, torch.Tensor]:
    p = {"tok": param(gen, (vocab, d_model), dtype=dtype, device=device,
                      scale=1.0)}
    if not tie:
        p["out"] = param(gen, (d_model, vocab), dtype=dtype, device=device)
    return p


def embed(params: Dict[str, torch.Tensor], tokens: torch.Tensor,
          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Gather, then cast to ``dtype`` (default: the stored dtype): the
    reference's cast-then-gather gives the same numbers, and this way only
    the gathered rows are copied. A ``tok`` split on its vocabulary gives
    each rank its rows' embeddings and zeros elsewhere, summed over the
    ranks."""
    leaf = params["tok"]
    tok = SH.take(leaf)
    if not SH.split_axes(leaf):
        x = tok[tokens]
        return x if dtype is None else x.to(dtype)
    rows = tok.shape[0]
    local = tokens - SH.split_index(leaf) * rows
    inside = (local >= 0) & (local < rows)
    x = tok[local.clamp(0, rows - 1)]
    if dtype is not None:
        x = x.to(dtype)
    x = torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))
    return SH.reduce_from(x, *SH.split_group(leaf))


def unembed_leaf(params: Dict[str, torch.Tensor], tie: bool):
    """The leaf the logits are read from: ``tok`` (transposed) when tied,
    else ``out``; its split decides the logits' vocabulary block."""
    return params["tok"] if tie else params["out"]


def unembed(params: Dict[str, torch.Tensor], x: torch.Tensor,
            tie: bool) -> torch.Tensor:
    """x (..., d) -> logits (..., V), or the rank's vocabulary block of
    them when the weight is split on its vocabulary."""
    leaf = unembed_leaf(params, tie)
    w = SH.take(leaf)
    w = w.T if tie else w
    return SH.copy_to(x, *SH.split_group(leaf)) @ w.to(x.dtype)

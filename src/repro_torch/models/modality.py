"""Modality frontend stubs (counterpart of ``repro.models.modality``).

The multimodal (``vlm``) and encoder-decoder (``encdec``) architectures
specify the transformer backbone only; the vision and audio towers are
stubs: batches carry precomputed patch or frame embeddings of the right
shape, and this module gives the layouts and synthetic embeddings.

Layout conventions (the reference's):
- qwen2-vl (``vlm``): a prefix of ``modality_prefix_frac`` of the
  sequence is patch embeddings arranged as a (T=1, H=g, W=g) grid for
  M-RoPE; the rest are text tokens with sequential (t, t, t) positions
  starting at the grid side ``g`` (Qwen2-VL's convention).
- seamless (``encdec``): the encoder consumes frame embeddings only, the
  decoder target tokens; ``enc_len = seq_len // 2`` and the decoder takes
  the rest, so one cell processes ``seq_len`` positions in all.

``synth_patch_embeds`` and ``synth_frame_embeds`` draw from a
``torch.Generator``, so they give other numbers than the reference's
``jax.random`` draws for the same seed; the data pipeline draws its
embeddings with numpy instead, as the reference's does, and those agree.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.models.layers import torch_dtype


def vlm_split(cfg: ModelConfig, seq_len: int) -> Tuple[int, int]:
    """(num_patch_positions, num_text_positions); the patches form a
    square grid."""
    want = int(seq_len * cfg.modality_prefix_frac)
    g = max(1, int(math.sqrt(max(1, want))))
    n_img = g * g
    return n_img, seq_len - n_img


def encdec_split(cfg: ModelConfig, seq_len: int) -> Tuple[int, int]:
    """(encoder frames, decoder tokens)."""
    enc = max(1, seq_len // 2)
    return enc, seq_len - enc


def mrope_positions(cfg: ModelConfig, batch: int, seq_len: int,
                    device="cpu") -> torch.Tensor:
    """(B, S, 3) int64 (t, h, w) ids on ``device``: the image grid first,
    then sequential text continuing after the grid's side."""
    n_img, n_txt = vlm_split(cfg, seq_len)
    g = int(math.sqrt(n_img))
    ar = torch.arange(g, device=device)
    hh, ww = torch.meshgrid(ar, ar, indexing="ij")
    img = torch.stack([torch.zeros(n_img, dtype=torch.int64, device=device),
                       hh.reshape(-1), ww.reshape(-1)], dim=-1)
    t = g + torch.arange(n_txt, device=device)
    txt = torch.stack([t, t, t], dim=-1)
    pos = torch.cat([img, txt], dim=0)
    return pos[None].expand(batch, seq_len, 3)


def synth_patch_embeds(cfg: ModelConfig, batch: int, n_img: int,
                       generator: torch.Generator) -> torch.Tensor:
    """Normal patch embeddings x 0.02 in ``cfg.dtype``, on the
    generator's device."""
    return _normal(cfg, (batch, n_img, cfg.d_model), generator)


def synth_frame_embeds(cfg: ModelConfig, batch: int, n_frames: int,
                       generator: torch.Generator) -> torch.Tensor:
    """Normal frame embeddings x 0.02 in ``cfg.dtype``, on the
    generator's device."""
    return _normal(cfg, (batch, n_frames, cfg.d_model), generator)


def _normal(cfg: ModelConfig, shape, generator: torch.Generator
            ) -> torch.Tensor:
    dt = torch_dtype(cfg.dtype)
    return torch.randn(shape, generator=generator, dtype=dt,
                       device=generator.device) * 0.02

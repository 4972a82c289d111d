"""Plain PyTorch version of decode attention: the CUDA kernel's oracle and
its CPU path (counterpart of ``repro.kernels.decode_attention.ref``)."""
from __future__ import annotations

import torch


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lengths: torch.Tensor, *,
                           window: int = 0) -> torch.Tensor:
    """q: (B, H, D); k/v: (B, KV, S, D); lengths: (B,) int -> (B, H, D).

    Position j of row b is valid iff ``j < min(lengths[b], S)`` and, when
    ``window > 0``, ``j >= lengths[b] - window``. Scale D**-0.5, fp32
    softmax; a row with no valid position gives 0; output in q's dtype."""
    B, H, D = q.shape
    _, KV, S, _ = k.shape
    G = H // KV
    qg = q.float().reshape(B, KV, G, D)
    s = torch.einsum("bkgd,bksd->bkgs", qg, k.float()) * D ** -0.5
    j = torch.arange(S, device=q.device)[None, :]
    length = lengths.to(torch.int64)[:, None]
    mask = j < length
    if window > 0:
        mask &= j >= length - window
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1).nan_to_num(nan=0.0)
    out = torch.einsum("bkgs,bksd->bkgd", p, v.float())
    return out.reshape(B, H, D).to(q.dtype)

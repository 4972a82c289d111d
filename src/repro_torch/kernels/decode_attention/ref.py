"""Plain PyTorch version of decode attention: the CUDA kernel's oracle and
its CPU path (counterpart of ``repro.kernels.decode_attention.ref``)."""
from __future__ import annotations

import torch


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lengths: torch.Tensor, *, window: int = 0,
                           offset: int = 0, return_lse: bool = False):
    """q: (B, H, D); k/v: (B, KV, S, D); lengths: (B,) int -> (B, H, D).

    Key j of the block holds position ``offset + j``; it is valid iff that
    position is below ``lengths[b]`` and, when ``window > 0``, at least
    ``lengths[b] - window``. Scale D**-0.5, fp32 softmax; a row with no
    valid position gives 0; output in q's dtype. ``return_lse`` also
    returns (2, B, H) float32: each (row, head)'s maximum scaled score m
    (-inf with no valid key) and sum l of exp(score - m) (0 with none),
    the partial that blocks of one cache merge by."""
    B, H, D = q.shape
    _, KV, S, _ = k.shape
    G = H // KV
    qg = q.float().reshape(B, KV, G, D)
    s = torch.einsum("bkgd,bksd->bkgs", qg, k.float()) * D ** -0.5
    j = torch.arange(S, device=q.device)[None, :] + offset
    length = lengths.to(torch.int64)[:, None]
    mask = j < length
    if window > 0:
        mask &= j >= length - window
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1).nan_to_num(nan=0.0)
    out = torch.einsum("bkgs,bksd->bkgd", p, v.float())
    out = out.reshape(B, H, D).to(q.dtype)
    if not return_lse:
        return out
    m = s.amax(dim=-1)
    l = torch.where(m == float("-inf"), torch.zeros_like(m),
                    torch.exp(s - m[..., None]).sum(-1))
    return out, torch.stack([m, l]).reshape(2, B, H)


def merge_partials(out: torch.Tensor, lse: torch.Tensor, reduce_max=None,
                   reduce_sum=None) -> torch.Tensor:
    """The output of one cache from its blocks' partials, as
    ``decode_attention_plain`` and the kernel return them with
    ``return_lse``: ``out`` (..., B, H, D) and ``lse`` (..., 2, B, H),
    each block weighed by exp(m - max m) x l (0 without a visible key); a
    row with none anywhere gives 0. Float32 arithmetic, output in
    ``out``'s dtype.

    The blocks lie on the leading axis of ``out`` and ``lse`` by default.
    A cache split over ranks passes each rank's block and the reductions
    over the ranks: ``reduce_max(m)``, the maximum of (B, H) float32
    ``m``, and ``reduce_sum(t)``, the sum of (B, H, D + 1) float32 ``t``
    (the weighted output beside the weight), which may reduce in
    place."""
    if reduce_max is None:
        reduce_max = lambda t: t.amax(dim=0, keepdim=True)  # noqa: E731
        reduce_sum = lambda t: t.sum(dim=0)                 # noqa: E731
    m, l = lse.unbind(-3)
    top = reduce_max(m.clone())
    w = torch.where(m == float("-inf"), torch.zeros_like(m),
                    torch.exp(m - top)) * l
    part = reduce_sum(torch.cat([out.float() * w[..., None], w[..., None]],
                                -1))
    den = part[..., -1:]
    merged = torch.where(den > 0, part[..., :-1] / den.clamp(min=1e-30),
                         torch.zeros_like(den))
    return merged.to(out.dtype)

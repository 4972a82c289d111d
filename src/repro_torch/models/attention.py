"""GQA/MQA/MHA attention: the full-sequence path (training, evaluation)
and the decode path (counterpart of ``repro.models.attention``).

The plain full-sequence path computes attention in query chunks
(``cfg.attn_chunk``), so the score block it holds is (B, KV, G, Cq, Skv)
instead of (B, H, S, S). ``cfg.attn_impl == "cuda"`` runs the flash
kernel instead, on forwards that need no gradient.

Layouts follow the reference at every public function: activations
(B, S, d), q (B, S, H, Dh), k/v (B, S, KV, Dh), caches (B, Smax, KV, Dh).
Sliding windows are per-layer runtime ints; ``window <= 0`` means global.

Tensor parallelism: the weights may come as ``sharding.Sharded`` leaves,
gathered here where they are used (``sharding.take``). Under the ``tp``
layout ``wq``/``bq``/``wo`` stay split on ``heads`` and ``wk``/``wv``/
``bk``/``bv`` on ``kv_heads`` wherever their specs split them over
``model``: q is column-parallel, the output row-parallel (one all-reduce
after ``out_proj``), and attention runs on the rank's heads. When the
query heads are split and the KV heads are not (MQA, or KV not divisible
by the model axis), every rank computes the KV heads whole and reads
those its query heads map to (:func:`kv_range`); the KV heads are never
broadcast. With plain tensors every function computes what it did.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch import sharding as SH
from repro_torch.config import ModelConfig
from repro_torch.kernels.decode_attention.ops import decode_attend
from repro_torch.kernels.decode_attention.ref import merge_partials
from repro_torch.kernels.flash_attention.ops import attention as flash
from repro_torch.models import layers as L
from repro_torch.obs.profiling import ATTN_CORE, annotate_span


def init_attention(gen, cfg: ModelConfig, *, dtype,
                   device) -> Dict[str, torch.Tensor]:
    d, H, KV, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kw = dict(dtype=dtype, device=device)
    p = {
        "wq": L.param(gen, (d, H, Dh), **kw),
        "wk": L.param(gen, (d, KV, Dh), **kw),
        "wv": L.param(gen, (d, KV, Dh), **kw),
        "wo": L.param(gen, (H, Dh, d), **kw),
    }
    if cfg.qkv_bias:
        p["bq"] = L.param(gen, (H, Dh), init="zeros", **kw)
        p["bk"] = L.param(gen, (KV, Dh), init="zeros", **kw)
        p["bv"] = L.param(gen, (KV, Dh), init="zeros", **kw)
    return p


def project(x: torch.Tensor, w) -> torch.Tensor:
    """einsum('bsd,dhk->bshk') as one matrix product, the weight cast to
    the activation dtype (no bias, no rotary: alone, the encoder-decoder's
    cross-attention projections). ``w`` may be a ``Sharded`` leaf: its
    compute form (the rank's heads under tp) is used; the caller passes
    ``x`` through ``sharding.copy_to`` first when it is split."""
    w = SH.take(w)
    d, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).unflatten(-1, (h, k))


def project_qkv(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
                positions: Optional[torch.Tensor] = None,
                mrope_positions: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> q (B,S,H,Dh), k/v (B,S,KV,Dh), rotary applied:
    M-RoPE when ``cfg.use_mrope`` is set and ``mrope_positions`` (B, S, 3)
    is given, else RoPE at ``positions`` (default ``arange(S)``). Under
    tensor parallelism H and KV are the rank's heads (KV all of them when
    ``wk`` is not split)."""
    dt = x.dtype
    xq = SH.copy_to(x, *SH.split_group(p["wq"]))
    xkv = xq if SH.split_axes(p["wk"]) else x
    q, k, v = (project(xq, p["wq"]), project(xkv, p["wk"]),
               project(xkv, p["wv"]))
    if "bq" in p:
        q = q + SH.take(p["bq"]).to(dt)
        k = k + SH.take(p["bk"]).to(dt)
        v = v + SH.take(p["bv"]).to(dt)
    if cfg.use_mrope and mrope_positions is not None:
        q = L.apply_mrope(q, mrope_positions, cfg.rope_theta)
        k = L.apply_mrope(k, mrope_positions, cfg.rope_theta)
        return q, k, v
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def kv_range(p: Dict[str, torch.Tensor], cfg: ModelConfig
             ) -> Tuple[int, int]:
    """[lo, hi): the heads of k/v, as :func:`project_qkv` gives them, that
    the rank's query heads read. Query head h reads KV head h // G
    (G = H / KV). With the query heads split over M ranks and the KV
    heads whole, rank m's heads m*H/M .. cover either whole groups (KV a
    multiple of M) or part of one group (M a multiple of KV); a split
    that straddles groups unevenly is refused."""
    qs, ks = SH.split_axes(p["wq"]), SH.split_axes(p["wk"])
    H, KV = cfg.num_heads, cfg.num_kv_heads
    if not qs:
        if ks:
            raise ValueError("the KV heads are split and the query heads "
                             "are not")
        return 0, KV
    n = p["wq"].mesh.group_size(qs)
    if ks:
        return 0, KV // n
    hl, g = H // n, H // KV
    h0 = SH.split_index(p["wq"]) * hl
    if hl % g == 0 and h0 % g == 0:
        return h0 // g, (h0 + hl) // g
    if g % hl == 0:
        return h0 // g, h0 // g + 1
    raise ValueError(f"{H} query heads over {n} ranks straddle the "
                     f"{KV} KV heads' groups unevenly")


def local_kv(p: Dict[str, torch.Tensor], cfg: ModelConfig, k: torch.Tensor,
             v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """k/v (B, S, KV', Dh) from :func:`project_qkv` -> the heads the
    rank's query heads read (:func:`kv_range`), as views. KV heads
    computed whole for split query heads enter the sharded compute here
    (``sharding.copy_to``: their gradient is summed over the ranks)."""
    lo, hi = kv_range(p, cfg)
    if SH.split_axes(p["wq"]) and not SH.split_axes(p["wk"]):
        group = SH.split_group(p["wq"])
        k, v = SH.copy_to(k, *group), SH.copy_to(v, *group)
    if (lo, hi) != (0, k.shape[2]):
        k, v = k[:, :, lo:hi], v[:, :, lo:hi]
    return k, v


def out_proj(p: Dict[str, torch.Tensor], attn: torch.Tensor) -> torch.Tensor:
    """attn: (B, S, H, Dh) -> (B, S, d); with ``wo`` split on heads, the
    partial products of the rank's heads are summed over the ranks."""
    wo = SH.take(p["wo"])
    H, Dh, d = wo.shape
    out = attn.flatten(-2) @ wo.to(attn.dtype).reshape(H * Dh, d)
    return SH.reduce_from(out, *SH.split_group(p["wo"]))


# ---------------------------------------------------------------------------
# Full-sequence attention (training, evaluation)
# ---------------------------------------------------------------------------

def _chunk_attend(q_chunk: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_off: int, *, causal: bool, window: int,
                  kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q_chunk: (B, Cq, KV, G, Dh); k/v: (B, Skv, KV, Dh) -> (B,Cq,KV,G,Dh).

    As the reference: scores in the input dtype, then float32; masked
    scores are -1e30 (not -inf); the softmax is float32 and its
    probabilities are cast to the input dtype before ``P @ V``. The window
    applies only to causal attention, as in the reference. ``kv_len``
    masks padded kv positions."""
    Dh = q_chunk.shape[-1]
    scores = torch.einsum("bqkgd,bskd->bkgqs", q_chunk, k).float()
    scores = scores * Dh ** -0.5
    Skv = k.shape[1]
    kj = torch.arange(Skv, device=k.device)
    mask = None
    if causal:
        qi = q_off + torch.arange(q_chunk.shape[1], device=k.device)
        mask = kj[None, :] <= qi[:, None]
        if window > 0:
            mask = mask & (kj[None, :] > qi[:, None] - window)
    if kv_len is not None:
        kmask = kj < kv_len
        mask = kmask if mask is None else mask & kmask
    if mask is not None:
        scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q_chunk.dtype)
    return torch.einsum("bkgqs,bskd->bqkgd", probs, v)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           cfg: ModelConfig, *, causal: bool = True, window: int = 0,
           kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full attention. q: (B,S,H,Dh), k/v: (B,Skv,KV,Dh) -> (B,S,H,Dh).

    ``cfg.attn_impl == "cuda"`` runs the flash kernel (forward only: it
    refuses inputs that need a gradient); ``"torch"`` the q-chunked plain
    path, in chunks of ``cfg.attn_chunk`` queries, or one chunk when S is
    not a multiple of it. A loop over the chunks takes the place of the
    reference's ``lax.scan``. Either runs in the span ``attn.core``."""
    with annotate_span(ATTN_CORE):
        if cfg.attn_impl == "cuda":
            if kv_len is not None:
                raise ValueError("attn_impl='cuda' has no kv_len mask (the "
                                 "reference's flash path has none either)")
            return flash(q, k, v, causal=causal, window=window, impl="cuda")
        if cfg.attn_impl != "torch":
            raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
        B, S, H, Dh = q.shape
        KV = k.shape[2]
        qg = q.reshape(B, S, KV, H // KV, Dh)
        C = min(cfg.attn_chunk, S)
        if S % C != 0:
            C = S
        outs = [_chunk_attend(qg[:, i:i + C], k, v, i, causal=causal,
                              window=window, kv_len=kv_len)
                for i in range(0, S, C)]
        out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
        return out.reshape(B, S, H, Dh)


def attend_decode(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, pos: torch.Tensor, *, window: int = 0,
                  impl: str = "cuda", seq: bool = False) -> torch.Tensor:
    """q: (B,1,H,Dh); caches: (B,Smax,KV,Dh); pos: (B,) current index.

    Attends over cache[0..pos] (inclusive: the new token is already
    written). ``impl="cuda"`` runs the Hopper kernel, ``"torch"`` its
    plain version. ``seq``: the cache may be this rank's block of
    positions (``sharding.use_kv_seq``), and then
    :func:`attend_decode_split` merges the ranks' partials."""
    split = seq_split(k_cache) if seq else None
    if split is not None:
        return attend_decode_split(q, k_cache, v_cache, pos, *split,
                                   window=window, impl=impl)
    return decode_attend(q, k_cache, v_cache, pos + 1, window=window,
                         impl=impl)


def seq_split(k_cache: torch.Tensor):
    """(mesh, axes, offset) of a decode cache whose positions are split
    over the ranks of ``axes`` (``sharding.use_kv_seq``): this rank holds
    positions offset .. offset + Smax - 1; None when the cache is
    whole."""
    ctx = SH.kv_seq()
    if ctx is None:
        return None
    mesh, axes = ctx
    return mesh, axes, mesh.index(axes) * k_cache.shape[1]


def seq_offset(k_cache: torch.Tensor) -> int:
    """The position of this rank's first cache slot (0 when whole)."""
    split = seq_split(k_cache)
    return 0 if split is None else split[2]


def attend_decode_split(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, pos: torch.Tensor, mesh,
                        axes, offset: int, *, window: int = 0,
                        impl: str = "cuda") -> torch.Tensor:
    """Decode attention over a cache split on its positions: each rank
    attends over its block (positions ``offset`` ..) and returns its
    partial, the output normalised over its block and each (row, head)'s
    running max m and sum l; then one max all-reduce of m and one sum
    all-reduce of the rescaled sums and outputs over ``axes`` merge them.
    A rank with no visible key has m = -inf and l = 0 and weighs 0; a
    row with no visible key anywhere gives 0."""
    out, lse = decode_attend(q, k_cache, v_cache, pos + 1, window=window,
                             impl=impl, offset=offset, return_lse=True)
    merged = merge_partials(
        out[:, 0], lse,
        lambda m: SH.all_reduce_(m, mesh, axes, "max"),
        lambda t: SH.all_reduce_(t, mesh, axes, "sum"))
    return merged[:, None]


def update_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor,
                 pos: torch.Tensor, advance: Optional[torch.Tensor] = None,
                 offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write (B,1,KV,Dh) new entries at per-row positions (B,), IN PLACE.

    A row whose ``pos`` is past the cache (an empty slot that kept
    advancing), or whose ``advance`` (B,) bool is False, has its write
    dropped, as JAX's scatter drops an out-of-range write: such a row
    writes back the value already at position 0 of its own row, so no
    position changes and no index leaves the cache (clamping to
    ``Smax - 1`` would instead overwrite the last position). A cache that
    holds positions ``offset`` .. (a rank's block of a cache split on
    its positions) takes only the writes that land in it."""
    B, S = k_cache.shape[:2]
    if k_cache.shape[2] != k_new.shape[2]:
        raise ValueError(f"the cache holds {k_cache.shape[2]} KV heads, the "
                         f"projection gives {k_new.shape[2]}: build the "
                         f"rank's block of the cache (kv_heads=)")
    rows = torch.arange(B, device=k_cache.device)
    at = pos - offset
    keep = (at >= 0) & (at < S)
    if advance is not None:
        keep = keep & advance
    at = torch.where(keep, at, torch.zeros_like(at))
    sel = keep.view(B, 1, 1)
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        cache[rows, at] = torch.where(sel, new[:, 0].to(cache.dtype),
                                      cache[rows, at])
    return k_cache, v_cache


# ---------------------------------------------------------------------------
# Paged decode (vLLM-style): KV lives in a shared physical page pool
# ---------------------------------------------------------------------------

def gather_pages(pages: torch.Tensor, page_table: torch.Tensor
                 ) -> torch.Tensor:
    """pages: (P, ps, ...); page_table: (B, Lp) logical->physical map.
    Returns the contiguous logical row views (B, Lp*ps, ...): position j
    of row b lives in physical page ``page_table[b, j // ps]`` at offset
    ``j % ps``. Table entries past a row's pages gather some other page;
    callers mask by ``pos`` exactly like the dense path, so what lies
    beyond the written prefix never reaches the softmax."""
    B, Lp = page_table.shape
    ps = pages.shape[1]
    view = pages.index_select(0, page_table.reshape(-1))   # (B*Lp, ps, ...)
    return view.reshape((B, Lp * ps) + tuple(pages.shape[2:]))


def attend_decode_paged(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, page_table: torch.Tensor,
                        pos: torch.Tensor, *, window: int = 0,
                        impl: str = "cuda") -> torch.Tensor:
    """Page-table-indexed decode attention. q: (B,1,H,Dh); pools:
    (P, ps, KV, Dh); page_table: (B, Lp); pos: (B,) current index.

    The page table is the only indirection: after the gather the logical
    row view is the dense cache row (padded to Lp*ps with masked
    positions), and ``attend_decode`` runs on it, so ``impl="cuda"``
    reaches the decode kernel. The gather costs two copies of the rows'
    views per call."""
    k = gather_pages(k_pages, page_table)
    v = gather_pages(v_pages, page_table)
    return attend_decode(q, k, v, pos, window=window, impl=impl)


PageSlots = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def page_slots(page_table: torch.Tensor, pos: torch.Tensor, page_size: int,
               rows: Optional[torch.Tensor] = None) -> PageSlots:
    """Where this token's KV goes: (rows, physical page, offset) of each
    row listed in ``rows`` (an index tensor; None = every row), at its
    position ``pos`` (B,). A position past the table's last page is
    clipped into it, as the reference clips it. Every layer of a cell
    writes to the same slots, so the cell computes them once."""
    B, Lp = page_table.shape
    if rows is None:
        rows = torch.arange(B, device=pos.device)
    p = pos[rows].long()
    logical = torch.clamp(p // page_size, 0, Lp - 1)
    return rows, page_table[rows, logical].long(), p % page_size


def write_pages(k_pages: torch.Tensor, v_pages: torch.Tensor,
                k_new: torch.Tensor, v_new: torch.Tensor, slots: PageSlots
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write (B,1,KV,Dh) new entries into the page pools IN PLACE at
    ``slots`` (:func:`page_slots`); rows left out of them write
    nothing at all."""
    rows, phys, off = slots
    for pages, new in ((k_pages, k_new), (v_pages, v_new)):
        pages[phys, off] = new[rows, 0].to(pages.dtype)
    return k_pages, v_pages


def update_cache_paged(k_pages: torch.Tensor, v_pages: torch.Tensor,
                       k_new: torch.Tensor, v_new: torch.Tensor,
                       page_table: torch.Tensor, pos: torch.Tensor,
                       write_mask: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter (B,1,KV,Dh) new entries into the page pools IN PLACE at
    per-row positions (B,). Rows with ``write_mask`` False write nothing:
    in the paged layout a stale page-table row may point at pages that
    now belong to another request. The reference redirects such writes to
    an out-of-range page that its scatter drops (``mode="drop"``); torch
    has no drop mode and an out-of-range index is an error on CUDA, so
    the write is restricted to the kept rows instead (which reads the
    mask back to the host)."""
    rows = None if write_mask is None \
        else torch.nonzero(write_mask).flatten()
    return write_pages(k_pages, v_pages, k_new, v_new,
                       page_slots(page_table, pos, k_pages.shape[1], rows))

"""Paged KV cache: page allocator + pack/unpack for cache shipping
(counterpart of ``repro.serving.paging``).

The dense engine stores each cache leaf as one ``[..., max_batch,
max_len, ...]`` block, so every admitted request owns ``max_len`` cache
positions whether it uses them or not. The paged layout (vLLM-style)
breaks the ``(batch, length)`` plane into fixed-size **pages** shared
through one physical pool:

- every length-bearing cache leaf becomes ``[layers, num_pages,
  page_size, ...]``: a pool of physical pages with no batch axis;
- each request owns a **page table** (logical page -> physical page),
  stored as a ``(max_batch, pages_per_row)`` leaf of the cache tree, so
  the decode cell can gather row views;
- the :class:`PageAllocator` hands out physical pages from a free list
  with exact accounting, making per-replica cache capacity a schedulable
  resource: admission holds a request in the queue until its worst-case
  page demand fits.

Recurrent-state leaves (SSM/RWKV/Mamba) carry no length axis, so they
stay dense per row and the page budget of those families is a logical
token budget (the same admission arithmetic, no physical pool).

Pages also make migration cheap: ``pack_slot``/``unpack_slot`` ship a
drained request's exact pages and row state to the replacement replica
instead of replaying ``prompt + generated`` through prefill. Replay
stays the fallback whenever the target cannot place the pack.

Invariant relied on throughout: pool leaves put layers on axis 0 and the
physical page index on axis 1.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from repro_torch.tree import tree_map

Tree = Any

POOL_AXIS_SENTINEL = -1     # marks pool leaves in per-row axes trees
PAGE_AXIS = 1               # physical page index axis of pool leaves


def pages_needed(n_tokens: int, page_size: int) -> int:
    """Pages covering ``n_tokens`` cache positions (ceil division)."""
    if n_tokens <= 0:
        return 0
    return -(-n_tokens // page_size)


class PageAllocator:
    """Fixed-size page pool with a free list and per-request page tables.

    O(1) per-page alloc/free (list push/pop), all-or-nothing allocation
    (a request never holds a partial grant), and exact conservation:
    ``free_pages + used_pages == num_pages`` always. ``peak_used`` is the
    high-water mark.
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {num_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.num_pages = num_pages
        self.page_size = page_size
        # LIFO free list: recently-freed pages are re-used first (warm)
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._tables: Dict[int, List[int]] = {}
        self.peak_used = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.num_pages - len(self._free)

    def can_alloc(self, n_pages: int) -> bool:
        return n_pages <= len(self._free)

    def pages_of(self, rid: int) -> List[int]:
        """This request's physical pages in logical order (copy)."""
        return list(self._tables.get(rid, ()))

    def holds(self, rid: int) -> bool:
        return rid in self._tables

    def alloc(self, rid: int, n_pages: int) -> Optional[List[int]]:
        """Grant ``n_pages`` more pages to ``rid`` (appended to its page
        table). Returns the newly granted physical pages, or None if the
        free list cannot cover the demand, in which case nothing is
        allocated."""
        if n_pages < 0:
            raise ValueError(f"n_pages must be >= 0, got {n_pages}")
        if n_pages > len(self._free):
            return None
        grant = [self._free.pop() for _ in range(n_pages)]
        self._tables.setdefault(rid, []).extend(grant)
        self.peak_used = max(self.peak_used, self.used_pages)
        return grant

    def free(self, rid: int) -> int:
        """Return all of ``rid``'s pages to the free list. Returns how many
        were freed (0 if the request held none)."""
        pages = self._tables.pop(rid, None)
        if not pages:
            return 0
        self._free.extend(pages)
        return len(pages)

    def adopt(self, rid: int, pages: List[int]) -> None:
        """Install an externally built page table: the pages must have
        been granted by this allocator; this only re-keys them."""
        if rid in self._tables:
            raise ValueError(f"rid {rid} already holds pages")
        self._tables[rid] = list(pages)


# ---------------------------------------------------------------------------
# Cache-shipping packs: exact cache state of one slot, relocatable
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CachePack:
    """The migratable cache state of one in-flight request: its pool pages
    (gathered in logical order) and its per-row leaf slices, as one tree
    matching the cache structure. Every leaf is a host (CPU) tensor with
    storage of its own, as the reference's numpy pack is: the source
    engine updates its cache in place, so a pack that viewed it would
    change with the source replica's next step."""
    cache_key: tuple                 # engine geometry compatibility tag
    n_pages: int
    tree: Tree                       # pool leaves: (layers, n_pages, ps, ...)
    pos: int                         # per-row leaves: batch axis sliced out


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def pack_slot(cache: Tree, row_axes: Tree, row: int, pages: List[int],
              cache_key: tuple) -> CachePack:
    """Extract slot ``row``'s cache state: gather its physical pages from
    every pool leaf and copy its row of every per-row leaf, to the host.
    ``row_axes`` maps each leaf to its batch axis, with
    ``POOL_AXIS_SENTINEL`` marking pool leaves."""
    def take(ax, leaf):
        if ax == POOL_AXIS_SENTINEL:
            idx = torch.as_tensor(pages, dtype=torch.long,
                                  device=leaf.device)
            return _host_copy(leaf.index_select(PAGE_AXIS, idx))
        return _host_copy(leaf.select(ax, row))

    tree = tree_map(take, row_axes, cache)
    return CachePack(cache_key=cache_key, n_pages=len(pages), tree=tree,
                     pos=int(cache["pos"][row]))


def unpack_slot(cache: Tree, row_axes: Tree, row: int, pages: List[int],
                pack: CachePack) -> Tree:
    """Scatter a pack into slot ``row``, IN PLACE: pool leaves land on the
    freshly granted ``pages`` (any physical placement: the page table
    restores logical order), per-row leaves overwrite the row. Returns
    the cache; the caller still owns the page-table row."""
    if len(pages) != pack.n_pages:
        raise ValueError(f"pack has {pack.n_pages} pages, got {len(pages)}")

    def put(ax, leaf, src):
        src = src.to(device=leaf.device, dtype=leaf.dtype)
        if ax == POOL_AXIS_SENTINEL:
            idx = torch.as_tensor(pages, dtype=torch.long,
                                  device=leaf.device)
            leaf.index_copy_(PAGE_AXIS, idx, src)
        else:
            leaf.select(ax, row).copy_(src)
        return leaf

    return tree_map(put, row_axes, cache, pack.tree)

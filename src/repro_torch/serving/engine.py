"""Batched serving engine: phase-split continuous batching over slots
(counterpart of ``repro.serving.engine``), for the dense, hybrid
(zamba2) and recurrent (rwkv6) families, with the dense or the paged
cache.

A fixed-capacity slot array whose occupancy is runtime data: requests
join and retire without rebuilding anything.

- **prefill** (``prefill="block"``, default): admitted prompts are
  ingested in blocks of up to ``prefill_block`` tokens through one loop
  over the decode cell (``make_prefill_step``); rows in decode phase are
  frozen by a per-row advance mask. ``prefill="token"`` feeds one
  prompt token per engine step through the decode path.
- **decode** runs one token per step across all occupied slots.

``cache_impl="paged"`` keeps the KV in a shared pool of ``page_size``-
position pages (``serving/paging.py``): admission reserves a request's
worst-case pages, and a drain ships a request's exact pages and row
state (a ``CachePack``) to the next replica instead of replaying it.

Revocation is a first-class serving event, in two severities:

- ``begin_drain`` (a provider *warning*): stop admitting, let short
  decodes finish inside a token grace budget, and migrate long in-flight
  decodes by **prefix replay** (the request keeps its generated tokens
  and re-prefills ``prompt + generated`` on its next replica) or, on a
  paged engine, by **page shipping**.
- ``revoke_slot`` / ``hard_revoke`` (the *fire*): in-flight requests lose
  their decode state and regenerate from scratch; ``tokens_lost`` counts
  the discarded work.

Per-request TTFT/TPOT accounting rides on an injectable engine clock
(``clock=``), so trace replay drives the engine on a virtual timeline
while live drivers use the host clock. A ``recorder`` gets the
reference's events under its names; a ``monitor`` (``obs.SLOMonitor``)
is fed completions, drops, revocations and page-pool pressure.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.models.builder import (Model, build_model, cache_batch_axes,
                                        paged_cache_axes)
from repro_torch.serving.paging import (POOL_AXIS_SENTINEL, CachePack,
                                        PageAllocator, pack_slot,
                                        pages_needed, unpack_slot)
from repro_torch.train.step import (make_paged_prefill_step,
                                    make_paged_serve_step, make_prefill_step,
                                    make_serve_step)
from repro_torch.tree import tree_map

Tree = dict


def with_impls(model: Model, **impls: str) -> Model:
    """Rebuild a model with other kernel implementations selected, e.g.
    ``with_impls(model, attn_impl="torch")``. The params tree is the same
    for every impl, so the caller's params keep working."""
    return build_model(model.cfg.replace(**impls), model.device)


@dataclasses.dataclass
class RequestTiming:
    """Engine-clock lifecycle timestamps + revocation cost counters."""
    t_enqueue: Optional[float] = None
    t_admit: Optional[float] = None
    t_prefill_done: Optional[float] = None
    t_first_token: Optional[float] = None
    t_complete: Optional[float] = None
    n_migrations: int = 0         # prefix-replay migrations (drain path)
    n_restarts: int = 0           # from-scratch regenerations (hard revoke)
    tokens_lost: int = 0          # decoded tokens discarded by hard revokes
    tokens_replayed: int = 0      # prefix tokens re-prefilled by migrations

    @property
    def ttft_s(self) -> Optional[float]:
        if self.t_first_token is None or self.t_enqueue is None:
            return None
        return self.t_first_token - self.t_enqueue

    def tpot_s(self, n_generated: int) -> Optional[float]:
        if self.t_complete is None or self.t_first_token is None \
                or n_generated < 2:
            return None
        return (self.t_complete - self.t_first_token) / (n_generated - 1)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    # SLO metadata (engine-clock seconds; defaults = no SLO pressure)
    arrival_s: float = 0.0
    priority: int = 0                    # lower sorts first in SLOQueue
    deadline_s: float = math.inf         # absolute engine-clock deadline
    slo: str = "default"                 # class label for attainment stats
    # runtime
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    dropped: bool = False                # shed by admission control / expiry
    timing: RequestTiming = dataclasses.field(default_factory=RequestTiming)
    # correlated tracing: one trace_id for the request's whole lifetime,
    # carried across migrations; _span_seq/_last_span chain its spans
    trace_id: Optional[str] = None
    _span_seq: int = 0
    _last_span: Optional[str] = None
    # prefix-replay source after a migration: the exact token stream an
    # undisturbed engine would have consumed up to the migration point
    _replay: Optional[List[int]] = None
    # cache-shipping pack built at drain on a paged engine; the replay
    # cost is charged only if the pack cannot be placed and replay runs
    _pack: Optional[CachePack] = None
    _pending_replay: int = 0

    @property
    def prefill_tokens(self) -> List[int]:
        return self._replay if self._replay is not None else self.prompt

    @property
    def remaining_tokens(self) -> int:
        return self.max_new_tokens - len(self.generated)


class ServeEngine:
    def __init__(self, model: Model, params: Tree, *, max_batch: int,
                 max_len: int, recorder: Optional[obs.Recorder] = None,
                 queue=None, prefill: str = "block",
                 prefill_block: int = 16,
                 clock: Optional[Callable[[], float]] = None,
                 on_long_prompt: str = "truncate",
                 shared_fns: Optional[Tuple] = None,
                 cache_impl: str = "dense", page_size: int = 16,
                 num_pages: Optional[int] = None,
                 ship_pages: bool = True,
                 replica_id: Optional[int] = None,
                 monitor=None):
        if prefill not in ("block", "token"):
            raise ValueError(f"prefill must be 'block' or 'token', "
                             f"got {prefill!r}")
        if on_long_prompt not in ("truncate", "reject"):
            raise ValueError(f"on_long_prompt must be 'truncate' or "
                             f"'reject', got {on_long_prompt!r}")
        if cache_impl not in ("dense", "paged"):
            raise ValueError(f"cache_impl must be 'dense' or 'paged', "
                             f"got {cache_impl!r}")
        self.model = model
        self.params = params
        self.device = model.device
        self.max_batch = max_batch
        self.max_len = max_len
        self.prefill_mode = prefill
        self.prefill_block = max(1, min(prefill_block, max_len))
        self.on_long_prompt = on_long_prompt
        self.cache_impl = cache_impl
        self._paged = cache_impl == "paged"
        self.ship_pages = ship_pages and self._paged
        if self._paged:
            self.page_size = max(1, min(page_size, max_len))
            self.pages_per_row = -(-max_len // self.page_size)
            if num_pages is None:
                # capacity-equivalent default: every slot can still reach
                # max_len; memory wins come from setting num_pages lower
                num_pages = max_batch * self.pages_per_row
            self.num_pages = num_pages
            self.allocator: Optional[PageAllocator] = PageAllocator(
                num_pages, self.page_size)
            self.cache = model.init_paged_cache(
                max_batch, max_len, page_size=self.page_size,
                num_pages=num_pages)
            # batch axis per per-row leaf; pool leaves carry the -1
            # sentinel (no batch axis: shared physical pages)
            self._batch_axes = paged_cache_axes(
                model, max_len, page_size=self.page_size,
                num_pages=num_pages)
        else:
            self.page_size = 0
            self.pages_per_row = 0
            self.num_pages = 0
            self.allocator = None
            self.cache = model.init_cache(max_batch, max_len)
            # batch axis per cache leaf, from the cache layout itself: row
            # resets must never guess shapes
            self._batch_axes = cache_batch_axes(model, max_len)
        # step-sharing / cache-pack compatibility tag: replicas may only
        # share steps (and accept shipped packs) when model, layout and
        # geometry all agree
        self._cache_key = (model.cfg.name, model.cfg.attn_impl, cache_impl,
                           self.page_size, max_len)
        if shared_fns is not None:
            # replicas of one model share the step callables (and the one
            # parameter tree the caller passes every replica)
            key, self.step_fn, self.prefill_fn = shared_fns
            if key != self._cache_key:
                raise ValueError(f"shared_fns were built for {key}, "
                                 f"engine needs {self._cache_key}")
        elif self._paged:
            self.step_fn = make_paged_serve_step(model)
            self.prefill_fn = make_paged_prefill_step(model)
        else:
            self.step_fn = make_serve_step(model)
            self.prefill_fn = make_prefill_step(model)
        self.slots: List[Optional[Request]] = [None] * max_batch
        if queue is None:
            from repro_torch.serving.queue import FIFOQueue
            queue = FIFOQueue()
        self.queue = queue
        self._prefill_cursor: Dict[int, int] = {}   # slot -> prefill index
        self.tokens_decoded = 0
        self.tokens_lost = 0          # decode work discarded by hard revokes
        self.tokens_replayed = 0      # prefill work added by migrations
        self.requests_rejected = 0    # shed at submit (admission/validation)
        self.pages_shipped = 0        # pages imported via cache shipping
        self.requests_imported = 0    # migrations landed without replay
        self.decode_cells = 0         # decode-cell runs (prefill + decode)
        self.draining = False
        self.rec = recorder if recorder is not None else obs.NULL
        # fleet identity + health feed: replica_id prefixes this engine's
        # event tracks (None = solo engine) and is assigned by
        # ServeCluster._adopt; the monitor observes and never influences
        # engine bookkeeping
        self.replica_id = replica_id
        self.monitor = monitor
        self._epoch = time.monotonic()
        self.clock = clock if clock is not None \
            else (lambda: time.monotonic() - self._epoch)
        # request-lifecycle wall timestamps, keyed by rid; popped on
        # retire/drop so bookkeeping stays bounded by in-flight work
        self._t_enqueue: Dict[int, float] = {}
        self._t_admit: Dict[int, float] = {}
        self._t_prefill_done: Dict[int, float] = {}

    @property
    def shared_fns(self) -> Tuple:
        """``(cache_key, decode, prefill)``; pass to sibling replicas. The
        key guards against sharing steps across incompatible geometries
        (dense vs paged, different page size)."""
        return (self._cache_key, self.step_fn, self.prefill_fn)

    # -- correlated tracing --------------------------------------------------
    def _track(self, base: str) -> str:
        """Event track name, replica-qualified in a fleet (``r1/slot3``);
        solo engines keep the bare names."""
        if self.replica_id is None:
            return base
        return f"r{self.replica_id}/{base}"

    def _span(self, req: Request) -> Dict[str, Optional[str]]:
        """Mint the next span in ``req``'s trace (trace_id assigned on
        first emission, then carried with the request) and return the
        kwargs the recorder attaches. Only called under ``rec.enabled``."""
        if req.trace_id is None:
            req.trace_id = f"t{req.rid}"
        span_id = f"{req.trace_id}.{req._span_seq}"
        parent = req._last_span
        req._span_seq += 1
        req._last_span = span_id
        return {"trace_id": req.trace_id, "span_id": span_id,
                "parent_id": parent}

    # -- page accounting -----------------------------------------------------
    def _pages_for(self, req: Request) -> int:
        """Worst-case page demand, reserved in full at admission: the
        request may touch ``prefill + remaining-decode`` cache positions,
        capped by ``max_len``, so an admitted request never stalls
        mid-decode on allocation."""
        tokens = min(len(req.prefill_tokens) + req.remaining_tokens,
                     self.max_len)
        return pages_needed(tokens, self.page_size)

    def _set_page_table_row(self, row: int, pages: List[int]) -> None:
        padded = np.zeros((self.pages_per_row,), np.int32)
        padded[:len(pages)] = pages
        self.cache["page_table"][row].copy_(torch.from_numpy(padded))

    def _free_pages(self, req: Request) -> None:
        if self._paged:
            self.allocator.free(req.rid)

    @property
    def page_utilization(self) -> float:
        """Fraction of the physical page pool allocated (0.0 for dense
        engines: they have no schedulable cache resource)."""
        if not self._paged:
            return 0.0
        return self.allocator.used_pages / self.num_pages

    def admission_headroom(self, req: Request) -> bool:
        """Whether this engine could admit ``req`` now without waiting for
        pages. Dense engines always say yes."""
        if not self._paged:
            return True
        return self.allocator.can_alloc(self._pages_for(req))

    # -- request management --------------------------------------------------
    def submit(self, req: Request) -> bool:
        """Enqueue a request. Returns False if admission control shed it
        (queue at capacity, expired deadline, engine draining, a paged
        demand the pool can never hold, or an over-long prompt under
        ``on_long_prompt="reject"``). Otherwise a prompt longer than the
        cache allows is cut to its most recent ``max_len - 1`` tokens."""
        now = self.clock()
        limit = self.max_len - 1          # >=1 cache slot left for decode
        if len(req.prompt) > limit:
            if self.on_long_prompt == "reject":
                return self._drop(req, "long_prompt")
            req.prompt = list(req.prompt[-limit:])
        if self.draining:
            return self._drop(req, "draining")
        if self._paged and self._pages_for(req) > self.num_pages:
            # can never fit this pool; queueing it would deadlock _admit
            return self._drop(req, "pages")
        if req._pack is not None:
            # migration by cache shipping: land the pack directly in a
            # slot (the request already waited its turn once)
            if self._try_import(req):
                return True
            # the pack cannot be placed: charge the replay that now runs
            req._pack = None
            cost = req._pending_replay
            req._pending_replay = 0
            req.timing.tokens_replayed += cost
            self.tokens_replayed += cost
        if not self.queue.push(req, now=now):
            return self._drop(req, "admission")
        if req.timing.t_enqueue is None:
            req.timing.t_enqueue = now
        rec = self.rec
        if rec.enabled:
            self._t_enqueue.setdefault(req.rid, rec.now())
            rec.instant(obs.EV_ENQUEUE, cat=obs.CAT_SERVE,
                        track=self._track(f"req{req.rid}"), sim_t=now,
                        prompt_len=len(req.prompt),
                        max_new_tokens=req.max_new_tokens, slo=req.slo,
                        **self._span(req))
            rec.metrics.counter("requests_total").inc()
        return True

    def _drop(self, req: Request, reason: str) -> bool:
        req.dropped = True
        self.requests_rejected += 1
        if self.monitor is not None:
            self.monitor.observe_drop(req, now=self.clock(), reason=reason)
        rec = self.rec
        if rec.enabled:
            rec.instant(obs.EV_REJECT, cat=obs.CAT_SERVE,
                        track=self._track(f"req{req.rid}"),
                        sim_t=self.clock(), reason=reason,
                        **self._span(req))
            rec.metrics.counter("requests_rejected", reason=reason).inc()
        return False

    def _reset_row(self, row: int) -> None:
        """Zero every per-row cache leaf at this batch row (a new occupant
        must not see the previous request's KV remnants or recurrent
        state). Pool leaves are shared, not row-owned, and need no
        zeroing: every position is written before it is read. The batch
        axis comes from the cache layout metadata, never from shape
        matching."""
        def zero_row(ax, leaf):
            if ax != POOL_AXIS_SENTINEL:
                leaf.select(ax, row).zero_()
        tree_map(zero_row, self._batch_axes, self.cache)

    def _admit(self) -> None:
        if self.draining:
            return                        # doomed replica: no new work
        rec = self.rec
        now = self.clock()
        for i, slot in enumerate(self.slots):
            if slot is not None or not len(self.queue):
                continue
            req = self.queue.pop(now=now)
            if req is None:               # backlog was all expired work
                break
            pages: Optional[List[int]] = None
            if self._paged:
                pages = self.allocator.alloc(req.rid, self._pages_for(req))
                if pages is None:
                    # page-budget admission: hold the head of the queue
                    # (no reorder: a smaller request must not starve it)
                    # until retirements free pages
                    self.queue.requeue_front(req)
                    break
            self.slots[i] = req
            self._prefill_cursor[i] = 0
            self._reset_row(i)
            if pages is not None:
                self._set_page_table_row(i, pages)
            req.timing.t_admit = now
            if rec.enabled:
                self._t_admit[req.rid] = rec.now()
                rec.instant(obs.EV_SLOT_JOIN, cat=obs.CAT_SERVE,
                            track=self._track(f"slot{i}"), sim_t=now,
                            rid=req.rid, **self._span(req))
        if self.monitor is not None and self._paged:
            self.monitor.observe_pool(self.page_utilization, now=now)

    # -- cache shipping (paged migration without replay) ---------------------
    def can_import(self, req: Request) -> bool:
        """Whether ``req``'s cache pack could land here now: same model +
        cache geometry, a free slot, and enough free pages."""
        pack = req._pack
        return (pack is not None and self._paged and not self.draining
                and pack.cache_key == self._cache_key
                and any(s is None for s in self.slots)
                and self.allocator.can_alloc(
                    max(self._pages_for(req), pack.n_pages)))

    def _try_import(self, req: Request) -> bool:
        """Land a shipped pack in a free slot: allocate pages, scatter the
        pack's pool pages and row state, install the page table. The
        request resumes decoding where it left off, with no replay."""
        if not self.can_import(req):
            return False
        pack = req._pack
        row = next(i for i, s in enumerate(self.slots) if s is None)
        need = max(self._pages_for(req), pack.n_pages)
        pages = self.allocator.alloc(req.rid, need)
        if pages is None:                 # raced can_import; shouldn't happen
            return False
        unpack_slot(self.cache, self._batch_axes, row,
                    pages[:pack.n_pages], pack)
        # the pack carried the SOURCE page-table row; overwrite with ours
        self._set_page_table_row(row, pages)
        self.slots[row] = req
        self._prefill_cursor[row] = len(req.prefill_tokens)
        req._pack = None
        req._pending_replay = 0
        now = self.clock()
        req.timing.t_admit = now
        req.timing.t_prefill_done = now   # state arrived pre-filled
        self.pages_shipped += pack.n_pages
        self.requests_imported += 1
        rec = self.rec
        if rec.enabled:
            self._t_admit[req.rid] = rec.now()
            self._t_prefill_done[req.rid] = rec.now()
            rec.instant(obs.EV_SLOT_JOIN, cat=obs.CAT_SERVE,
                        track=self._track(f"slot{row}"), sim_t=now,
                        rid=req.rid, mode="ship", pages=pack.n_pages,
                        **self._span(req))
            rec.metrics.counter("pages_shipped").inc(pack.n_pages)
        return True

    # -- revocation: drain (warned) and hard revoke (fired) ------------------
    def begin_drain(self, *, grace_tokens: int = 4,
                    _observe: bool = True) -> List[Request]:
        """Revocation *warning* for this replica: admission stops, decodes
        within ``grace_tokens`` of completion finish here, and longer
        in-flight requests are migrated out (``_migrate_out``). Queued
        work is returned too; the caller routes it all elsewhere.

        ``_observe=False`` (autoscaler scale-down) keeps the drain out of
        the SLO monitor's revocation window: a voluntary shrink is not a
        provider revocation."""
        self.draining = True
        if _observe and self.monitor is not None:
            self.monitor.observe_revocation(now=self.clock(),
                                            replica=self.replica_id)
        rec = self.rec
        migrated: List[Request] = []
        if rec.enabled:
            rec.instant(obs.EV_REVOKE_WARN, cat=obs.CAT_SERVE,
                        track=self._track("engine"), sim_t=self.clock(),
                        grace_tokens=grace_tokens)
        for i, req in enumerate(self.slots):
            if req is None or req.done:
                continue
            in_prefill = self._prefill_cursor.get(i, 0) \
                < len(req.prefill_tokens)
            if not in_prefill and req.remaining_tokens <= grace_tokens:
                continue                  # short decode: finish under grace
            self._migrate_out(i, req)
            migrated.append(req)
        migrated.extend(self.queue.drain_all())
        return migrated

    def _migrate_out(self, slot: int, req: Request) -> None:
        """Evict with prefix replay: the replay stream is exactly the
        token sequence an undisturbed engine consumed (prompt, the re-fed
        final prompt token, then all but the last generated token, which
        becomes the resume decode input). On a paged engine with
        ``ship_pages`` the request also carries a :class:`CachePack` of
        its exact pages and row state, so a compatible target lands it
        without replay; its replay cost is charged only if the fallback
        runs (dense engines charge at once)."""
        shipped = False
        if req.generated:
            req._replay = (list(req.prompt) + [req.prompt[-1]]
                           + list(req.generated[:-1]))
            replay_cost = len(req._replay)
            if self.ship_pages:
                req._pack = pack_slot(self.cache, self._batch_axes, slot,
                                      self.allocator.pages_of(req.rid),
                                      self._cache_key)
                req._pending_replay = replay_cost
                shipped = True
        else:
            req._replay = None            # still in prefill: plain restart
            replay_cost = 0
        req.timing.n_migrations += 1
        if not shipped:
            req.timing.tokens_replayed += replay_cost
            self.tokens_replayed += replay_cost
        self._free_pages(req)
        self.slots[slot] = None
        self._prefill_cursor.pop(slot, None)
        # lifecycle restarts at admission on the target replica
        self._t_admit.pop(req.rid, None)
        self._t_prefill_done.pop(req.rid, None)
        rec = self.rec
        if rec.enabled:
            rec.instant(obs.EV_MIGRATE, cat=obs.CAT_SERVE,
                        track=self._track(f"req{req.rid}"),
                        sim_t=self.clock(), slot=slot,
                        mode="ship" if shipped else "replay",
                        kept_tokens=len(req.generated),
                        replay_tokens=replay_cost, **self._span(req))
            rec.metrics.counter("requests_migrated").inc()

    @property
    def drain_complete(self) -> bool:
        return self.draining and not self.has_work()

    def hard_revoke(self) -> List[Request]:
        """The revocation *fired* (no or expired warning): every in-flight
        request loses its decode state and must regenerate from scratch;
        queued work is evacuated untouched. Returns everything displaced."""
        displaced: List[Request] = []
        # one server fired = one revocation for the health monitor
        if self.monitor is not None:
            self.monitor.observe_revocation(now=self.clock(),
                                            replica=self.replica_id)
        for i in range(self.max_batch):
            req = self.revoke_slot(i, _requeue=False, _observe=False)
            if req is not None and not req.done:
                displaced.append(req)
        displaced.extend(self.queue.drain_all())
        self.draining = True
        return displaced

    def revoke_slot(self, slot: int, _requeue: bool = True,
                    _observe: bool = True) -> Optional[Request]:
        """Membership shrink mid-serve: the slot's in-flight request loses
        its decode state and is re-enqueued at the FRONT of the queue to
        regenerate from scratch; the emptied row is reset by its next
        occupant. Returns the displaced request (None if the slot was
        empty). ``tokens_decoded`` keeps counting the lost tokens: they
        were real decode work (``tokens_lost`` tallies it explicitly)."""
        req = self.slots[slot]
        self.slots[slot] = None
        self._prefill_cursor.pop(slot, None)
        if req is not None:
            self._free_pages(req)
        if self.monitor is not None and _observe:
            self.monitor.observe_revocation(now=self.clock(),
                                            replica=self.replica_id)
        rec = self.rec
        if rec.enabled:
            rec.instant(obs.EV_REVOKE_FIRE, cat=obs.CAT_SERVE,
                        track=self._track(f"slot{slot}"),
                        sim_t=self.clock(),
                        rid=None if req is None else req.rid)
            rec.metrics.counter("revocations_total", layer="serve").inc()
        if req is not None and not req.done:
            if rec.enabled:
                rec.instant(obs.EV_MIGRATE, cat=obs.CAT_SERVE,
                            track=self._track(f"req{req.rid}"), slot=slot,
                            sim_t=self.clock(), mode="restart",
                            lost_tokens=len(req.generated),
                            **self._span(req))
                rec.metrics.counter("requests_migrated").inc()
            # the bookkeeping reset must not depend on the recorder
            self._t_admit.pop(req.rid, None)
            self._t_prefill_done.pop(req.rid, None)
            lost = len(req.generated)
            req.timing.tokens_lost += lost
            req.timing.n_restarts += 1
            self.tokens_lost += lost
            req.generated = []
            req._replay = None
            req._pack = None              # any shipped state is now stale
            req._pending_replay = 0
            if _requeue:
                self.queue.requeue_front(req)
        return req

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self.slots)

    def has_work(self) -> bool:
        return self.n_active > 0 or bool(len(self.queue))

    # -- one engine step -----------------------------------------------------
    def step(self) -> None:
        """Admit, then run ONE phase: a prefill block if any slot still
        holds un-ingested prompt (blocked mode), else a decode step. The
        token-mode fallback runs the combined step (prefill rows advance
        one prompt token while decode rows generate)."""
        self._admit()
        if self.n_active == 0:
            return
        prefill_rows = [i for i, req in enumerate(self.slots)
                        if req is not None and self._prefill_cursor[i]
                        < len(req.prefill_tokens)]
        if self.prefill_mode == "block" and prefill_rows:
            self._step_prefill_block(prefill_rows)
        else:
            self._step_token()

    def _pos(self, row: int) -> int:
        return int(self.cache["pos"][row])

    def _prefill_room(self, row: int) -> int:
        """Cache positions this row may still write (overflow guard): a
        prefill must stop before ``max_len`` even if a replay stream or a
        mid-stream resubmit would run past it."""
        return max(self.max_len - self._pos(row), 0)

    def _finish_prefill(self, row: int, req: Request) -> None:
        now = self.clock()
        req.timing.t_prefill_done = now
        rec = self.rec
        if rec.enabled:
            wnow = rec.now()
            t0 = self._t_admit.get(req.rid, wnow)
            t_adm = req.timing.t_admit if req.timing.t_admit is not None \
                else now
            rec.span_at(obs.EV_PREFILL, cat=obs.CAT_SERVE,
                        track=self._track(f"req{req.rid}"), t_wall=t0,
                        dur_wall=wnow - t0, sim_t=t_adm,
                        dur_sim=max(0.0, now - t_adm), slot=row,
                        tokens=len(req.prefill_tokens), **self._span(req))
            self._t_prefill_done[req.rid] = wnow
            rec.metrics.counter("tokens_prefilled").inc(
                len(req.prefill_tokens))

    def _step_prefill_block(self, rows: List[int]) -> None:
        T = self.prefill_block
        tokens = np.zeros((self.max_batch, T), np.int64)
        n_valid = np.zeros((self.max_batch,), np.int64)
        for i in rows:
            req = self.slots[i]
            src = req.prefill_tokens
            cur = self._prefill_cursor[i]
            k = min(T, len(src) - cur, self._prefill_room(i))
            if k <= 0:
                # overflow guard tripped mid-prefill: cut the prompt here
                # and fall through to decode (the retire guard ends it)
                self._prefill_cursor[i] = len(src)
                self._finish_prefill(i, req)
                continue
            tokens[i, :k] = src[cur:cur + k]
            n_valid[i] = k
        if not n_valid.any():
            return
        self.cache = self.prefill_fn(
            self.params, self.cache,
            torch.as_tensor(tokens, device=self.device), n_valid)
        self.decode_cells += int(n_valid.max())
        for i in rows:
            req = self.slots[i]
            k = int(n_valid[i])
            if k <= 0:
                continue
            self._prefill_cursor[i] += k
            if self._prefill_cursor[i] >= len(req.prefill_tokens):
                self._finish_prefill(i, req)

    def _dispatch_decode(self, tokens: np.ndarray) -> np.ndarray:
        """Run the decode cell. The paged cell takes the active row mask:
        empty slots' page-table rows may point at pages now owned by live
        requests, so their writes must be dropped inside the cell (dense
        empty-row writes are merely wasted work)."""
        toks = torch.as_tensor(tokens, device=self.device)
        if self._paged:
            active = np.asarray([s is not None for s in self.slots])
            nxt, self.cache = self.step_fn(self.params, self.cache, toks,
                                           active)
        else:
            nxt, self.cache = self.step_fn(self.params, self.cache, toks)
        self.decode_cells += 1
        return nxt.cpu().numpy()

    def _step_token(self) -> None:
        """Combined step: prefill rows feed one prompt token, decode rows
        feed their last output; one dispatch for both."""
        tokens = np.zeros((self.max_batch, 1), np.int64)
        in_prefill = np.zeros((self.max_batch,), bool)
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            cur = self._prefill_cursor[i]
            src = req.prefill_tokens
            if cur < len(src):
                if self._prefill_room(i) <= 0:
                    # overflow guard: stop feeding prompt, enter decode
                    self._prefill_cursor[i] = len(src)
                    self._finish_prefill(i, req)
                else:
                    tokens[i, 0] = src[cur]
                    in_prefill[i] = True
                    continue
            tokens[i, 0] = (req.generated[-1] if req.generated
                            else req.prompt[-1])
        nxt = self._dispatch_decode(tokens)
        n_dec = 0
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            if in_prefill[i]:
                self._prefill_cursor[i] += 1
                if self._prefill_cursor[i] >= len(req.prefill_tokens):
                    self._finish_prefill(i, req)
                continue
            self._accept_token(i, req, int(nxt[i, 0]))
            n_dec += 1
        if self.rec.enabled and n_dec:
            self.rec.metrics.counter("tokens_decoded").inc(n_dec)

    def _accept_token(self, i: int, req: Request, tok: int) -> None:
        req.generated.append(tok)
        self.tokens_decoded += 1
        if req.timing.t_first_token is None:
            req.timing.t_first_token = self.clock()
        if ((req.eos_id is not None and tok == req.eos_id)
                or len(req.generated) >= req.max_new_tokens
                or self._pos(i) >= self.max_len - 1):
            self._retire(i, req)

    def _retire(self, i: int, req: Request) -> None:
        req.done = True
        t_done = self.clock()
        req.timing.t_complete = t_done
        self.slots[i] = None
        self._prefill_cursor.pop(i, None)
        self._free_pages(req)
        if self.monitor is not None:
            self.monitor.observe_completion(req, now=t_done)
        rec = self.rec
        if rec.enabled:
            now = rec.now()
            t0 = self._t_prefill_done.get(req.rid, now)
            t_pf = req.timing.t_prefill_done \
                if req.timing.t_prefill_done is not None else t_done
            rec.span_at(obs.EV_DECODE, cat=obs.CAT_SERVE,
                        track=self._track(f"req{req.rid}"), t_wall=t0,
                        dur_wall=now - t0, sim_t=t_pf,
                        dur_sim=max(0.0, t_done - t_pf), slot=i,
                        tokens=len(req.generated), **self._span(req))
            rec.instant(obs.EV_COMPLETE, cat=obs.CAT_SERVE,
                        track=self._track(f"req{req.rid}"), sim_t=t_done,
                        tokens=len(req.generated), **self._span(req))
            rec.metrics.counter("requests_completed").inc()
            t_q = self._t_enqueue.get(req.rid, now)
            rec.metrics.histogram("request_latency_ms").observe(
                (now - t_q) * 1e3)
            ttft = req.timing.ttft_s
            if ttft is not None:
                rec.metrics.histogram("ttft_ms").observe(ttft * 1e3)
            tpot = req.timing.tpot_s(len(req.generated))
            if tpot is not None:
                rec.metrics.histogram("tpot_ms").observe(tpot * 1e3)
        # completion ends the lifecycle: drop the bookkeeping entries
        self._t_enqueue.pop(req.rid, None)
        self._t_admit.pop(req.rid, None)
        self._t_prefill_done.pop(req.rid, None)

    def run_to_completion(self, max_steps: int = 10_000) -> int:
        """Step until idle; raise if ``max_steps`` runs out with work still
        pending."""
        steps = 0
        while self.has_work() and steps < max_steps:
            self.step()
            steps += 1
        if self.has_work():
            raise RuntimeError(
                f"run_to_completion exhausted max_steps={max_steps} with "
                f"{self.n_active} active slot(s) and {len(self.queue)} "
                f"queued request(s) remaining")
        return steps

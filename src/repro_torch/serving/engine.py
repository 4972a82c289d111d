"""Batched serving engine: phase-split continuous batching over slots
(counterpart of ``repro.serving.engine`` with the dense cache), for the
dense, hybrid (zamba2) and recurrent (rwkv6) families.

A fixed-capacity slot array whose occupancy is runtime data: requests
join and retire without rebuilding anything.

- **prefill** (``prefill="block"``, default): admitted prompts are
  ingested in blocks of up to ``prefill_block`` tokens through one loop
  over the decode cell (``make_prefill_step``); rows in decode phase are
  frozen by a per-row advance mask. ``prefill="token"`` feeds one
  prompt token per engine step through the decode path.
- **decode** runs one token per step across all occupied slots.

Revocation is a first-class serving event, in two severities:

- ``begin_drain`` (a provider *warning*): stop admitting, let short
  decodes finish inside a token grace budget, and migrate long in-flight
  decodes by **prefix replay**: the request keeps its generated tokens and
  re-prefills ``prompt + generated`` on its next replica.
- ``revoke_slot`` / ``hard_revoke`` (the *fire*): in-flight requests lose
  their decode state and regenerate from scratch; ``tokens_lost`` counts
  the discarded work.

Left out of the port so far (ROADMAP.md Queue 1): the paged cache and page
shipping (item 3); the event recorder, SLO monitor, multi-replica cluster
and the injectable clock of trace replay (item 4). Prompts that do not fit
are always truncated (the reference can also reject them).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.builder import Model, build_model, cache_batch_axes
from repro_torch.train.step import make_prefill_step, make_serve_step
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
    # prefix-replay source after a migration: the exact token stream an
    # undisturbed engine would have consumed up to the migration point
    _replay: Optional[List[int]] = None

    @property
    def prefill_tokens(self) -> List[int]:
        return self._replay if self._replay is not None else self.prompt

    @property
    def remaining_tokens(self) -> int:
        return self.max_new_tokens - len(self.generated)


class ServeEngine:
    def __init__(self, model: Model, params: Tree, *, max_batch: int,
                 max_len: int, queue=None, prefill: str = "block",
                 prefill_block: int = 16):
        if prefill not in ("block", "token"):
            raise ValueError(f"prefill must be 'block' or 'token', "
                             f"got {prefill!r}")
        self.model = model
        self.params = params
        self.device = model.device
        self.max_batch = max_batch
        self.max_len = max_len
        self.prefill_mode = prefill
        self.prefill_block = max(1, min(prefill_block, max_len))
        self.cache = model.init_cache(max_batch, max_len)
        # batch axis per cache leaf, from the cache layout itself — row
        # resets must never guess shapes
        self._batch_axes = cache_batch_axes(model, max_len)
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
        self.decode_cells = 0         # decode-cell runs (prefill + decode)
        self.draining = False
        self._epoch = time.monotonic()

    def clock(self) -> float:
        """Engine clock (seconds since construction) for request timing."""
        return time.monotonic() - self._epoch

    # -- request management --------------------------------------------------
    def submit(self, req: Request) -> bool:
        """Enqueue a request. Returns False if admission control shed it
        (queue at capacity, expired deadline, or engine draining). A
        prompt longer than the cache allows is cut to its most recent
        ``max_len - 1`` tokens, like any rolling-window server."""
        now = self.clock()
        limit = self.max_len - 1          # >=1 cache slot left for decode
        if len(req.prompt) > limit:
            req.prompt = list(req.prompt[-limit:])
        if self.draining:
            return self._drop(req)
        if not self.queue.push(req, now=now):
            return self._drop(req)
        if req.timing.t_enqueue is None:
            req.timing.t_enqueue = now
        return True

    def _drop(self, req: Request) -> bool:
        req.dropped = True
        self.requests_rejected += 1
        return False

    def _reset_row(self, row: int) -> None:
        """Zero every cache leaf at this batch row (a new occupant must not
        see the previous request's KV remnants, and recurrent state, which
        no ``pos`` masks, must start from zero). The batch axis comes from
        the cache layout metadata, never from shape matching."""
        tree_map(lambda ax, leaf: leaf.select(ax, row).zero_(),
                 self._batch_axes, self.cache)

    def _admit(self) -> None:
        if self.draining:
            return                        # doomed replica: no new work
        now = self.clock()
        for i, slot in enumerate(self.slots):
            if slot is not None or not len(self.queue):
                continue
            req = self.queue.pop(now=now)
            if req is None:               # backlog was all expired work
                break
            self.slots[i] = req
            self._prefill_cursor[i] = 0
            self._reset_row(i)
            req.timing.t_admit = now

    # -- revocation: drain (warned) and hard revoke (fired) ------------------
    def begin_drain(self, *, grace_tokens: int = 4) -> List[Request]:
        """Revocation *warning* for this replica: admission stops, decodes
        within ``grace_tokens`` of completion finish here, and longer
        in-flight requests are migrated out via prefix replay — each
        returned request keeps its ``generated`` tokens and carries a
        ``_replay`` stream that reproduces the undisturbed cache state on
        whatever replica resubmits it. Queued (not yet admitted) work is
        returned too. The caller routes the returned requests elsewhere."""
        self.draining = True
        migrated: List[Request] = []
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
        token sequence an undisturbed engine consumed — prompt, the
        re-fed final prompt token, then all but the last generated token
        (the last one becomes the resume decode input)."""
        if req.generated:
            req._replay = (list(req.prompt) + [req.prompt[-1]]
                           + list(req.generated[:-1]))
            replay_cost = len(req._replay)
        else:
            req._replay = None            # still in prefill: plain restart
            replay_cost = 0
        req.timing.n_migrations += 1
        req.timing.tokens_replayed += replay_cost
        self.tokens_replayed += replay_cost
        self.slots[slot] = None
        self._prefill_cursor.pop(slot, None)

    @property
    def drain_complete(self) -> bool:
        return self.draining and not self.has_work()

    def hard_revoke(self) -> List[Request]:
        """The revocation *fired* (no or expired warning): every in-flight
        request loses its decode state and must regenerate from scratch;
        queued work is evacuated untouched. Returns everything displaced."""
        displaced: List[Request] = []
        for i in range(self.max_batch):
            req = self.revoke_slot(i, _requeue=False)
            if req is not None and not req.done:
                displaced.append(req)
        displaced.extend(self.queue.drain_all())
        self.draining = True
        return displaced

    def revoke_slot(self, slot: int, _requeue: bool = True
                    ) -> Optional[Request]:
        """Membership shrink mid-serve: the slot's in-flight request loses
        its decode state and is re-enqueued at the FRONT of the queue to
        regenerate from scratch; the emptied row is reset by its next
        occupant. Returns the displaced request (None if the slot was
        empty). ``tokens_decoded`` keeps counting the lost tokens: they
        were real decode work (``tokens_lost`` tallies it explicitly)."""
        req = self.slots[slot]
        self.slots[slot] = None
        self._prefill_cursor.pop(slot, None)
        if req is not None and not req.done:
            lost = len(req.generated)
            req.timing.tokens_lost += lost
            req.timing.n_restarts += 1
            self.tokens_lost += lost
            req.generated = []
            req._replay = None
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
        req.timing.t_prefill_done = self.clock()

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
        """Run the decode cell for every row; empty slots' writes are
        merely wasted work in the dense layout."""
        nxt, self.cache = self.step_fn(
            self.params, self.cache, torch.as_tensor(tokens,
                                                     device=self.device))
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
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            if in_prefill[i]:
                self._prefill_cursor[i] += 1
                if self._prefill_cursor[i] >= len(req.prefill_tokens):
                    self._finish_prefill(i, req)
                continue
            self._accept_token(i, req, int(nxt[i, 0]))

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
        req.timing.t_complete = self.clock()
        self.slots[i] = None
        self._prefill_cursor.pop(i, None)

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

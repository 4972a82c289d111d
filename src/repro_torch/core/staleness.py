"""AsyncPSSimulator — functionally exact async parameter-server training
(C4), counterpart of ``repro.core.staleness``.

The paper's training mode is TensorFlow's between-graph asynchronous
replication: each worker pulls the current model from the PS, computes a
gradient on its own shard, and pushes it; the PS applies pushes in arrival
order with NO barrier. Gradients are therefore computed at *stale*
parameters, and the staleness distribution is what degrades converged
accuracy as clusters grow (Tables I/III: 93.07% @1 -> 88.65% @8 K80).

This module runs K logical async workers inside one process with exact
event ordering:

  - a virtual clock per worker; completion times from per-kind step rates
    (pricing.SERVER_TYPES) with optional jitter,
  - the PS applies each push immediately (SGD-momentum, the paper's
    optimizer) at the LR given by the schedule x scaling rule,
  - staleness of a push = #PS-updates since that worker's pull,
  - revocation/join events edit the worker set mid-run (sparse mapping),
  - adaptive vs naive LR: scale by ACTIVE vs CONFIGURED workers (C6).

The event order is the reference's, host-side numpy: the same
``default_rng(seed)``, one ``standard_normal`` jitter draw per schedule,
the same heap ties. The push runs eagerly in torch on the params' own
device: the gradient at the worker's snapshot (autograd), cast to
float32, optionally clipped by global norm, and the optimizer's update
of the current PS params.

**Snapshots are clones.** The port's optimizers update the PS params in
place (``optim/optimizers.py``), where the reference's are immutable JAX
arrays that its snapshot (``w.snapshot = self.params``) may alias. An
aliased snapshot here would follow every later push, each gradient would
be taken at the current params, and staleness would change nothing while
the recorded staleness still looked right. So every pull (the start of a
run, a join, the pull after a push) takes a clone of the PS params
(``_snapshot``), and the simulator holds its own clone of the params it
is given, so the caller's tensors are never modified.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import OptimizerConfig, ScheduleConfig
from repro_torch.core import pricing
from repro_torch.optim import make_optimizer, make_schedule
from repro_torch.optim.optimizers import clip_by_global_norm
from repro_torch.tree import tree_leaves, tree_map

Tree = Dict[str, Any]


def _snapshot(params: Tree) -> Tree:
    """A worker's pull: a copy of the PS params that later in-place
    updates of the PS do not reach."""
    return tree_map(lambda p: p.detach().clone(), params)


@dataclasses.dataclass
class AsyncWorker:
    wid: int
    kind: str = "K80"
    rate: float = 0.0            # steps/s; 0 -> use the kind's table rate
    join_t: float = 0.0          # wall-clock arrival (sparse mapping)
    revoke_t: float = np.inf     # wall-clock revocation
    # runtime:
    snapshot: Tree = None        # stale params the worker computes on
    pull_version: int = 0        # PS update count at last pull

    def step_rate(self) -> float:
        return self.rate or pricing.SERVER_TYPES[self.kind].steps_per_sec


@dataclasses.dataclass
class AsyncResult:
    params: Tree
    updates_applied: int
    staleness: np.ndarray              # per-push staleness
    active_worker_curve: List[Tuple[float, int]]   # (t, n_active) steps
    loss_curve: List[Tuple[int, float]]
    lr_history: List[float] = dataclasses.field(default_factory=list)
    staleness_by_worker: Dict[int, List[int]] = dataclasses.field(
        default_factory=dict)          # wid -> its pushes' staleness

    @property
    def mean_staleness(self) -> float:
        return float(self.staleness.mean()) if len(self.staleness) else 0.0

    def staleness_histogram(self) -> Dict[int, int]:
        """``{staleness -> push count}`` over every applied push — the
        distribution the paper's accuracy-vs-workers mechanism rides on
        (gym ledgers report it per episode)."""
        if not len(self.staleness):
            return {}
        vals, counts = np.unique(self.staleness, return_counts=True)
        return {int(v): int(c) for v, c in zip(vals, counts)}


class AsyncPSSimulator:
    """Event-ordered async-PS training of a real torch model.

    ``loss_fn(params, batch)`` returns a scalar tensor; ``params`` is a
    nested dict of tensors, copied on entry (the PS's own masters).
    """

    def __init__(self, loss_fn: Callable[[Tree, Dict], torch.Tensor],
                 params: Tree,
                 ocfg: OptimizerConfig,
                 scfg: ScheduleConfig,
                 *, grad_clip: Optional[float] = None):
        self.opt = make_optimizer(ocfg)
        self.sched = make_schedule(scfg)
        self.ocfg = ocfg
        self.loss_fn = loss_fn
        self.params = _snapshot(params)
        self.opt_state = self.opt.init(self.params)
        self.version = 0
        self.clip = ocfg.grad_clip if grad_clip is None else grad_clip

    def _push(self, worker_params: Tree, batch: Dict, lr: float) -> None:
        """Async-PS semantic: grad at the STALE params, applied to the
        CURRENT ones (in place)."""
        leaves = tree_map(lambda p: p.detach().requires_grad_(),
                          worker_params)
        with torch.enable_grad():
            loss = self.loss_fn(leaves, batch)
            grads = torch.autograd.grad(
                loss, [t for _, t in tree_leaves(leaves)])
        it = iter(grads)
        grads = tree_map(lambda _: next(it).float().contiguous(), leaves)
        if self.clip and self.clip > 0:
            grads, _ = clip_by_global_norm(grads, self.clip)
        self.opt_state = self.opt.update(grads, self.opt_state, self.params,
                                         lr)

    def run(self, workers: List[AsyncWorker],
            batch_fn: Callable[[int, int], Dict],
            total_updates: int,
            *, seed: int = 0, jitter: float = 0.05,
            adaptive_lr: bool = True,
            configured_workers: Optional[int] = None,
            eval_every: int = 0,
            eval_fn: Optional[Callable[[Tree], float]] = None
            ) -> AsyncResult:
        """Run until the PS has applied ``total_updates`` pushes.

        batch_fn(update_index, worker_id) -> batch dict (pure; the data
        pipeline's determinism contract). configured_workers defaults to
        len(workers) — the TF slot count used by the NAIVE lr rule.
        """
        rng = np.random.default_rng(seed)
        configured = configured_workers or len(workers)
        for w in workers:
            w.snapshot = _snapshot(self.params)
            w.pull_version = self.version

        # priority queue of (completion_time, wid)
        pq: List[Tuple[float, int]] = []
        alive: Dict[int, AsyncWorker] = {}

        def schedule(w: AsyncWorker, now: float):
            dt = 1.0 / w.step_rate()
            dt *= 1.0 + jitter * rng.standard_normal() if jitter else 1.0
            heapq.heappush(pq, (now + max(dt, 1e-6), w.wid))

        for w in workers:
            if w.join_t <= 0:
                alive[w.wid] = w
                schedule(w, 0.0)
        pending = sorted((w for w in workers if w.join_t > 0),
                         key=lambda w: w.join_t)

        staleness: List[int] = []
        by_worker: Dict[int, List[int]] = {}
        curve: List[Tuple[float, int]] = [(0.0, len(alive))]
        losses: List[Tuple[int, float]] = []
        lr_hist: List[float] = []
        t = 0.0

        while self.version < total_updates and (pq or pending):
            # admit joins that have arrived by the head event's time
            if pending and (not pq or pending[0].join_t <= pq[0][0]):
                w = pending.pop(0)
                t = max(t, w.join_t)
                w.snapshot = _snapshot(self.params)
                w.pull_version = self.version
                alive[w.wid] = w
                schedule(w, t)
                curve.append((t, len(alive)))
                continue
            t, wid = heapq.heappop(pq)
            w = alive.get(wid)
            if w is None:
                continue
            if t >= w.revoke_t:                      # revoked mid-step: push lost
                del alive[wid]
                curve.append((t, len(alive)))
                continue

            lr_workers = len(alive) if adaptive_lr else configured
            lr = (self.ocfg.lr * float(self.sched(self.version))
                  * lr_workers / self.ocfg.base_workers)
            lr_hist.append(lr)
            batch = batch_fn(self.version, wid)
            # the reference applies the LR as a float32 scalar
            self._push(w.snapshot, batch, float(np.float32(lr)))
            staleness.append(self.version - w.pull_version)
            by_worker.setdefault(wid, []).append(self.version
                                                 - w.pull_version)
            self.version += 1
            w.snapshot = _snapshot(self.params)
            w.pull_version = self.version
            schedule(w, t)

            if eval_every and eval_fn and self.version % eval_every == 0:
                losses.append((self.version, float(eval_fn(self.params))))

        return AsyncResult(params=self.params, updates_applied=self.version,
                           staleness=np.asarray(staleness, np.int64),
                           active_worker_curve=curve, loss_curve=losses,
                           lr_history=lr_hist, staleness_by_worker=by_worker)


def sync_baseline(loss_fn, params: Tree, ocfg: OptimizerConfig,
                  scfg: ScheduleConfig, batch_fn, total_updates: int
                  ) -> Tree:
    """Single-worker synchronous SGD — the staleness-free control arm."""
    sim = AsyncPSSimulator(loss_fn, params, ocfg, scfg)
    w = [AsyncWorker(wid=0)]
    out = sim.run(w, batch_fn, total_updates, jitter=0.0, adaptive_lr=True)
    assert out.mean_staleness == 0.0     # one worker can never be stale
    return out.params

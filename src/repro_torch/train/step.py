"""train_step / serve_step / prefill_step factories, dense and paged
(counterpart of ``repro.train.step``).

``make_train_step`` builds the training step: loss -> gradients (with each
layer recomputed in the backward when ``tcfg.remat`` asks for it) ->
clip -> LR schedule x adaptive worker scale -> optimizer update.
Microbatching accumulates gradients over ``tcfg.microbatches`` slices of
the batch, so the activation peak is one microbatch. The adaptive-LR
multiplier (paper C6) is a runtime argument of the step.

Training holds float32 masters (``init_state``), as the reference does;
the forward casts each weight to ``cfg.dtype`` where it is used. The step
updates the masters and the optimizer state in place (see
``repro_torch.optim.optimizers``) and returns a ``TrainState`` holding
the same tensors. It never switches implementations: the kernels have
no backward, so the caller builds the training model with
``attn_impl``, ``ssm_impl`` and ``rwkv_impl`` set to ``"torch"``.

Not ported: the SPMD controls (``param_shardings``, ``zero1_mask``) and
``grad_dtype="bfloat16"``, ROADMAP.md Queue 1 item 7.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.models.builder import Model
from repro_torch.optim import make_optimizer, make_schedule
from repro_torch.optim.optimizers import clip_by_global_norm, global_norm
from repro_torch.tree import tree_leaves, tree_map

Tree = Dict[str, Any]
_SPMD = "ROADMAP.md Queue 1 item 7 (sharding and launch tooling)"


@dataclasses.dataclass
class TrainState:
    params: Tree             # float32 masters
    opt: Tree
    step: int


def init_state(model: Model, tcfg: TrainConfig,
               generator: Optional[torch.Generator] = None,
               params: Optional[Tree] = None) -> TrainState:
    """Float32 masters drawn from ``generator`` (default: seeded with
    ``tcfg.seed`` on the model's device), or the given ``params``, and a
    fresh optimizer state."""
    if params is None:
        gen = generator if generator is not None \
            else model.generator(tcfg.seed)
        params = model.init(gen, dtype=torch.float32)
    opt = make_optimizer(tcfg.optimizer).init(params)
    return TrainState(params=params, opt=opt, step=0)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def _token_weights(cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                   S: int) -> torch.Tensor:
    """Per-position loss weights. The reference masks the VLM image
    prefix; the port's families weigh every position."""
    if cfg.family == "vlm":
        raise NotImplementedError("vlm loss weights: ROADMAP.md Queue 1 "
                                  "item 6 (multimodal)")
    return torch.ones((1, S), dtype=torch.float32,
                      device=batch["labels"].device)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stable cross-entropy in float32. It gathers the gold logit where
    the reference multiplies by a one-hot: the same function, without a
    (B, S, V) one-hot."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None])[..., 0]
    nll = lse - gold
    if weights is None:
        return nll.mean()
    w = weights.expand_as(nll)
    return (nll * w).sum() / torch.clamp(w.sum(), min=1.0)


def loss_fn(model: Model, params: Tree, batch: Dict[str, torch.Tensor],
            tcfg: TrainConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total loss, {loss, aux}). The ported families' aux (MoE router)
    loss is zero, so the total is the cross-entropy: per token, or per
    image for resnet."""
    cfg = model.cfg
    logits, aux = model.apply(params, batch, remat=tcfg.remat != "none")
    if cfg.family == "resnet":
        loss = cross_entropy(logits, batch["labels"])
    else:
        w = _token_weights(cfg, batch, logits.shape[1])
        loss = cross_entropy(logits, batch["labels"], w)
    return loss, {"loss": loss, "aux": aux}


def value_and_grad(loss: Callable[[Tree], Tuple[torch.Tensor, Dict]],
                   params: Tree) -> Tuple[Tree, Dict[str, torch.Tensor]]:
    """(gradients of ``loss(params)[0]`` as a tree like ``params``, the
    detached metrics ``loss`` returns), through leaves that share the
    masters' storage. Each gradient is contiguous, as the optimizers'
    chunked in-place update reads it (a conv weight's gradient may come
    back in another memory format)."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        total, metrics = loss(leaves)
        grads = torch.autograd.grad(
            total, [t for _, t in tree_leaves(leaves)])
    it = iter(grads)
    return (tree_map(lambda _: next(it).contiguous(), leaves),
            {k: v.detach() for k, v in metrics.items()})


def apply_gradients(state: TrainState, grads: Tree, metrics: Dict,
                    lr_scale: float, tcfg: TrainConfig, opt, sched
                    ) -> Tuple[TrainState, Dict[str, Any]]:
    """Clip, LR schedule x ``lr_scale``, optimizer update of the masters
    IN PLACE; returns the next state and ``metrics`` with ``grad_norm``
    (a device scalar) and ``lr`` (a float)."""
    if tcfg.optimizer.grad_clip > 0:
        grads, gnorm = clip_by_global_norm(grads, tcfg.optimizer.grad_clip)
    else:
        gnorm = global_norm(grads)
    lr = tcfg.optimizer.lr * sched(state.step) * float(lr_scale)
    new_opt = opt.update(grads, state.opt, state.params, lr)
    return (TrainState(params=state.params, opt=new_opt, step=state.step + 1),
            dict(metrics, grad_norm=gnorm, lr=lr))


# ---------------------------------------------------------------------------
# train_step
# ---------------------------------------------------------------------------

def make_train_step(model: Model, tcfg: TrainConfig, param_shardings=None,
                    zero1_mask=None
                    ) -> Callable[..., Tuple[TrainState, Dict[str, Any]]]:
    """``train_step(state, batch, lr_scale=1.0) -> (state, metrics)``;
    metrics hold ``loss``, ``aux`` and ``grad_norm`` (device scalars) and
    ``lr`` (a float)."""
    if param_shardings is not None or zero1_mask is not None:
        raise NotImplementedError(f"param_shardings/zero1: {_SPMD}")
    if tcfg.grad_dtype != "float32":
        raise NotImplementedError(f"grad_dtype={tcfg.grad_dtype!r}: {_SPMD}")
    opt = make_optimizer(tcfg.optimizer)
    sched = make_schedule(tcfg.schedule)

    def grads_of(params: Tree, batch: Dict[str, torch.Tensor]
                 ) -> Tuple[Tree, Dict[str, torch.Tensor]]:
        return value_and_grad(lambda p: loss_fn(model, p, batch, tcfg),
                              params)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   lr_scale: float = 1.0
                   ) -> Tuple[TrainState, Dict[str, Any]]:
        k = tcfg.microbatches
        if k > 1:
            # a + b / k from zeros, as the reference's scan accumulates
            grads, metrics = None, None
            for i in range(k):
                mbatch = {key: x.reshape((k, x.shape[0] // k) + x.shape[1:])[i]
                          for key, x in batch.items()}
                g, m = grads_of(state.params, mbatch)
                if grads is None:
                    grads = tree_map(lambda b: b.div_(k), g)
                    metrics = {key: v / k for key, v in m.items()}
                else:
                    tree_map(lambda a, b: a.add_(b.div_(k)), grads, g)
                    metrics = {key: metrics[key] + v / k
                               for key, v in m.items()}
        else:
            grads, metrics = grads_of(state.params, batch)
        return apply_gradients(state, grads, metrics, lr_scale, tcfg, opt,
                               sched)

    return train_step


# ---------------------------------------------------------------------------
# serve_step / prefill_step (decode)
# ---------------------------------------------------------------------------


def make_serve_step(model: Model, *, sample: str = "greedy"
                    ) -> Callable[..., Tuple[torch.Tensor, Tree]]:
    """One-token decode step: (params, cache, tokens (B,1)) -> (next, cache)."""
    if sample != "greedy":
        raise ValueError(sample)

    @torch.no_grad()
    def serve_step(params: Tree, cache: Tree, tokens: torch.Tensor
                   ) -> Tuple[torch.Tensor, Tree]:
        logits, cache = model.decode(params, cache, {"tokens": tokens})
        # argmax keeps the first of tied maxima, as jnp.argmax does
        nxt = torch.argmax(logits[:, -1, :], dim=-1)
        return nxt[:, None], cache

    return serve_step


def make_prefill_step(model: Model) -> Callable[..., Tree]:
    """Blocked prefill: ``(params, cache, tokens (B, T), n_valid (B,)) ->
    cache``, ingesting up to T prompt tokens per row.

    A loop over the same decode cell ``make_serve_step`` runs, so the
    cache is token-for-token what the single-token path builds, recurrent
    state included. Rows advance only while the token index is below
    their ``n_valid``: the per-row advance mask goes into the decode cell,
    which drops the KV writes of frozen rows (decode rows and finished
    prefill rows), keeps their recurrent state, conv and token-shift rows,
    and leaves their ``pos``. The reference instead selects old or new rows
    of every cache leaf after the cell; the decode cell here writes the KV
    cache in place, so that select would need a copy of the whole cache
    per token.
    ``n_valid`` is a host array: the loop stops after the longest row
    (every row is frozen past it), and a token every row consumes needs
    no mask.
    """

    @torch.no_grad()
    def prefill_step(params: Tree, cache: Tree, tokens: torch.Tensor,
                     n_valid: Sequence[int]) -> Tree:
        n_valid = np.asarray(n_valid)
        for t in range(int(n_valid.max(initial=0))):
            adv = t < n_valid                   # rows consuming this token
            mask = None if adv.all() else torch.as_tensor(
                adv, device=tokens.device)
            _, cache = model.decode(params, cache,
                                    {"tokens": tokens[:, t:t + 1]}, mask)
        return cache

    return prefill_step


def make_paged_serve_step(model: Model, *, sample: str = "greedy"
                          ) -> Callable[..., Tuple[torch.Tensor, Tree]]:
    """One-token decode against the paged cache:
    ``(params, cache, tokens (B,1), active (B,)) -> (next, cache)``.

    Unlike the dense step, the active-row mask is part of the cell:
    inactive rows' page-table entries may point at pages owned by another
    request, so their KV writes must be dropped inside the cell, not
    merely ignored by the engine afterwards. ``active`` is a host array
    (no device sync)."""
    if sample != "greedy":
        raise ValueError(sample)

    @torch.no_grad()
    def serve_step(params: Tree, cache: Tree, tokens: torch.Tensor,
                   active: Sequence[bool]) -> Tuple[torch.Tensor, Tree]:
        logits, cache = model.decode_paged(params, cache, {"tokens": tokens},
                                           active)
        nxt = torch.argmax(logits[:, -1, :], dim=-1)
        return nxt[:, None], cache

    return serve_step


def make_paged_prefill_step(model: Model) -> Callable[..., Tree]:
    """Blocked prefill over the paged decode cell. Same contract as
    :func:`make_prefill_step`, ``(params, cache, tokens (B, T), n_valid
    (B,)) -> cache`` with ``n_valid`` a host array, and the same loop: the
    per-row advance mask goes into the cell, which writes no page for
    frozen rows (the reference's write drop) and keeps their per-row
    leaves (page table, pos, recurrent state) by a batch-axis select."""

    @torch.no_grad()
    def prefill_step(params: Tree, cache: Tree, tokens: torch.Tensor,
                     n_valid: Sequence[int]) -> Tree:
        n_valid = np.asarray(n_valid)
        for t in range(int(n_valid.max(initial=0))):
            _, cache = model.decode_paged(params, cache,
                                          {"tokens": tokens[:, t:t + 1]},
                                          t < n_valid)
        return cache

    return prefill_step

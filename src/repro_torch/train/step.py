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

``tcfg.grad_dtype="bfloat16"`` differentiates with respect to a bf16
copy of the masters and casts the gradients back to float32 before the
update. ``param_shardings`` (from ``repro_torch.sharding``) runs the step
on a mesh of processes, one per device: ``state.params`` and the
optimizer moments are each rank's float32 blocks (ZeRO: the moments are
sharded as the params are), the batch is the global one, of which each
rank takes its rows. The serve and prefill steps take ``param_shardings``
too, and run the decode cell on the rank's blocks and the rank's block
of the cache (``cache_shardings``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import sharding
from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.models import layers as L
from repro_torch.models.builder import Model
from repro_torch.models.modality import vlm_split
from repro_torch.obs.profiling import (TRAIN_BACKWARD, TRAIN_FORWARD,
                                       TRAIN_OPTIMIZER, annotate_span)
from repro_torch.optim import make_optimizer, make_schedule
from repro_torch.optim.optimizers import clip_by_global_norm, global_norm
from repro_torch.tree import tree_leaves, tree_map

Tree = Dict[str, Any]
GRAD_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


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
    """Per-position loss weights (1, S): the VLM image prefix weighs 0,
    every other position 1 (encdec's S are the decoder's positions)."""
    device = batch["labels"].device
    if cfg.family == "vlm":
        n_img, _ = vlm_split(cfg, S)
        return (torch.arange(S, device=device) >= n_img).float()[None, :]
    return torch.ones((1, S), dtype=torch.float32, device=device)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  weights: Optional[torch.Tensor] = None,
                  like=None) -> torch.Tensor:
    """Stable cross-entropy in float32. It gathers the gold logit where
    the reference multiplies by a one-hot: the same function, without a
    (B, S, V) one-hot. ``like``: the unembedding's leaf; when it is split
    on its vocabulary (``sharding.split_axes``), ``logits`` are the rank's
    vocabulary block and the loss is vocabulary-parallel
    (:class:`_VocabParallelNLL`)."""
    logits = logits.float()
    if sharding.split_axes(like):
        nll = _VocabParallelNLL.apply(logits, labels, like)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels[..., None])[..., 0]
        nll = lse - gold
    if weights is None:
        return nll.mean()
    w = weights.expand_as(nll)
    return (nll * w).sum() / torch.clamp(w.sum(), min=1.0)


class _VocabParallelNLL(torch.autograd.Function):
    """-log softmax(logits)[label] from each rank's vocabulary block
    (float32): the row maximum by a max all-reduce, then one sum
    all-reduce of the sum of exp and of the gold logit, which the rank
    that holds the label contributes (the others 0). The full logits are
    never gathered. The backward is the unsharded loss's to the bit on
    one rank: exp(logits - lse) x g, then -g at the label, as autograd
    of ``logsumexp`` and of the gold ``gather`` sums them."""

    @staticmethod
    def forward(ctx, logits, labels, like):
        mesh, axes = like.mesh, sharding.split_axes(like)
        n = logits.shape[-1]
        top = sharding.all_reduce_(logits.amax(dim=-1), mesh, axes, "max")
        local = labels - sharding.split_index(like) * n
        inside = (local >= 0) & (local < n)
        at = local.clamp(0, n - 1)[..., None]
        gold = logits.gather(-1, at)[..., 0]
        gold = torch.where(inside, gold, torch.zeros_like(gold))
        sums = torch.stack([torch.exp(logits - top[..., None]).sum(-1),
                            gold])
        sharding.all_reduce_(sums, mesh, axes, "sum")
        lse = torch.log(sums[0]) + top
        ctx.save_for_backward(logits, lse, at, inside)
        return lse - sums[1]

    @staticmethod
    def backward(ctx, g):
        logits, lse, at, inside = ctx.saved_tensors
        grad = torch.exp(logits - lse[..., None]) * g[..., None]
        grad.scatter_add_(-1, at, torch.where(inside, -g, 0.0)[..., None])
        return grad, None, None


def greedy(logits: torch.Tensor, like=None) -> torch.Tensor:
    """argmax over the last axis, the first of tied maxima, as
    ``jnp.argmax`` takes it. With ``like`` split on its vocabulary,
    ``logits`` are the rank's block: a max all-reduce of the blocks'
    maxima, then a min all-reduce of the global indices that reach it."""
    axes = sharding.split_axes(like)
    idx = torch.argmax(logits, dim=-1)
    if not axes:
        return idx
    mesh = like.mesh
    val = logits.gather(-1, idx[..., None])[..., 0].float()
    top = sharding.all_reduce_(val.clone(), mesh, axes, "max")
    idx = idx + sharding.split_index(like) * logits.shape[-1]
    cand = torch.where(val == top, idx, torch.full_like(idx, 2 ** 62))
    return sharding.all_reduce_(cand, mesh, axes, "min")


def loss_fn(model: Model, params: Tree, batch: Dict[str, torch.Tensor],
            tcfg: TrainConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total loss, {loss, aux}): the cross-entropy (per token, or per
    image for resnet) plus ``router_aux_coef`` x the MoE router's aux
    loss, which is zero for the other families."""
    cfg = model.cfg
    logits, aux = model.apply(params, batch, remat=tcfg.remat != "none")
    if cfg.family == "resnet":
        loss = cross_entropy(logits, batch["labels"])
    else:
        w = _token_weights(cfg, batch, logits.shape[1])
        loss = cross_entropy(logits, batch["labels"], w, like=L.unembed_leaf(
            params["embed"], cfg.tie_embeddings))
    total = loss + cfg.router_aux_coef * aux
    return total, {"loss": loss, "aux": aux}


def value_and_grad(loss: Callable[[Tree], Tuple[torch.Tensor, Dict]],
                   params: Tree, dtype: Optional[torch.dtype] = None,
                   reduce: Optional[Callable[[Tree, Dict], Tuple[Tree, Dict]]]
                   = None) -> Tuple[Tree, Dict[str, torch.Tensor]]:
    """(gradients of ``loss(params)[0]`` as a tree like ``params``, the
    detached metrics ``loss`` returns), through leaves that share the
    masters' storage, or, given ``dtype``, through a copy of them cast to
    it (the gradients then come in ``dtype``). Each gradient is
    contiguous, as the optimizers' chunked in-place update reads it (a
    conv weight's gradient may come back in another memory format).
    ``reduce(grads, metrics)`` (a sharded step's sums over the ranks)
    runs in the backward's span and returns them.

    The cast and ``loss`` run in the span ``train.forward``, the
    backward (with the remat recompute) in ``train.backward``."""
    with torch.enable_grad():
        with annotate_span(TRAIN_FORWARD):
            leaves = tree_map(lambda p: p.detach().to(dtype or p.dtype)
                              .requires_grad_(), params)
            total, metrics = loss(leaves)
        with annotate_span(TRAIN_BACKWARD):
            grads = torch.autograd.grad(
                total, [t for _, t in tree_leaves(leaves)])
            it = iter(grads)
            grads = tree_map(lambda _: next(it).contiguous(), leaves)
            metrics = {k: v.detach() for k, v in metrics.items()}
            return reduce(grads, metrics) if reduce else (grads, metrics)


def apply_gradients(state: TrainState, grads: Tree, metrics: Dict,
                    lr_scale: float, tcfg: TrainConfig, opt, sched,
                    norm: Optional[torch.Tensor] = None
                    ) -> Tuple[TrainState, Dict[str, Any]]:
    """Clip, LR schedule x ``lr_scale``, optimizer update of the masters
    IN PLACE; returns the next state and ``metrics`` with ``grad_norm``
    (a device scalar) and ``lr`` (a float). ``norm`` is the gradients'
    global norm when the caller has it (a sharded step's, over all
    ranks); by default it is computed from ``grads``."""
    gnorm = global_norm(grads) if norm is None else norm
    if tcfg.optimizer.grad_clip > 0:
        grads, _ = clip_by_global_norm(grads, tcfg.optimizer.grad_clip,
                                       norm=gnorm)
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
    ``lr`` (a float).

    ``param_shardings`` (a tree of ``sharding.NamedSharding`` matching the
    params; every rank calls the step, under ``use_mesh``) runs the step
    on the mesh's ranks. The compute copy (bf16 under
    ``grad_dtype="bfloat16"``, cast from each rank's blocks) is gathered
    through the differentiable gathers of ``sharding.take``, whose
    backward reduce-scatters the gradients at their own dtype:

    - layouts ``"tp"`` and ``"fsdp"`` (the transformer families): per use.
      The model gets the blocks as ``sharding.Sharded`` leaves and gathers
      each layer's where the layer runs, again in the backward under
      remat. Under ``tp`` the gathers are over the data axes and the
      model-split dims stay split: attention heads, ``ff``, the
      vocabulary and the Mamba-2 and RWKV-6 heads compute tensor-parallel
      (each model rank holds the same rows; the recurrent layers regroup
      the columns their heads read per use, ``sharding.take_ranges``).
      Under ``fsdp`` every gather is over every axis;
    - layout ``"zero1"`` (and resnet under any layout): once a step.
      ``zero1_mask`` (a bool tree, optional) leaves out leaves to keep
      expert-parallel: an expert weight stack keeps its ``experts`` entry
      (the MoE routes read the rank's experts) and is gathered over its
      other entries; any other leaf is gathered whole, as the reference's
      shard_map in_specs ask for it;
    - each rank's loss, a mean over its rows, is weighted by 1 / (number
      of data ranks, ``sharding.data_size`` of the layout), so that the
      sum over the data ranks is the global mean. The ranks of a tp group
      hold the same rows and the same loss; the tensor-parallel operators
      (``sharding.copy_to``, ``reduce_from``, and the sums of
      ``take_ranges`` and ``whole_in`` over the leaves a recurrent layer
      reads in part or whole) make each one's gradient of a leaf it holds
      whole the whole gradient, and of a split leaf its block's, so
      nothing is summed over ``model``: a gather over
      ``model`` of a leaf used whole keeps the rank's block of its
      gradient. Over the data axes every gradient is summed: the
      reduce-scatter covers those a leaf was gathered over, an all-reduce
      the others;
    - ``grad_norm`` and clipping use the norm over all blocks, each
      replicated block counted once; the reported ``loss`` and ``aux``
      are the global means.
    """
    if tcfg.grad_dtype not in GRAD_DTYPES:
        raise ValueError(f"grad_dtype {tcfg.grad_dtype!r} is not one of "
                         f"{sorted(GRAD_DTYPES)}")
    compute_dt = GRAD_DTYPES[tcfg.grad_dtype]
    opt = make_optimizer(tcfg.optimizer)
    sched = make_schedule(tcfg.schedule)
    if param_shardings is None:
        def grads_of(params: Tree, batch: Dict[str, torch.Tensor]
                     ) -> Tuple[Tree, Dict[str, torch.Tensor]]:
            return value_and_grad(lambda p: loss_fn(model, p, batch, tcfg),
                                  params, compute_dt)
        norm_of = global_norm
    else:
        grads_of, norm_of = _sharded(model, tcfg, param_shardings,
                                     zero1_mask, compute_dt)

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
                    grads = tree_map(lambda b: b.div_(k).float(), g)
                    metrics = {key: v / k for key, v in m.items()}
                else:
                    tree_map(lambda a, b: a.add_(b.div_(k)), grads, g)
                    metrics = {key: metrics[key] + v / k
                               for key, v in m.items()}
        else:
            grads, metrics = grads_of(state.params, batch)
        with annotate_span(TRAIN_OPTIMIZER):
            grads = tree_map(lambda g: g.float(), grads)  # k > 1: float32
            return apply_gradients(state, grads, metrics, lr_scale, tcfg,
                                   opt, sched, norm=norm_of(grads))

    return train_step


PER_USE_LAYOUTS = ("tp", "fsdp")


def _sharded(model: Model, tcfg: TrainConfig, shardings: Tree, zero1_mask,
             compute_dt: Optional[torch.dtype]):
    """(grads_of, norm_of) of the sharded step (``make_train_step``)."""
    mesh = next(tree_leaves(shardings))[1].mesh
    everything = tuple(mesh.axis_names)
    layout = tcfg.layout
    dax = sharding.data_axes(mesh, layout)
    n_data = sharding.data_size(mesh, layout)

    def keep(s: sharding.NamedSharding, whole: bool) -> Tuple[str, ...]:
        own = [a for a in s.axes if a not in ("layers", "blocks")]
        if whole or own[:1] != ["experts"]:
            return ()
        return sharding.entry_axes(s.spec[s.axes.index("experts")])

    if layout in PER_USE_LAYOUTS and model.cfg.family != "resnet":
        keeps = None                            # the model gathers per use
    elif layout == "zero1" and zero1_mask is not None:
        keeps = tree_map(keep, shardings, zero1_mask)
    else:
        keeps = tree_map(lambda s: (), shardings)
    # the data axes each leaf's gradient is all-reduced over after the
    # reduce-scatter: those its spec does not name
    rest = tree_map(lambda s: tuple(
        a for a in dax if a not in sharding.spec_axes(s.spec)), shardings)

    def grads_of(params: Tree, batch: Dict[str, torch.Tensor]
                 ) -> Tuple[Tree, Dict[str, torch.Tensor]]:
        rows = sharding.local_batch(batch, mesh, layout)

        def loss(blocks: Tree):
            tree = sharding.wrap_tree(blocks, shardings, layout)
            if keeps is not None:               # once a step
                tree = tree_map(sharding.take, tree, keeps)
            total, metrics = loss_fn(model, tree, rows, tcfg)
            return total / n_data, metrics

        @torch.no_grad()
        def reduce(grads: Tree, metrics: Dict[str, torch.Tensor]):
            grads = tree_map(
                lambda g, axes: sharding.all_reduce_(g, mesh, axes)
                if axes else g, grads, rest)
            keys = sorted(metrics)
            m = torch.stack([metrics[k].float() for k in keys]) / mesh.size
            sharding.all_reduce_(m, mesh, everything)
            return grads, dict(zip(keys, m.unbind()))

        return value_and_grad(loss, params, compute_dt, reduce)

    @torch.no_grad()
    def norm_of(grads: Tree) -> torch.Tensor:
        sq = sum(torch.linalg.vector_norm(g.float()) ** 2
                 / sharding.replication(s.spec, mesh)
                 for (_, g), (_, s) in zip(tree_leaves(grads),
                                           tree_leaves(shardings)))
        return torch.sqrt(sharding.all_reduce_(sq, mesh, everything))

    return grads_of, norm_of


class _Cell:
    """What a sharded serve, prefill or forward step adds around the
    model: the blocks as ``sharding.Sharded`` leaves, the mesh and layout
    in use, and the cache's sequence split (from ``cache_shardings``, a
    tree of specs like ``launch.specs.cache_shardings``'s: the axes of
    the sequence entry of its attention leaves, if any). Without
    ``param_shardings`` it adds nothing."""

    def __init__(self, param_shardings=None, cache_shardings=None,
                 layout: str = "tp"):
        self.shardings, self.layout = param_shardings, layout
        self.mesh = (None if param_shardings is None
                     else next(tree_leaves(param_shardings))[1].mesh)
        self.seq_axes: Tuple[str, ...] = ()
        for path, spec in tree_leaves(cache_shardings or {}):
            if (path.split("/")[-1] in ("k", "v") and len(spec) == 5
                    and spec[2] is not None):
                self.seq_axes = sharding.entry_axes(spec[2])
        if self.seq_axes and self.mesh is None:
            raise ValueError("a cache split on its sequence needs "
                             "param_shardings (the mesh)")

    def wrap(self, params: Tree) -> Tree:
        if self.shardings is None:
            return params
        return sharding.wrap_tree(params, self.shardings, self.layout)

    @contextlib.contextmanager
    def scope(self):
        if self.mesh is None:
            yield
            return
        with sharding.use_mesh(self.mesh, self.layout), \
                sharding.use_kv_seq(self.mesh, self.seq_axes):
            yield


def make_forward(model: Model, *, param_shardings=None, layout: str = "tp"
                 ) -> Callable[..., Tuple[torch.Tensor, torch.Tensor]]:
    """``forward(params, batch) -> (logits, aux)`` without a gradient
    (prefill, evaluation). With ``param_shardings`` ``params`` are the
    rank's blocks and ``batch`` the rank's rows; the forward gathers per
    use and computes tensor-parallel under ``tp``, as the train step's
    does, and the logits are the rank's vocabulary block when the
    unembedding is split on it."""
    cell = _Cell(param_shardings, layout=layout)

    @torch.no_grad()
    def forward(params: Tree, batch: Dict[str, torch.Tensor]):
        with cell.scope():
            return model.apply(cell.wrap(params), batch, remat=False)

    return forward


# ---------------------------------------------------------------------------
# serve_step / prefill_step (decode)
# ---------------------------------------------------------------------------


def make_serve_step(model: Model, *, sample: str = "greedy",
                    param_shardings=None, cache_shardings=None,
                    layout: str = "tp"
                    ) -> Callable[..., Tuple[torch.Tensor, Tree]]:
    """One-token decode step: (params, cache, tokens (B,1)) -> (next, cache).

    With ``param_shardings`` every rank calls it with its blocks, its
    block of the cache (its rows, or, when ``cache_shardings`` split the
    cache's sequence, its positions of every row; its KV heads under
    ``tp`` where the spec splits them: ``Model.init_cache(...,
    kv_heads=)``) and the tokens of its rows; the decode cell gathers per
    use, computes tensor-parallel, attends over a sequence-split cache by
    merging the ranks' partials, and the argmax reads the vocabulary
    blocks of every model rank (:func:`greedy`)."""
    if sample != "greedy":
        raise ValueError(sample)
    cell = _Cell(param_shardings, cache_shardings, layout)
    tie = model.cfg.tie_embeddings

    @torch.no_grad()
    def serve_step(params: Tree, cache: Tree, tokens: torch.Tensor
                   ) -> Tuple[torch.Tensor, Tree]:
        with cell.scope():
            tree = cell.wrap(params)
            logits, cache = model.decode(tree, cache, {"tokens": tokens})
            # argmax keeps the first of tied maxima, as jnp.argmax does
            nxt = greedy(logits[:, -1, :], L.unembed_leaf(tree["embed"],
                                                          tie))
        return nxt[:, None], cache

    return serve_step


def make_prefill_step(model: Model, *, param_shardings=None,
                      cache_shardings=None, layout: str = "tp"
                      ) -> Callable[..., Tree]:
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
    no mask. ``param_shardings``, ``cache_shardings`` and ``layout`` as
    for :func:`make_serve_step`.
    """
    cell = _Cell(param_shardings, cache_shardings, layout)

    @torch.no_grad()
    def prefill_step(params: Tree, cache: Tree, tokens: torch.Tensor,
                     n_valid: Sequence[int]) -> Tree:
        n_valid = np.asarray(n_valid)
        with cell.scope():
            tree = cell.wrap(params)
            for t in range(int(n_valid.max(initial=0))):
                adv = t < n_valid               # rows consuming this token
                mask = None if adv.all() else torch.as_tensor(
                    adv, device=tokens.device)
                _, cache = model.decode(tree, cache,
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

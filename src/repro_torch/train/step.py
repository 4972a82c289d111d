"""serve_step / prefill_step factories (counterpart of the serving half of
``repro.train.step``)."""
from __future__ import annotations

from typing import Any, Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.builder import Model

Tree = Dict[str, Any]


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
    cache is token-for-token what the single-token path builds. Rows
    advance only while the token index is below their ``n_valid``: the
    per-row advance mask goes into the decode cell, which drops the cache
    writes of frozen rows (decode rows and finished prefill rows) and
    leaves their ``pos``. The reference instead selects old or new rows
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

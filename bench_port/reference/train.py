"""The reference's training steps: the same AdamW steps as the program's
on the same batches from the same initial weights, in float32 (or at the
control's precision), with the loss's gradient taken row by row and each
layer recomputed in the backward, so that it fits beside the weights,
gradients and moments. Each layer of a stacked leaf is a leaf of its own
(a view into the stack), so that the rows' gradients add into each
layer's gradient in place: through the stack, each row's backward would
hold the layers' gradients and their stacked copy beside the sum of the
rows before it, three times the gradients.
"""
from __future__ import annotations

import math
from typing import (Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

import torch

from bench_port.reference import common as C
from bench_port.reference import model
from bench_port.weights import nest


def steps(params: Mapping[str, torch.Tensor], m: Mapping,
          batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
          opt: Mapping, sched: Mapping, prec: str = "float32",
          rows_total: Optional[int] = None,
          reduce: Optional[Callable[[List[torch.Tensor]], None]] = None
          ) -> Tuple[List[float], Dict[str, float]]:
    """Train ``params`` (path -> float32 leaf, updated IN PLACE) one step
    per batch (tokens, labels), each (B, S). Returns (each step's mean
    loss, each leaf's gradient norm at the first step as the optimizer
    takes it: after clipping).

    Data-parallel: each process passes its own rows of every batch,
    ``rows_total`` the rows of all of them, and ``reduce`` a sum of a list
    of tensors over the processes, in place (say, ``all_reduce``); the
    loss and every gradient are summed before the update, which every
    process then makes alike."""
    family = model(m["family"])
    split = {k: [x.detach().requires_grad_() for x in v.unbind(0)]
             for k, v in params.items() if k.split("/")[0] in family.STACKED}
    whole = {k: v.detach().requires_grad_() for k, v in params.items()
             if k not in split}
    leaves = dict(whole, **{f"{k}#{i}": x for k, xs in split.items()
                            for i, x in enumerate(xs)})
    tree = nest({**whole, **split})
    adam = C.AdamW(leaves, opt)
    losses: List[float] = []
    first: Dict[str, float] = {}
    with C.strict_fp32():
        for t, (tok, lab) in enumerate(batches):
            for v in leaves.values():
                v.grad = None
            B = rows_total or tok.shape[0]
            total = torch.zeros((), device=tok.device)
            for r in range(tok.shape[0]):
                lg = family.forward(tree, m, tok[r:r + 1], prec, remat=True)
                loss = C.nll(lg, lab[r:r + 1]) / B
                loss.backward()
                total += loss.detach()
                del lg, loss
            grads = {k: v.grad for k, v in leaves.items()}
            if reduce is not None:
                reduce([total, *grads.values()])
            norms = adam.step(grads, opt["lr"] * C.schedule(t, sched))
            if t == 0:
                first = {k: math.sqrt(sum(
                    norms[f"{k}#{i}"] ** 2 for i in range(len(split[k]))))
                    if k in split else norms[k] for k in params}
            losses.append(float(total))
    for v in leaves.values():
        v.grad = None
    return losses, first

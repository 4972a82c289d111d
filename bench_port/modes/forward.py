"""The ``forward`` mode: full-sequence forwards through the program's
``make_forward`` (evaluation, long-document scoring), back to back.

Set-up builds the program's model with its CUDA kernels on the card
(``attn_impl``, ``ssm_impl`` and ``rwkv_impl`` ``"cuda"``; ``"torch"``
on the CPU, where the kernels cannot run), hands it the weights the
benchmark made from the seed in the configuration's dtype, and runs one
forward of the window's shape on a batch the window does not use, which
builds and loads the kernels. The window then dispatches forward after
forward, each on its own batch (``tokens(seed, i)``), until
``--seconds`` have passed on the host's clock, and synchronises once.
``forward_tokens_per_s`` is every token of those forwards over the whole
window.

The window's last forward keeps its logits. After the window, with the
program's weights freed, the reference computes every row of that
forward in float32 and the worst position's relative gap of the logits
is compared (``harness.logits_gap``).

Traffic parameters: ``batch``, ``seq_len``.
"""
from __future__ import annotations

import time
from typing import Dict

import torch

from bench_port import counts, devtrace, harness, traffic, weights
from bench_port.reference import common as C
from bench_port.reference import model as ref_model

WARM_UP = -1                  # the batch index set-up's forward uses



def _spec(cell: harness.Cell):
    from repro_torch.config import ModelConfig
    from repro_torch.models.builder import build_model, init_params
    from repro_torch.tree import tree_leaves
    impl = "cuda" if cell.device.type == "cuda" else "torch"
    cfg = ModelConfig(**cell.model, attn_impl=impl, ssm_impl=impl,
                      rwkv_impl=impl)
    spec = weights.spec_of(tree_leaves(init_params(
        cfg, None, torch.device("meta"))))
    return build_model(cfg, cell.device), spec


def batch(cell: harness.Cell, index: int) -> torch.Tensor:
    t = cell.traffic
    return traffic.tokens(cell.seed, index, t["batch"], t["seq_len"],
                          cell.model["vocab_size"], cell.device)


def run(cell: harness.Cell) -> harness.Outcome:
    from repro_torch.train.step import make_forward
    dev, t = cell.device, cell.traffic
    model, spec = _spec(cell)
    cell.mark("program imported")
    flat = weights.make(spec, cell.seed, dev)
    params = weights.nest(flat)
    harness.sync(dev)
    cell.mark("weights made")
    fwd = make_forward(model)
    out, _ = fwd(params, {"tokens": batch(cell, WARM_UP)})
    del out
    harness.sync(dev)
    cell.mark("warm-up forward run")
    setup_s = time.monotonic() - cell.t0
    n = 0
    with devtrace.Window(cell.trace, dev) as win:
        start = time.monotonic()
        while True:
            out = None
            with torch.profiler.record_function("bench.forward"):
                with torch.profiler.record_function("bench.feed"):
                    tokens = batch(cell, n)
                out, _ = fwd(params, {"tokens": tokens})
            n += 1
            if time.monotonic() - start >= cell.seconds:
                break
        harness.sync(dev)
        window_s = time.monotonic() - start
    cell.mark("window closed")
    peak = harness.peak_bytes(dev)
    del params, flat, fwd, model, tokens
    harness.free(dev)
    last = n - 1

    def compare() -> Dict[str, float]:
        return {"logits_gap": gap(cell, spec, last, out)}

    return harness.Outcome(
        e2e={"forward_tokens_per_s": n * t["batch"] * t["seq_len"]
             / window_s},
        units=n, unit_flops=counts.fwd_flops(cell.model, t["batch"],
                                             t["seq_len"]),
        window_s=window_s, setup_s=setup_s, peak_bytes=peak,
        compare=compare, summary=win.summary,
        failed=int(not bool(torch.isfinite(out).all())))


def reference_logits(cell: harness.Cell, params, tokens: torch.Tensor,
                     prec: str = "float32") -> torch.Tensor:
    """The reference's logits (S, V) of one row, float32."""
    fwd = ref_model(cell.model["family"]).forward
    with C.strict_fp32(), torch.no_grad():
        return fwd(params, cell.model, tokens[None], prec)[0]


def _ref_params(cell: harness.Cell, spec):
    made = weights.make(spec, cell.seed, cell.device)
    return weights.nest({k: v.float() for k, v in made.items()})


def gap(cell: harness.Cell, spec, index: int, logits: torch.Tensor
        ) -> float:
    """The worst position's gap, over every row of forward ``index``,
    between ``logits`` (B, S, V) and the reference's."""
    params = _ref_params(cell, spec)
    tokens = batch(cell, index)
    top = 0.0
    for r in range(tokens.shape[0]):
        ref = reference_logits(cell, params, tokens[r])
        top = harness.worst([top, harness.logits_gap(logits[r], ref)])
        del ref
    return top


def control(cell: harness.Cell) -> Dict[str, Dict[str, float]]:
    """The control's gap: the reference at fp8 (the precision below the
    configuration's bf16) put in the program's place, over every row of
    the window's first batch."""
    _, spec = _spec(cell)
    params = _ref_params(cell, spec)
    tokens = batch(cell, 0)
    top = 0.0
    for r in range(tokens.shape[0]):
        low = reference_logits(cell, params, tokens[r], "fp8")
        ref = reference_logits(cell, params, tokens[r])
        top = harness.worst([top, harness.logits_gap(low, ref)])
        del low, ref
    return {"fp8": {"logits_gap": top}}


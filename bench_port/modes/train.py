"""The ``train`` mode: a training job through the program's ``Trainer``.

Set-up builds one training object: the program's model (every
implementation ``"torch"``: no kernel has a backward), float32 master
weights the benchmark made from the seed, the program's AdamW state
(``init_state``) and a ``Trainer`` over the benchmark's token feed. It
drives that object through the first ``CHECKED_STEPS`` steps, one
``Trainer.fit`` call each, and reads from it what the reference will be
held to: each step's loss, each leaf's first gradient as the optimizer
took it (its first moment after one step over 1 - beta1) and each leaf's
distance from its initial value after the checked steps. The same
object then runs the window: one ``Trainer.fit`` call of as many steps
as the checked steps' pace fits into ``--seconds``, dispatched back to
back, then one synchronisation. ``train_tokens_per_s`` is every token
of those steps over the whole window.

After the window, with the program's state freed, the reference trains
the same initial weights on the same batches and the gaps are compared
(``harness.train_gaps``).

Traffic parameters: ``batch``, ``seq_len``, ``optimizer`` and
``schedule`` (as the program's ``OptimizerConfig`` and ``ScheduleConfig``
name them), ``remat`` and ``grad_dtype``.
"""
from __future__ import annotations

import math
import time
from typing import Dict, Optional

import torch

from bench_port import counts, devtrace, harness, traffic, weights
from bench_port.reference import train as ref_train

CHECKED_STEPS = 3


def _program(cell: harness.Cell):
    from repro_torch.config import (ModelConfig, OptimizerConfig,
                                    ScheduleConfig, TrainConfig)
    from repro_torch.models.builder import build_model, init_params
    from repro_torch.tree import tree_leaves
    t = cell.traffic
    cfg = ModelConfig(**cell.model, attn_impl="torch", ssm_impl="torch",
                      rwkv_impl="torch")
    spec = weights.spec_of(tree_leaves(init_params(
        cfg, None, torch.device("meta"), torch.float32)))
    tcfg = TrainConfig(optimizer=OptimizerConfig(**t["optimizer"]),
                       schedule=ScheduleConfig(**t["schedule"]),
                       remat=t["remat"], grad_dtype=t["grad_dtype"],
                       checkpoint_every=0, seed=cell.seed)
    return build_model(cfg, cell.device), tcfg, spec


def feed(cell: harness.Cell) -> traffic.TokenFeed:
    t = cell.traffic
    return traffic.TokenFeed(cell.seed, t["batch"], t["seq_len"],
                             cell.model["vocab_size"], cell.device)


def run(cell: harness.Cell) -> harness.Outcome:
    from repro_torch.train.step import init_state
    from repro_torch.train.trainer import Trainer
    dev, t = cell.device, cell.traffic
    model, tcfg, spec = _program(cell)
    cell.mark("program imported")
    flat = weights.make(spec, cell.seed, dev)
    cell.mark("weights made")
    state = init_state(model, tcfg, params=weights.nest(flat))
    trainer = Trainer(model, tcfg, feed(cell), log_every=1 << 62)
    losses = []
    paces = []
    grad: Dict[str, float] = {}
    b1 = t["optimizer"]["beta1"]
    for i in range(CHECKED_STEPS):
        start = time.monotonic()
        state = trainer.fit(state, 1, on_step=lambda s, m: losses.append(
            m["loss"]))
        harness.sync(dev)
        paces.append(time.monotonic() - start)
        if i == 0:
            grad = {p: float(torch.linalg.vector_norm(m)) / (1 - b1)
                    for p, m in weights.flatten(state.opt["m"]).items()}
    prog = {"losses": [float(x) for x in losses], "grad": grad,
            "change": weights.init_distance(flat, spec, cell.seed)}
    cell.mark(f"checked steps run ({', '.join(f'{p:.3f}' for p in paces)} s)")
    pace = min(paces[1:] or paces)
    steps = max(1, round(cell.seconds / pace))
    setup_s = time.monotonic() - cell.t0
    with devtrace.Window(cell.trace, dev) as win:
        start = time.monotonic()
        state = trainer.fit(state, steps)
        harness.sync(dev)
        window_s = time.monotonic() - start
    cell.mark("window closed")
    peak = harness.peak_bytes(dev)
    del state, trainer, flat, model
    harness.free(dev)
    tokens = t["batch"] * t["seq_len"]

    def compare() -> Dict[str, float]:
        harness.reset_peak(dev)
        ref = reference(cell, spec)
        cell.mark(f"check's peak {harness.peak_bytes(dev) / harness.GB:.2f}"
                  " GB")
        return harness.train_gaps(prog, ref)

    return harness.Outcome(
        e2e={"train_tokens_per_s": steps * tokens / window_s},
        units=steps,
        unit_flops=3 * counts.fwd_flops(cell.model, t["batch"], t["seq_len"]),
        window_s=window_s, setup_s=setup_s, peak_bytes=peak,
        compare=compare, summary=win.summary,
        failed=sum(not math.isfinite(x) for x in prog["losses"]))


def reference(cell: harness.Cell, spec, prec: str = "float32",
              rows: Optional[int] = None) -> Dict:
    """The reference's readings (``losses``, ``grad``, ``change``) over
    the checked steps, from the seed's weights and batches; ``rows``
    keeps the first rows of each batch only."""
    t = cell.traffic
    f = feed(cell)
    batches = []
    for step in range(CHECKED_STEPS):
        b = f.global_batch_at(step)
        batches.append((b["tokens"][:rows], b["labels"][:rows]))
    params = weights.make(spec, cell.seed, cell.device)
    losses, grad = ref_train.steps(params, cell.model, batches,
                                   t["optimizer"], t["schedule"], prec)
    change = weights.init_distance(params, spec, cell.seed)
    del params
    harness.free(cell.device)
    return {"losses": losses, "grad": grad, "change": change}


def control(cell: harness.Cell) -> Dict[str, Dict[str, float]]:
    """The control's and the planted faults' gaps from the float32
    reference, each put in the program's place: ``fp8`` (the reference
    at the precision below the configuration's bf16), ``half_batch`` (the
    mean over the first half of each batch's rows)."""
    _, _, spec = _program(cell)
    ref = reference(cell, spec)
    fp8 = reference(cell, spec, prec="fp8")
    half = reference(cell, spec, rows=cell.traffic["batch"] // 2)
    return {"fp8": harness.train_gaps(fp8, ref),
            "half_batch": harness.train_gaps(half, ref)}

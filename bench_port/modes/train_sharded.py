"""The ``train_sharded`` mode: data-parallel training across cards
through the program's sharded step, one process a card.

The run spawns one process a rank (``torch.multiprocessing``, spawn),
joined by a file store in a temporary directory: NCCL on the cards
(``gloo`` on the CPU, for the tests). Each rank builds the program's
mesh (``launch/mesh.py::make_mesh`` of the traffic's ``mesh``), the
parameter shardings of the traffic's ``layout``
(``sharding.param_shardings``), the float32 masters the benchmark made
from the seed cut to the rank's blocks (``sharding.shard_tree``), the
program's AdamW state of those blocks and
``make_train_step(param_shardings=, zero1_mask=)``, and calls it under
``sharding.use_mesh`` with the global batch, of which the step takes the
rank's rows. As in the ``train`` mode, set-up drives that step through
the checked steps and reads each step's loss, each leaf's first gradient
as AdamW took it (the norm over every rank's block of its first moment,
each block counted once) and each leaf's distance from its start (the
leaves gathered once, on rank 0); the window then dispatches as many
steps as the checked steps' pace fits into ``--seconds`` (the slowest
rank's pace), back to back, and synchronises.

After the window, with the program's state freed, the reference trains
the same weights on the same batches, data-parallel as well: each rank
its rows, the loss and the gradients summed over the ranks with
``torch.distributed.all_reduce`` before every rank's identical update.
Rank 0's readings are compared (``harness.train_gaps``). Each rank
names the modules of JAX or of the JAX package loaded in its process by
then, and the run raises ``harness.ForbiddenModules`` if any rank found
one.

Traffic parameters: those of the ``train`` mode (``batch`` is the
global batch), ``mesh`` (``MeshConfig``'s ``data``, ``model``) and
``layout``.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import statistics
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List

import torch
import torch.distributed as dist

from bench_port import counts, devtrace, harness, weights
from bench_port.modes import train as single
from bench_port.reference import train as ref_train

TIMEOUT = datetime.timedelta(minutes=5)


def _spawn(target, cell: harness.Cell, plant=None) -> List:
    """``target(rank, cell)`` on every rank, after ``plant()`` there when
    given (the tests' faults); their results. Raises
    ``harness.ForbiddenModules`` if a rank's process had loaded JAX or
    the JAX package by the time ``target`` returned."""
    import torch.multiprocessing as mp
    world = cell.chips
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_main, args=(world, tmp, target, cell, plant),
                 nprocs=world, join=True)
        ranks = [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                 for r in range(world)]
    found = {r: x["loaded"] for r, x in enumerate(ranks) if x["loaded"]}
    if found:
        raise harness.ForbiddenModules(
            "; ".join(f"rank {r}: {m}" for r, m in found.items()))
    return [x["out"] for x in ranks]


def _rank_main(rank: int, world: int, tmp: str, target, cell, plant
               ) -> None:
    if cell.device.type == "cuda":
        torch.cuda.set_device(rank)
        cell = dataclasses.replace(cell, device=torch.device("cuda", rank))
    else:
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if cell.device.type == "cuda" else "gloo",
                            init_method=f"file://{tmp}/store", rank=rank,
                            world_size=world, timeout=TIMEOUT)
    if plant is not None:
        plant()
    try:
        out = target(rank, cell)
    finally:
        dist.destroy_process_group()
    torch.save({"out": out,
                "loaded": harness.forbidden_modules(sys.modules)},
               Path(tmp) / f"rank{rank}.pt")


def _rows(cell: harness.Cell, keep: float = 1.0):
    """This rank's rows of each checked batch (the first ``keep`` of
    them), as (tokens, labels)."""
    t = cell.traffic
    world, rank = dist.get_world_size(), dist.get_rank()
    per = t["batch"] // world
    n = max(1, int(per * keep))
    f = single.feed(cell)
    out = []
    for step in range(single.CHECKED_STEPS):
        b = f.global_batch_at(step)
        rows = slice(rank * per, rank * per + n)
        out.append((b["tokens"][rows], b["labels"][rows]))
    return out


def _sum(tensors: List[torch.Tensor]) -> None:
    for x in tensors:
        dist.all_reduce(x)


def reference(rank: int, cell: harness.Cell, spec, prec: str = "float32",
              keep: float = 1.0, exchange: bool = True) -> Dict:
    """The reference's readings (rank 0's), data-parallel over the
    ranks: ``keep`` of each rank's rows, the sums over the ranks left out
    when not ``exchange``."""
    t = cell.traffic
    params = weights.make(spec, cell.seed, cell.device)
    rows = t["batch"] * keep if exchange else \
        max(1, int(t["batch"] // dist.get_world_size() * keep))
    losses, grad = ref_train.steps(
        params, cell.model, _rows(cell, keep), t["optimizer"],
        t["schedule"], prec, rows_total=int(rows),
        reduce=_sum if exchange else None)
    change = weights.init_distance(params, spec, cell.seed) \
        if rank == 0 else {}
    del params
    harness.free(cell.device)
    return {"losses": losses, "grad": grad, "change": change}


def _program(cell: harness.Cell):
    from repro_torch import sharding as SH
    from repro_torch.config import MeshConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.axes import param_axes
    from repro_torch.tree import tree_map
    t = cell.traffic
    model, tcfg, spec = single._program(cell)
    tcfg = dataclasses.replace(tcfg, layout=t["layout"])
    mesh = make_mesh(MeshConfig(**t["mesh"]), device_type=cell.device.type)
    axes = param_axes(model.cfg)
    shardings = SH.param_shardings(axes, model.cfg, mesh, layout=t["layout"])
    mask = tree_map(lambda a: "experts" not in a, axes)
    return model, tcfg, spec, mesh, shardings, mask


def _rank_run(rank: int, cell: harness.Cell) -> Dict:
    from repro_torch import sharding as SH
    from repro_torch.train.step import init_state, make_train_step
    from repro_torch.tree import tree_leaves
    dev, t = cell.device, cell.traffic
    model, tcfg, spec, mesh, shardings, mask = _program(cell)
    flat = weights.make(spec, cell.seed, dev)
    state = init_state(model, tcfg, params=SH.shard_tree(
        weights.nest(flat), shardings))
    del flat
    harness.free(dev)
    step = make_train_step(model, tcfg, param_shardings=shardings,
                           zero1_mask=mask)
    feed = single.feed(cell)

    def one(state, i):
        with SH.use_mesh(mesh, t["layout"]):
            return step(state, feed.global_batch_at(i))

    losses, paces, grad = [], [], {}
    b1 = t["optimizer"]["beta1"]
    for i in range(single.CHECKED_STEPS):
        start = time.monotonic()
        state, m = one(state, i)
        losses.append(float(m["loss"]))
        harness.sync(dev)
        paces.append(time.monotonic() - start)
        if i == 0:
            grad = _block_norms(state.opt["m"], shardings, mesh, b1)
    full = SH.unshard_tree(state.params, shardings)
    change = (weights.init_distance(dict(tree_leaves(full)), spec,
                                    cell.seed) if rank == 0 else {})
    del full
    harness.free(dev)
    pace = torch.tensor([min(paces[1:] or paces)], device=dev)
    dist.all_reduce(pace, op=dist.ReduceOp.MAX)
    steps = max(1, round(cell.seconds / float(pace)))
    dist.barrier()
    window_start = time.monotonic()
    with devtrace.Window(cell.trace, dev) as win:
        for i in range(steps):
            state, _ = one(state, single.CHECKED_STEPS + i)
        harness.sync(dev)
        dist.barrier()
        window_s = time.monotonic() - window_start
    peak = harness.peak_bytes(dev)
    del state, step, model
    harness.free(dev)
    prog = {"losses": losses, "grad": grad, "change": change}
    harness.reset_peak(dev)
    ref = reference(rank, cell, spec)
    return {"steps": steps, "window_start": window_start,
            "window_s": window_s, "peak": peak,
            "check_peak": harness.peak_bytes(dev), "summary": win.summary,
            "numbers": harness.train_gaps(prog, ref) if rank == 0 else None,
            "finite": all(map(math.isfinite, losses))}


def _block_norms(tree, shardings, mesh, b1: float) -> Dict[str, float]:
    """Each leaf's norm over every rank's block, each block counted once,
    over 1 - ``b1``."""
    from repro_torch import sharding as SH
    from repro_torch.tree import tree_leaves
    specs = dict(tree_leaves(shardings))
    paths = [p for p, _ in tree_leaves(tree)]
    sq = torch.stack([
        torch.linalg.vector_norm(x.float()) ** 2
        / SH.replication(specs[p].spec, mesh)
        for p, x in tree_leaves(tree)])
    dist.all_reduce(sq)
    return {p: math.sqrt(float(v)) / (1 - b1) for p, v in zip(paths, sq)}


def run(cell: harness.Cell, plant=None) -> harness.Outcome:
    ranks = _spawn(_rank_run, cell, plant)
    r0, t = ranks[0], cell.traffic
    summary = r0["summary"]
    if summary is not None:
        summary = dataclasses.replace(summary, busy_s=statistics.mean(
            r["summary"].busy_s for r in ranks))
    numbers = r0["numbers"]
    cell.mark("check's peak a rank " + ", ".join(
        f"{r['check_peak'] / harness.GB:.2f}" for r in ranks) + " GB")
    return harness.Outcome(
        e2e={"train_tokens_per_s":
             r0["steps"] * t["batch"] * t["seq_len"] / r0["window_s"]},
        units=r0["steps"],
        unit_flops=3 * counts.fwd_flops(cell.model, t["batch"], t["seq_len"]),
        window_s=r0["window_s"], setup_s=r0["window_start"] - cell.t0,
        peak_bytes=max(r["peak"] for r in ranks),
        compare=lambda: numbers, summary=summary,
        failed=sum(not r["finite"] for r in ranks))


def _rank_control(rank: int, cell: harness.Cell) -> Dict:
    _, _, spec, *_ = _program(cell)
    ref = reference(rank, cell, spec)
    variants = {"fp8": dict(prec="fp8"), "half_batch": dict(keep=0.5),
                "no_exchange": dict(exchange=False)}
    out = {}
    for name, kw in variants.items():
        harness.reset_peak(cell.device)
        got = reference(rank, cell, spec, **kw)
        cell.mark(f"rank {rank}: {name}'s peak "
                  f"{harness.peak_bytes(cell.device) / harness.GB:.2f} GB")
        if rank == 0:
            out[name] = harness.train_gaps(got, ref)
    return out


def control(cell: harness.Cell) -> Dict[str, Dict[str, float]]:
    """The control's and the planted faults' gaps (rank 0's) from the
    float32 reference, each put in the program's place: ``fp8``,
    ``half_batch`` (half of each rank's rows) and ``no_exchange`` (no sum
    over the ranks: each rank's own rows alone)."""
    return _spawn(_rank_control, cell)[0]



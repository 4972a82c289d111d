"""One run of one cell: load the cell's files by name, run its mode,
judge what the timed path produced, read the cell's metrics and build the
result's line.

Everything that belongs to one configuration, traffic mix, mode or
metric sits in a file of its own, found by name:

- the cell (``workloads`` in ``BENCHMARK.json``) names its configuration
  and its traffic mix;
- ``configs/<config>.json``: the model's settings under ``model`` (the
  program's ``ModelConfig`` fields), its source, cuts and assumptions,
  and under ``tiny`` the ``model`` keys the CPU tests cut;
- ``traffic/<traffic>.json``: the ``mode`` and its parameters;
- ``modes/<mode>.py``: ``run(cell) -> Outcome``, set-up, window and the
  comparison with the reference;
- ``metrics/<metric>.py``: ``read(ctx) -> value or None``, one per
  per-layer metric;
- ``limits/<cell>.json``: the limit of each number the cell compares.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import statistics
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch

from bench_port import counts, devtrace

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
GB = 1e9


@dataclasses.dataclass
class Cell:
    """What a mode needs to run one cell."""
    name: str
    config: Dict                 # the file under configs/
    traffic: Dict                # the file under traffic/
    chips: int
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float                    # the run's start, on the monotonic clock

    @property
    def model(self) -> Dict:
        return self.config["model"]

    def mark(self, what: str) -> None:
        """Say on standard error how long the run has taken by ``what``."""
        print(f"{self.name}: {what} at {time.monotonic() - self.t0:.3f} s",
              file=sys.stderr)


@dataclasses.dataclass
class Outcome:
    """What a mode hands back after its window."""
    e2e: Dict[str, float]        # its end-to-end metrics, by name
    units: int                   # steps or forwards completed in the window
    unit_flops: float            # model FLOPs of one unit (all chips)
    window_s: float
    setup_s: float
    peak_bytes: int
    compare: Callable[[], Dict[str, float]]
    summary: Optional[devtrace.Summary] = None
    failed: int = 0


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def free(dev: torch.device) -> None:
    """Give back the memory of what was deleted."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def peak_bytes(dev: torch.device) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def reset_peak(dev: torch.device) -> None:
    """Start a new peak: the check's own, after ``peak_bytes`` of the
    program was read."""
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


class ForbiddenModules(RuntimeError):
    """A process of the run loaded JAX or the JAX package."""


def load_json(path: Path) -> Dict:
    return json.loads(path.read_text())


def benchmark() -> Dict:
    return load_json(CHECKOUT / "BENCHMARK.json")


def cell_entry(bench: Mapping, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                   f"{[w['name'] for w in bench['workloads']]}")


def cell_metrics(bench: Mapping, kind: str, cell: Mapping) -> List[Dict]:
    """The ``end_to_end`` or ``per_layer`` metrics ``cell`` reports: those
    that list it, and, among those with no list, the per-layer metrics
    whose end-to-end metric it reports and every end-to-end one."""
    e2e = {m["name"] for m in cell_metrics(bench, "end_to_end", cell)} \
        if kind == "per_layer" else set()
    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if cell["name"] in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "bench_port_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_cell(bench: Mapping, name: str, seed: int, seconds: float,
              trace: bool, device, t0: float, config: Optional[Dict] = None,
              traffic: Optional[Dict] = None) -> Cell:
    """The cell ``name`` of ``bench``; ``config`` and ``traffic`` replace
    its files (the tests' small sizes)."""
    entry = cell_entry(bench, name)
    traffic = traffic or load_json(ROOT / "traffic"
                                   / f"{entry['traffic']}.json")
    return Cell(name=name,
                config=config or load_json(
                    ROOT / "configs" / f"{entry['config']}.json"),
                traffic=traffic,
                chips=entry["chips"], seed=seed, seconds=seconds,
                trace=trace, device=torch.device(device), t0=t0)


def mode_of(cell: Cell):
    """The module of the cell's mode, ``modes/<mode>.py``."""
    return importlib.import_module(f"bench_port.modes.{cell.traffic['mode']}")


def run_mode(cell: Cell) -> Outcome:
    return mode_of(cell).run(cell)


def limits(cell_name: str) -> Dict[str, float]:
    path = ROOT / "limits" / f"{cell_name}.json"
    return load_json(path)["limits"] if path.exists() else {}


def judge(numbers: Mapping[str, float], lim: Mapping[str, float]
          ) -> Tuple[bool, Dict[str, Dict]]:
    """(correct, {name: {value, limit}}): every number finite and at or
    under its limit; a number with no limit is not correct."""
    checks, ok = {}, True
    for k, v in numbers.items():
        limit = lim.get(k)
        checks[k] = {"value": v, "limit": limit}
        if limit is None or not math.isfinite(v) or v > limit:
            ok = False
    return ok and bool(numbers), checks


@dataclasses.dataclass
class Ctx:
    """What a per-layer metric's reader gets."""
    summary: devtrace.Summary
    units: int
    unit_flops: float
    window_s: float
    chips: int
    model: Dict
    traffic: Dict
    counts = counts


def read_metrics(entries: List[Dict], ctx: Ctx) -> Dict[str, Dict]:
    out = {}
    for m in entries:
        value = load_module(ROOT / "metrics" / f"{m['name']}.py").read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(bench: Mapping, name: str, seed: int, seconds: float,
             trace: bool, device="cuda", t0: Optional[float] = None,
             config: Optional[Dict] = None,
             traffic: Optional[Dict] = None) -> Dict:
    """Run the cell and return its result line (a dict)."""
    t0 = time.monotonic() if t0 is None else t0
    cell = make_cell(bench, name, seed, seconds, trace, device, t0, config,
                     traffic)
    out = run_mode(cell)
    numbers = out.compare()
    cell.mark("compared")
    correct, checks = judge(numbers, limits(name))
    entry = cell_entry(bench, name)
    if trace:
        ctx = Ctx(summary=out.summary, units=out.units,
                  unit_flops=out.unit_flops, window_s=out.window_s,
                  chips=cell.chips, model=cell.model, traffic=cell.traffic)
        metrics = read_metrics(cell_metrics(bench, "per_layer", entry), ctx)
    else:
        values = dict(out.e2e, setup_s=out.setup_s,
                      peak_mem_gb=out.peak_bytes / GB)
        metrics = {}
        for m in cell_metrics(bench, "end_to_end", entry):
            if m["name"] not in values:
                raise KeyError(f"mode {cell.traffic['mode']!r} gives no "
                               f"{m['name']!r}")
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    dev = cell.device
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": cell.chips, "memory_peak_bytes": out.peak_bytes}
    line = {"correct": correct, "attempted": out.units,
            "failed": out.failed, "metrics": metrics,
            "device": device_info}
    if trace:
        device_info["busy_s"] = out.summary.busy_s
        device_info["window_s"] = out.summary.window_s
        line["breakdown"] = out.summary.breakdown()
    line["checks"] = checks
    return line


def rel_gap(prog: Mapping[str, float], ref: Mapping[str, float],
            keys) -> float:
    """The worst leaf's gap between two norms, |p - r|, against the
    larger of the reference's norm of that leaf and of the median leaf."""
    keys = list(keys)
    med = statistics.median(ref[k] for k in keys)
    return worst(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys)


def worst(values) -> float:
    """The largest of ``values``; infinity if any is not finite."""
    values = list(values)
    if not all(math.isfinite(v) for v in values):
        return math.inf
    return max(values)


def train_gaps(prog: Mapping, ref: Mapping) -> Dict[str, float]:
    """The numbers a training cell compares (``losses``, ``grad`` and
    ``change`` of each side): the largest gap of a step's loss; the worst
    leaf's gap of the first step's clipped gradient norm; the worst
    leaf's gap of its change over the checked steps, among the leaves
    whose reference gradient is at least a thousandth of the median
    leaf's (a smaller one moves by round-off under Adam)."""
    loss_gap = worst(abs(a - b) for a, b in zip(prog["losses"],
                                                 ref["losses"]))
    keys = list(ref["grad"])
    med = statistics.median(ref["grad"].values())
    moved = [k for k in keys if ref["grad"][k] >= 1e-3 * med]
    return {"loss_gap": loss_gap,
            "grad_gap": rel_gap(prog["grad"], ref["grad"], keys),
            "change_gap": rel_gap(prog["change"], ref["change"], moved)}


def logits_gap(prog: torch.Tensor, ref: torch.Tensor,
               block: int = 1024) -> float:
    """The worst position's relative gap of logits (S, V): the L2 norm of
    (program - reference) over the vocabulary against that of the
    reference's logits about their mean."""
    top = 0.0
    for i in range(0, ref.shape[0], block):
        p, r = prog[i:i + block].float(), ref[i:i + block]
        num = torch.linalg.vector_norm(p - r, dim=-1)
        den = torch.linalg.vector_norm(r - r.mean(-1, keepdim=True), dim=-1)
        gap = float(torch.nan_to_num(num / den, nan=math.inf).max())
        top = worst([top, gap])
    return top


def forbidden_modules(modules) -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)

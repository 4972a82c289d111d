#!/usr/bin/env python3
"""The program's spans in one traced window of a benchmark cell, and what
an annotation costs.

    python3 tools/span_figures.py --workload <cell> --seed <n> --seconds <s> \
        [--out FILE]
    python3 tools/span_figures.py --cost [--calls N]

The first form runs the cell's mode as ``bench_port/run.py --trace 1``
does (same set-up, same window), with ``bench_port/spans.attach()`` in
every process that traces (on 4 cards rank 0's figures, as the cell's
metrics read them), and skips the check against the reference. It prints
one JSON line: each span's instances, host seconds, device seconds and
idle seconds a unit; the phases' sum against the busy time a unit; the
attention core's share of the forward phase; idle by the set of spans
open at the launch that ended it; the readings of ``spans.READERS`` and
of the cell's own per-layer metrics from the same window; the
breakdown. ``--out`` also writes it, indented, to ``FILE``.

``--cost`` times ``annotate_span`` with no profiler running, beside
``torch.profiler.record_function`` and the ``ExitStack`` form that
``annotate_span`` had before it checked the profiler's state, and
``annotate_span`` under a running CPU profiler: microseconds a call, the
best of five rounds of ``--calls`` calls.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

from bench_port import harness, spans  # noqa: E402


def _key(names) -> str:
    return "+".join(sorted(names)) or "outside every span"


def figures(summary, units: int, window_s: float, ctx) -> dict:
    sp = summary.spans
    per = {n: {"instances": sp.instances.get(n, 0),
               "host_s": sp.host_s.get(n, 0.0),
               "device_ms_a_unit": 1e3 * sp.device(n) / units,
               "idle_ms_a_unit": 1e3 * sp.idle(n) / units}
           for n in spans.NAMES}
    phases = sum(sp.device(n) for n in (spans.TRAIN_FORWARD,
                                        spans.TRAIN_BACKWARD,
                                        spans.TRAIN_OPTIMIZER))
    fwd = sp.device(spans.TRAIN_FORWARD)
    busy = sum(sp.device_s.values())
    return {
        "units": units, "window_s": window_s,
        "window_s_a_unit": window_s / units,
        "busy_ms_a_unit": 1e3 * summary.busy_s / units,
        "device_ms_a_unit": 1e3 * busy / units,
        "spans": per,
        "phases_over_device": phases / busy if busy else None,
        "attn_core_share_of_forward": (
            sp.device(spans.ATTN_CORE, spans.TRAIN_FORWARD) / fwd
            if fwd else None),
        "idle_s_by_open_spans": {_key(k): v for k, v in sorted(
            sp.idle_s.items(), key=lambda kv: -kv[1])},
        "device_s_by_open_spans": {_key(k): v for k, v in sorted(
            sp.device_s.items(), key=lambda kv: -kv[1])},
        "span_metrics": {name: read(ctx)
                         for name, read in spans.READERS.items()},
        "breakdown": summary.breakdown(),
    }


def run(name: str, seed: int, seconds: float, device: str = "cuda",
        config=None, traffic=None) -> dict:
    """The figures of one traced window of cell ``name`` (``config`` and
    ``traffic`` replace its files, as ``harness.make_cell`` takes them)."""
    bench = harness.benchmark()
    cell = harness.make_cell(bench, name, seed, seconds, True, device,
                             time.monotonic(), config, traffic)
    spans.attach()
    if cell.traffic["mode"] == "train_sharded":
        from bench_port.modes import train_sharded
        r0 = train_sharded._spawn(train_sharded._rank_run, cell,
                                  spans.attach)[0]
        summary, units, window_s = r0["summary"], r0["steps"], r0["window_s"]
    else:
        out = harness.run_mode(cell)
        summary, units, window_s = out.summary, out.units, out.window_s
    t = cell.traffic
    per = 3 if cell.traffic["mode"].startswith("train") else 1
    ctx = harness.Ctx(summary=summary, units=units,
                      unit_flops=per * harness.counts.fwd_flops(
                          cell.model, t["batch"], t["seq_len"]),
                      window_s=window_s, chips=cell.chips, model=cell.model,
                      traffic=t)
    line = {"workload": name, "seed": seed,
            "device": (torch.cuda.get_device_name(0)
                       if cell.device.type == "cuda" else "cpu"),
            "cell_metrics": {k: v["value"] for k, v in harness.read_metrics(
                harness.cell_metrics(bench, "per_layer",
                                     harness.cell_entry(bench, name)),
                ctx).items()}}
    line.update(figures(summary, units, window_s, ctx))
    return line


@contextlib.contextmanager
def _exit_stack_form(name: str):
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_initialized():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield


def _us(ctx_of, calls: int) -> float:
    best = float("inf")
    for _ in range(5):
        t = time.perf_counter()
        for _ in range(calls):
            with ctx_of("x"):
                pass
        best = min(best, time.perf_counter() - t)
    return 1e6 * best / calls


def cost(calls: int) -> dict:
    from repro_torch.obs.profiling import annotate_span
    if torch.cuda.is_available():
        torch.zeros(1, device="cuda")              # CUDA initialised
    out = {"calls": calls,
           "annotate_span_off_us": _us(annotate_span, calls),
           "record_function_off_us": _us(torch.profiler.record_function,
                                         calls),
           "exit_stack_form_off_us": _us(_exit_stack_form, calls)}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out["annotate_span_on_us"] = _us(annotate_span, calls // 10)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--cost", action="store_true")
    ap.add_argument("--calls", type=int, default=100_000)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if args.cost:
        line = cost(args.calls)
    else:
        line = run(args.workload, args.seed, args.seconds)
        if args.out:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text(json.dumps(line, indent=1))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

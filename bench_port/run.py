"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 bench_port/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout. It loads the cell's configuration and
traffic, sets up the program (``src/repro_torch``) on the card, measures
for ``--seconds``, checks what the timed path produced against the plain
reference under ``bench_port/reference/``, and prints one JSON line as
the last line of its standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device`` (with ``busy_s`` and
``window_s`` when traced), ``breakdown`` when traced, and last
``checks``, each compared number beside its limit, which also end its
standard error. It exits non-zero and prints no result where there is
no CUDA card, fewer cards than the cell asks for, no program beside it,
or, once the window has closed, a module of JAX or of the JAX package
loaded in the process or in any rank's process it started.
"""
from __future__ import annotations

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]
CACHE = CHECKOUT / "build" / "bench_port"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not (CHECKOUT / "src" / "repro_torch").is_dir():
        print(f"no program at {CHECKOUT / 'src' / 'repro_torch'}",
              file=sys.stderr)
        return 2
    # the program's kernel caches stay in the checkout, at fixed paths
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)
    sys.path[:0] = [str(CHECKOUT / "src"), str(CHECKOUT)]
    import torch
    from bench_port import harness

    bench = harness.benchmark()
    chips = harness.cell_entry(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 3
    try:
        line = harness.run_cell(bench, args.workload, args.seed,
                                args.seconds, bool(args.trace), "cuda", T0)
    except harness.ForbiddenModules as e:
        print(f"loaded in a rank's process: {e}", file=sys.stderr)
        return 4
    found = harness.forbidden_modules(sys.modules)
    if found:
        print(f"loaded in this process: {found}", file=sys.stderr)
        return 4
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

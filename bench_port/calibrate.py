"""The readings that a cell's limits are set from, in one process:

    python3 bench_port/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 1] [--out FILE]

For each of ``--seeds`` a run of the cell (a short window) and the
numbers it compared with the reference: the lower readings. For each of
``--control-seeds`` the mode's ``control``: the same numbers with the
reference at the precision below the configuration's put in the
program's place, and, for training, planted faults: the upper readings.
One JSON object a line, on standard output and in ``--out``. The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(CHECKOUT / "src"), str(CHECKOUT)]
    from bench_port import harness

    bench = harness.benchmark()
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        text = json.dumps(rec)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()

    for seed in filter(None, args.seeds.split(",")):
        t = time.monotonic()
        line = harness.run_cell(bench, args.workload, int(seed),
                                args.seconds, False, "cuda")
        emit({"kind": "program", "seed": int(seed),
              "numbers": {k: c["value"] for k, c in line["checks"].items()},
              "metrics": line["metrics"], "s": time.monotonic() - t})
    for seed in filter(None, args.control_seeds.split(",")):
        t = time.monotonic()
        cell = harness.make_cell(bench, args.workload, int(seed), 0, False,
                                 "cuda", t)
        for variant, numbers in harness.mode_of(cell).control(cell).items():
            emit({"kind": variant, "seed": int(seed), "numbers": numbers,
                  "s": time.monotonic() - t})
    return 0


if __name__ == "__main__":
    sys.exit(main())

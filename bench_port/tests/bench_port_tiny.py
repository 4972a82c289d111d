"""Small sizes of the benchmark's cells for the CPU tests: the cells'
own files with the widths and lengths cut, and the program's dtype
float32, so that it agrees with the float32 reference to round-off and a
planted fault stands out (the tests only). Each configuration's file
holds its cut sizes under ``tiny``: the ``model`` keys they replace."""
from __future__ import annotations

import copy

from bench_port import harness

SEED = 2 ** 31 + 12345


def cells():
    return [w["name"] for w in harness.benchmark()["workloads"]]


def files(name: str):
    """(config, traffic) of cell ``name`` at the tests' size."""
    w = harness.cell_entry(harness.benchmark(), name)
    cfg = copy.deepcopy(harness.load_json(
        harness.ROOT / "configs" / f"{w['config']}.json"))
    cfg["model"].update(cfg["tiny"], dtype="float32")
    tr = harness.load_json(harness.ROOT / "traffic" / f"{w['traffic']}.json")
    return cfg, dict(tr, batch=2 * w["chips"], seq_len=64)


def run(name: str, trace: bool = False, seed: int = SEED) -> dict:
    cfg, tr = files(name)
    return harness.run_cell(harness.benchmark(), name, seed, 0.2, trace,
                            "cpu", config=cfg, traffic=tr)

"""The result's line has the contract's keys, in order, and the cell's
metrics."""
import json
import math

import pytest

from bench_port import harness

import bench_port_tiny as tiny

BENCH = harness.benchmark()


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", tiny.cells())
def test_line_keys(name, trace):
    line = json.loads(json.dumps(tiny.run(name, trace=trace)))
    want = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == want + (["breakdown"] if trace else []) \
        + ["checks"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(line["device"])
    entry = harness.cell_entry(BENCH, name)
    kind = "per_layer" if trace else "end_to_end"
    allowed = {m["name"] for m in harness.cell_metrics(BENCH, kind, entry)}
    assert set(line["metrics"]) <= allowed
    if not trace:
        assert set(line["metrics"]) == allowed
    else:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in line["breakdown"].values())
    for m in line["metrics"].values():
        assert math.isfinite(m["value"]) and m["unit"]
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    assert line["attempted"] >= 1

"""On the card: each cell's traced run at a short window is correct and
reads every per-layer metric it lists (``-m gpu``; skips without a
card)."""
import json
import subprocess
import sys

import pytest

from bench_port import harness

BENCH = harness.benchmark()


@pytest.fixture
def cards():
    """The number of CUDA cards; skips without one."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.device_count()


@pytest.mark.gpu
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_on_the_card(cards, name):
    chips = harness.cell_entry(BENCH, name)["chips"]
    if cards < chips:
        pytest.skip(f"needs {chips} cards")
    out = subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload", name, "--seed",
         str(2 ** 31 + 99), "--seconds", "3", "--trace", "1"],
        capture_output=True, text=True, timeout=1200, cwd=harness.CHECKOUT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    want = {m["name"] for m in harness.cell_metrics(
        BENCH, "per_layer", harness.cell_entry(BENCH, name))}
    assert set(line["metrics"]) == want
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]

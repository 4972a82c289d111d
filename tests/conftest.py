# Tests run on the single real CPU device — no XLA_FLAGS here (the 512
# placeholder devices are exclusively the dry-run entry point's business).
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
# benchmarks/ is imported by the golden-file tests; make it importable no
# matter which directory pytest was launched from
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips itself without one (run "
                   "on the card with -m gpu)")


def pytest_addoption(parser):
    parser.addoption(
        "--update-goldens", action="store_true", default=False,
        help="rewrite tests/goldens/*.json from current benchmark stats "
             "(see tests/test_goldens.py)")
    parser.addoption(
        "--update-bench-baseline", action="store_true", default=False,
        help="rewrite bench/BENCH_*.json perf baselines from a fresh smoke "
             "run (see tests/test_bench_trajectory.py)")

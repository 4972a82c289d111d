import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]
for p in (CHECKOUT / "src", CHECKOUT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips itself without one (run "
                   "on the card with -m gpu)")

"""The PyTorch port stands alone: every module of ``repro_torch`` and the
chip smoke script import with ``jax`` and the JAX package ``repro``
blocked, and importing them runs nothing (no build, no card needed)."""
import functools
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

PROBE = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None            # any import of them now fails
sys.path[:0] = [{src!r}, {root!r}]
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro")
                and sys.modules[m] is not None)
assert not leaked, leaked
print(" ".join(names))
print(len(names))
"""


@functools.lru_cache(maxsize=None)
def probe():
    code = PROBE.format(src=os.path.join(ROOT, "src"), root=ROOT)
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)


def test_port_imports_without_jax_or_repro():
    out = probe()
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20      # every module was seen


@pytest.mark.parametrize("module", [
    "repro_torch.traces", "repro_torch.traces.schema",
    "repro_torch.traces.synth", "repro_torch.traces.replay",
    "repro_torch.obs", "repro_torch.obs.events", "repro_torch.obs.metrics",
    "repro_torch.gym", "repro_torch.gym.gym", "repro_torch.gym.validate",
    "repro_torch.core.staleness", "repro_torch.core.simulator",
    "repro_torch.core.mc", "repro_torch.core.policy",
    "repro_torch.core.cost", "repro_torch.core.scheduler",
    "repro_torch.optim.compression"])
def test_planning_and_gym_modules_import_without_jax_or_repro(module):
    """The trace, obs and gym subpackages and the planning modules are
    among the modules imported with jax and ``repro`` blocked."""
    out = probe()
    assert out.returncode == 0, out.stderr
    assert module in out.stdout.split("\n")[-3].split()


def test_no_kernel_is_built_at_import():
    """Importing the kernel modules must not need nvcc: the build runs at
    the first launch on a CUDA tensor."""
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import kernel  # noqa: F401
    from repro_torch.kernels.rwkv6 import kernel as _  # noqa: F401,F811
    from repro_torch.kernels.ssd_scan import kernel as _  # noqa: F401,F811
    for name in ("decode_attention", "ssd_scan", "rwkv6"):
        assert name not in build._LOADED

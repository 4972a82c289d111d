"""Nothing the benchmark runs loads JAX or the JAX package, the reference
imports nothing of the program, and the command refuses to run without
a card or without the program."""
import ast
import os
import shutil
import subprocess
import sys
import time
import types

import pytest

from bench_port import harness

import bench_port_tiny as tiny

CHECKOUT = harness.CHECKOUT
YARDSTICK = ["counts.py", "weights.py", "traffic.py", "devtrace.py"]


def imported_tops(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_reference_imports_nothing_of_the_program():
    files = list((harness.ROOT / "reference").glob("*.py")) + \
        [harness.ROOT / f for f in YARDSTICK]
    for path in files:
        tops = imported_tops(path)
        assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}, \
            (path, tops)


def test_no_jax_loaded_by_a_run():
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(CHECKOUT / 'src')!r}, {str(CHECKOUT)!r},"
        f" {str(harness.ROOT / 'tests')!r}]\n"
        "import bench_port_tiny as tiny\n"
        "from bench_port import harness\n"
        "for name in tiny.cells():\n"
        "    tiny.run(name)\n"
        "print(json.dumps([harness.forbidden_modules(sys.modules),"
        " 'repro_torch' in sys.modules]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=CHECKOUT,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    # a cell of several ranks raises harness.ForbiddenModules when a
    # rank's own process loaded one (the next test), so a run that ends
    # has found none in any rank either
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[[], true]"


def load_jax():
    """Planted in each rank: a module named ``jax`` in its process."""
    sys.modules["jax"] = types.ModuleType("jax")


def test_jax_loaded_in_a_rank_is_refused():
    bench = harness.benchmark()
    name = next(c for c in tiny.cells() if tiny.files(c)[1]["mode"]
                == "train_sharded")
    cfg, tr = tiny.files(name)
    cell = harness.make_cell(bench, name, tiny.SEED, 0.2, False, "cpu",
                             time.monotonic(), cfg, tr)
    with pytest.raises(harness.ForbiddenModules,
                       match=r"rank 0: \['jax'\]"):
        harness.mode_of(cell).run(cell, plant=load_jax)


def test_forbidden_names_are_whole_top_levels():
    assert harness.forbidden_modules(
        ["repro_torch", "repro_torch.models", "jaxtyping", "bench_port"]) == []
    assert harness.forbidden_modules(["jax.numpy", "repro.config", "flax"]) \
        == ["flax", "jax.numpy", "repro.config"]


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload",
         harness.benchmark()["workloads"][0]["name"], "--seed", "1",
         "--seconds", "1", "--trace", "0", *extra],
        capture_output=True, text=True, timeout=300, cwd=cwd,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})


def test_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        return
    out = _run(CHECKOUT)
    assert out.returncode != 0 and out.stdout == ""


def test_refuses_without_the_program(tmp_path):
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.ROOT, tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""

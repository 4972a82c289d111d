"""The port's hill-climb (``repro_torch.launch.hillclimb``).

Its ``CELLS`` are the reference's: the same cells, archs, shapes,
variant names and knobs, read from the reference's source with ``ast``
(importing it would set ``XLA_FLAGS`` in this process). Its hypotheses
carry no measured figure. And ``run_cell`` runs a cell's variants on fake
process groups, one per world size (a subprocess, since a fake group is
process-global), writing one row a variant, or its error.
"""
import ast
import json
import os
import re
import subprocess
import sys
import tempfile

import pytest

pytest.importorskip("torch")

from repro_torch.config import (OptimizerConfig, TrainConfig,  # noqa: E402
                                get_config)
from repro_torch.launch import hillclimb  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
REF = os.path.join(ROOT, "src", "repro", "launch", "hillclimb.py")


def _value(node):
    """A knob of the reference's ``CELLS`` as the port's object: the
    literals as they are, ``get_config(a).replace(**kw)`` and
    ``tc(**kw)`` built with the port's config classes."""
    if isinstance(node, ast.Call):
        kw = {k.arg: _value(k.value) for k in node.keywords}
        func = node.func
        if isinstance(func, ast.Name) and func.id == "tc":
            return TrainConfig(optimizer=OptimizerConfig(name="adamw"), **kw)
        if isinstance(func, ast.Name) and func.id == "get_config":
            return get_config(*[_value(a) for a in node.args])
        if isinstance(func, ast.Attribute) and func.attr == "replace":
            return _value(func.value).replace(**kw)
        raise ValueError(ast.dump(node))
    if isinstance(node, ast.Dict):
        return {_value(k): _value(v) for k, v in zip(node.keys, node.values)}
    if isinstance(node, (ast.Tuple, ast.List)):
        seq = [_value(e) for e in node.elts]
        return tuple(seq) if isinstance(node, ast.Tuple) else seq
    return ast.literal_eval(node)


def _reference_cells():
    tree = ast.parse(open(REF).read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", None) == "CELLS":
            return _value(node.value)
    raise AssertionError("no CELLS in the reference's hillclimb.py")


def test_cells_are_the_references():
    ref = _reference_cells()
    port = hillclimb.CELLS
    assert list(port) == list(ref)
    for key in ref:
        arch, shape, variants = ref[key]
        parch, pshape, pvariants = port[key]
        assert (parch, pshape) == (arch, shape)
        assert [v[0] for v in pvariants] == [v[0] for v in variants]
        for (name, _, kw), (_, _, pkw) in zip(variants, pvariants):
            assert pkw == kw, (key, name)


def test_hypotheses_carry_no_measured_figure():
    """The reference's hypotheses quote times and sizes from its own
    runs; the port's keep the claims without them."""
    unit = re.compile(r"\d\s*(ms|[KMGT]B)\b")
    for arch, shape, variants in hillclimb.CELLS.values():
        for name, hypothesis, _ in variants:
            assert not unit.search(hypothesis), (arch, name, hypothesis)


SCRIPT = """
import sys
sys.path[:0] = [{src!r}]
from repro_torch.config import get_config
from repro_torch.launch import hillclimb as H
H.CELLS = {{"T": ("starcoder2-3b", "decode_32k", [
    ("small", "a reduced model on a 2 x 2 mesh",
     {{"cfg_override": get_config("starcoder2-3b", reduced=True),
       "serve_fsdp": False, "mesh_shape": (2, 2)}}),
    ("refused", "a layout the port does not have",
     {{"cfg_override": get_config("starcoder2-3b", reduced=True),
       "tcfg_override": H.tc(layout="nonsense"), "mesh_shape": (1, 2)}}),
    ("small-fsdp", "the same with FSDP weights",
     {{"cfg_override": get_config("starcoder2-3b", reduced=True),
       "mesh_shape": (2, 2)}}),
])}}
H.run_cell("T", {out!r})
"""


def test_run_cell_writes_a_row_a_variant():
    """Three variants over two world sizes (4 and 2 fake ranks): the
    rows come in the cell's order, with the reference's keys and
    ``run_s``; the variant with an unknown layout records its error."""
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [sys.executable, "-c", SCRIPT.format(
                src=os.path.join(ROOT, "src"), out=tmp)],
            capture_output=True, text=True, timeout=120, cwd=ROOT)
        assert proc.returncode == 0, proc.stderr[-3000:]
        rows = json.load(open(os.path.join(
            tmp, "cell_T_starcoder2-3b_decode_32k.json")))
    assert [r["variant"] for r in rows] == ["small", "refused", "small-fsdp"]
    assert "nonsense" in rows[1]["error"]
    for r in (rows[0], rows[2]):
        assert r["compile_s"] is None and r["run_s"] > 0
        assert r["bound"] in ("compute", "memory", "collective")
        assert set(r) >= {"t_compute_ms", "t_memory_ms", "t_collective_ms",
                          "useful", "roofline_fraction", "wire_GB",
                          "collectives", "memory_breakdown"}
    # FSDP weights are gathered a token: more wire than TP-resident ones
    assert rows[2]["wire_GB"] > rows[0]["wire_GB"]

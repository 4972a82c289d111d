"""Every cell's files load by name, and BENCHMARK.json keeps the
contract's names, units and keys."""
import json
import re

import pytest

from bench_port import harness

import bench_port_tiny as tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|projection|head|"
                    r"expan|_dim$|_rank$|d_model|d_ff|_ff$|per_tok|top_k|"
                    r"shared_experts)")


def cuts_only(reduced) -> bool:
    """``reduced`` lists cuts (depth, experts held, a vocabulary slice),
    never a width, a head size, an expansion or the experts a token
    takes."""
    return not any(WIDTHS.search(k) for k in reduced)


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_port"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert (harness.CHECKOUT / "BENCHMARK.json").stat().st_size < 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200
            assert "\n" not in entry[key] and "\t" not in entry[key]


def test_names_are_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_load_by_name(name):
    w = harness.cell_entry(BENCH, name)
    assert name == f"{w['config']}.{w['traffic']}"
    cfg = harness.load_json(harness.ROOT / "configs" / f"{w['config']}.json")
    conf = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert conf["file"] == f"bench_port/configs/{w['config']}.json"
    assert cfg["reduced"] == conf["reduced"]
    assert cuts_only(conf["reduced"])
    tr = harness.load_json(harness.ROOT / "traffic" / f"{w['traffic']}.json")
    assert (harness.ROOT / "modes" / f"{tr['mode']}.py").exists()
    assert w["chips"] in (1, 4)
    lim = harness.limits(name)
    assert lim and all(v > 0 for v in lim.values())
    e2e = harness.cell_metrics(BENCH, "end_to_end", w)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    layer = harness.cell_metrics(BENCH, "per_layer", w)
    assert layer
    for m in layer:
        assert m["moves"] in names
        mod = harness.load_module(harness.ROOT / "metrics"
                                  / f"{m['name']}.py")
        assert callable(mod.read)


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert next(m for m in BENCH["end_to_end"]
                if m["name"] == "setup_s")["bound"] <= 0.25


def test_layers_share_one_name():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert by_layer["device_idle"] == {"device"}


def test_roofline_symbols():
    for name, syms in (("flash_roofline.forward",
                        ("flash_fwd_wgmma", "flash_fwd_bf16")),
                       ("ssd_roofline.forward",
                        ("ssd_scan_tc_kernel", "ssd_scan_kernel"))):
        mod = harness.load_module(harness.ROOT / "metrics" / f"{name}.py")
        assert mod.SYMBOLS == syms


def test_json_files_parse():
    for path in harness.ROOT.rglob("*.json"):
        json.loads(path.read_text())


@pytest.mark.parametrize("reduced,ok", [
    ([], True), (["num_layers"], True), (["num_layers", "num_experts"], True),
    (["vocab_size"], True), (["d_ff"], False),
    (["num_layers", "d_model"], False),
    (["head_dim"], False), (["ssm_state"], False), (["ssm_expand"], False),
    (["kv_lora_rank"], False), (["top_k"], False), (["dense_ff"], False),
    (["num_shared_experts"], False), (["num_experts_per_tok"], False)])
def test_reduced_lists_cuts_not_widths(reduced, ok):
    assert cuts_only(reduced) is ok


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_holds_its_tiny_sizes(conf):
    """Each configuration's file holds the CPU tests' sizes under
    ``tiny``, keys of its ``model``, and the tests take them from there."""
    cfg = harness.load_json(harness.CHECKOUT / conf["file"])
    assert cfg["tiny"] and set(cfg["tiny"]) <= set(cfg["model"])
    for name in (w["name"] for w in BENCH["workloads"]
                 if w["config"] == conf["name"]):
        got, _ = tiny.files(name)
        assert got["model"] == dict(cfg["model"], **cfg["tiny"],
                                    dtype="float32")
        assert got["tiny"] == cfg["tiny"]

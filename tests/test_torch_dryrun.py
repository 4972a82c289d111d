"""The port's dry-run (``repro_torch.launch.dryrun``) on small fake
worlds, and once at production size.

A fake process group is process-global, so every dry-run here runs in a
subprocess: 8 fake ranks on the meshes (data 2, model 4) and (pod 2,
data 2, model 2) through ``mesh_override``, reduced configs of the
dense, moe (a2a and ep), hybrid, ssm, vlm and encdec families at small
train, prefill and decode shapes. Each cell is held to three things:

- its rank-0 ``counted_flops``: a ``zero1`` cell gathers the whole
  compute copy once a step, so its count equals ``FlopCounterMode``'s
  count of the real unsharded step on the same rows, on real CPU tensors
  with the same weights, and its collectives the closed form (an
  all-gather per sharded dim of each leaf at the compute dtype, a
  reduce-scatter per all-gather at the gradient dtype, the all-reduces
  of the axes a spec does not name, the metrics' and the norm's). The
  ``tp`` and ``fsdp`` cells gather per use and ``tp`` computes the model
  dims split; they, and the MoE routes (ep, a2a), which run expert
  blocks, are held to the same sharded program run on real CPU tensors,
  counts and collectives alike (the fake group's collectives move
  nothing; no count reads a value). An ``fsdp`` cell computes whole
  layers, so its count also equals the unsharded one; a ``tp`` cell's is
  below it (``test_torch_tensor_parallel.py`` holds the sharded
  programs' values to the unsharded ones and their collectives to a
  closed form);
- its artifact's analytic fields (FLOPs, HBM bytes and their breakdown,
  model FLOPs) equal the reference's ``analytic`` for that cell, with the
  port's ``"torch"`` attention as the reference's ``"xla"``.

The rwkv6 cells run the dry-run's WKV stand-in (``wkv_counted``) where
the unsharded step runs the plain loop, so their counts hold the
stand-in to the loop; a test also holds it to the loop op by op. Plus
each cell's ``faithful`` / ``unfaithful_because`` keys, the refusal of
a process group of another size, and one production cell:
starcoder2-3b train_4k on 256 fake ranks through
``python -m repro_torch.launch.dryrun``.
"""
import collections
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile

import pytest

torch = pytest.importorskip("torch")

from repro_torch import sharding as S  # noqa: E402
from repro_torch.config import (MeshConfig, OptimizerConfig,  # noqa: E402
                                ShapeConfig, TrainConfig, get_config)
from repro_torch.data.pipeline import make_batch  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import modality  # noqa: E402
from repro_torch.models.axes import param_axes, param_shapes  # noqa: E402
from repro_torch.models.builder import build_model  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
MESHES = {"2x4": MeshConfig(data=2, model=4),
          "2x2x2": MeshConfig(pods=2, data=2, model=2)}
TRAIN = ShapeConfig("train_4k", "train", 32, 8)
PREFILL = ShapeConfig("prefill_32k", "prefill", 64, 8)
DECODE = ShapeConfig("decode_32k", "decode", 64, 8)
LONG = ShapeConfig("long_500k", "decode", 128, 1)
# (arch, moe_impl, shape, layout, grad_dtype, serve_fsdp, serve dtype)
CELLS = [
    ("starcoder2-3b", None, TRAIN, "tp", "float32", True, None),
    ("starcoder2-3b", None, TRAIN, "fsdp", "float32", True, None),
    ("starcoder2-3b", None, TRAIN, "zero1", "bfloat16", True, None),
    ("starcoder2-3b", None, PREFILL, "tp", "float32", True, None),
    ("starcoder2-3b", None, DECODE, "tp", "float32", True, None),
    ("starcoder2-3b", None, LONG, "tp", "float32", False, "bfloat16"),
    ("moonshot-v1-16b-a3b", "a2a", TRAIN, "zero1", "float32", True, None),
    ("moonshot-v1-16b-a3b", "ep", TRAIN, "tp", "bfloat16", True, None),
    ("moonshot-v1-16b-a3b", "ep", PREFILL, "tp", "float32", False, None),
    ("moonshot-v1-16b-a3b", None, DECODE, "tp", "float32", True, None),
    ("zamba2-1.2b", None, TRAIN, "fsdp", "float32", True, None),
    ("zamba2-1.2b", None, LONG, "tp", "float32", True, None),
    ("rwkv6-7b", None, TRAIN, "tp", "float32", True, None),
    ("rwkv6-7b", None, LONG, "tp", "float32", True, None),
    ("qwen2-vl-7b", None, TRAIN, "tp", "float32", True, None),
    ("qwen2-vl-7b", None, PREFILL, "fsdp", "float32", True, None),
    ("seamless-m4t-large-v2", None, TRAIN, "zero1", "float32", True, None),
    ("seamless-m4t-large-v2", None, DECODE, "tp", "float32", True, None),
]
IDS = [f"{a}-{m or 'rows'}-{s.kind}{'-long' if s is LONG else ''}-{lay}"
       for a, m, s, lay, *_ in CELLS]


def _cfg(arch, moe_impl):
    cfg = get_config(arch, reduced=True)
    return cfg.replace(moe_impl=moe_impl) if moe_impl else cfg


def _tcfg(layout, grad_dtype):
    return TrainConfig(optimizer=OptimizerConfig(name="adamw"),
                       layout=layout, grad_dtype=grad_dtype)


def _cells_main(mname, out_path):
    """Every cell on mesh ``mname`` in an 8-rank fake group (run in a
    subprocess)."""
    from repro_torch.launch.mesh import make_mesh
    res = {}
    mcfg = MESHES[mname]
    with dryrun.fake_world(mcfg.num_devices):
        mesh = make_mesh(mcfg, device_type="cpu")
        for cid, (arch, moe, shape, layout, gd, sf, sdt) in zip(IDS, CELLS):
            counts, info = dryrun.lower_cell(
                arch, shape.name, multi_pod=False,
                cfg_override=_cfg(arch, moe),
                tcfg_override=_tcfg(layout, gd), serve_fsdp=sf,
                serve_param_dtype=sdt, mesh_override=mesh,
                shape_override=shape)
            r = {"info": info, "colls": [dataclasses.astuple(c)
                                         for c in counts.collectives]}
            if moe or layout in ("tp", "fsdp"):
                real = dryrun.count_cell(
                    _cfg(arch, moe), shape, _tcfg(layout, gd), mesh,
                    serve_fsdp=sf, serve_param_dtype=sdt, fake=False)
                r["real_flops"] = real.flops
                r["real_colls"] = [dataclasses.astuple(c)
                                   for c in real.collectives]
            res[f"{mname}/{cid}"] = r
        try:
            dryrun.lower_cell("starcoder2-3b", "train_4k", multi_pod=False)
        except ValueError as e:
            res[f"{mname}/refused"] = str(e)
    with open(out_path, "w") as f:
        json.dump(res, f)


SCRIPT = """
import sys
sys.path[:0] = [{src!r}, {tests!r}]
import test_torch_dryrun
test_torch_dryrun._cells_main({mname!r}, {out!r})
"""


@pytest.fixture(scope="module")
def runs():
    """The small cells of each mesh and the production cell, in three
    subprocesses at once."""
    with tempfile.TemporaryDirectory() as tmp:
        art = os.path.join(tmp, "art")
        procs = {"prod": subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "starcoder2-3b", "--shape", "train_4k", "--out", art],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=SRC),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)}
        for mname in MESHES:
            procs[mname] = subprocess.Popen(
                [sys.executable, "-c", SCRIPT.format(
                    src=SRC, tests=os.path.dirname(__file__), mname=mname,
                    out=os.path.join(tmp, f"{mname}.json"))],
                cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)
        outs = {k: p.communicate(timeout=600) for k, p in procs.items()}
        cells = {}
        for mname in MESHES:
            assert procs[mname].returncode == 0, outs[mname][1][-3000:]
            with open(os.path.join(tmp, f"{mname}.json")) as f:
                cells.update(json.load(f))
        arts = {name: json.load(open(os.path.join(art, name)))
                for name in os.listdir(art)} if os.path.isdir(art) else {}
    prod = subprocess.CompletedProcess(procs["prod"].args,
                                       procs["prod"].returncode,
                                       *outs["prod"])
    return {"cells": cells, "prod": prod, "prod_artifacts": arts}


def _rows(shape, mesh, layout):
    n = S.data_size(mesh, layout if shape.kind != "decode" else "tp")
    return shape.global_batch // n if shape.global_batch % n == 0 \
        else shape.global_batch


def _real_flops(arch, moe, shape, layout, gd, mesh):
    """FlopCounterMode's count of the unsharded cell on the rank's rows."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.train.step import (init_state, make_serve_step,
                                        make_train_step)
    cfg = _cfg(arch, moe).replace(**dryrun.PLAIN_IMPLS)
    model = build_model(cfg, "cpu")
    params = model.init(model.generator(0), dtype=torch.float32)
    rows = _rows(shape, mesh, layout)
    counter = FlopCounterMode(display=False)
    if shape.kind == "decode":
        enc = modality.encdec_split(cfg, shape.seq_len)[0] \
            if cfg.family == "encdec" else 0
        cache = model.init_cache(rows, shape.seq_len, enc_len=enc)
        with counter:
            make_serve_step(model)(params, cache,
                                   torch.zeros((rows, 1), dtype=torch.long))
        return counter.get_total_flops()
    batch = make_batch(cfg, rows, shape.seq_len, device="cpu")
    if shape.kind == "prefill":
        with torch.no_grad(), counter:
            model.apply(params, batch, remat=False)
        return counter.get_total_flops()
    tcfg = _tcfg(layout, gd)
    state = init_state(model, tcfg, params=params)
    with counter:
        make_train_step(model, tcfg)(state, batch)
    return counter.get_total_flops()


def _closed_form(cfg, shape, layout, gd, serve_fsdp, serve_dtype, sizes):
    """The collectives of a cell without MoE routes: (kind, out_bytes,
    group) multiset (module docstring)."""
    mesh = S.MeshView(tuple(sizes), tuple(sizes.values()))
    train = shape.kind == "train"
    if train:
        esize = 2 if gd == "bfloat16" else 4
    else:
        esize = 2 if serve_dtype == "bfloat16" else 4
    fsdp = serve_fsdp if shape.kind == "decode" else True
    sh = dict(tree_leaves(S.param_shardings(param_axes(cfg), cfg, mesh,
                                            fsdp=fsdp, layout=layout)))
    want = []
    for path, shp in tree_leaves(param_shapes(cfg)):
        spec = sh[path].spec
        cur = [n // math.prod(sizes[a] for a in S.entry_axes(e))
               for n, e in zip(shp, spec)]
        for dim, entry in enumerate(spec):
            n = math.prod(sizes[a] for a in S.entry_axes(entry))
            if S.entry_axes(entry):
                if train:
                    want.append(("reduce-scatter", math.prod(cur) * esize,
                                 n))
                cur[dim] *= n
                want.append(("all-gather", math.prod(cur) * esize, n))
        rest = [a for a in sizes if a not in S.spec_axes(spec)]
        if train and rest:
            want.append(("all-reduce", math.prod(cur) * esize // math.prod(
                sizes[a] for a in S.spec_axes(spec)),
                math.prod(sizes[a] for a in rest)))
    if train:
        world = math.prod(sizes.values())
        want += [("all-reduce", 8, world), ("all-reduce", 4, world)]
    return collections.Counter(want)


def _ref_analytic(arch, moe, shape, layout, gd, serve_fsdp, mesh):
    from jax.sharding import AbstractMesh
    from repro import analytic as RA
    from repro import config as RC
    from repro.models.builder import build_model as rbuild
    from repro.roofline import model_flops
    cfg = RC.get_config(arch, reduced=True)
    if moe:
        cfg = cfg.replace(moe_impl=moe)
    rshape = RC.ShapeConfig(shape.name, shape.kind, shape.seq_len,
                            shape.global_batch)
    tcfg = RC.TrainConfig(optimizer=RC.OptimizerConfig(name="adamw"),
                          layout=layout, grad_dtype=gd)
    rmesh = AbstractMesh(tuple(mesh.sizes), tuple(mesh.axis_names))
    mem = RA.step_hbm_bytes(rbuild(cfg), cfg, rshape, rmesh, tcfg=tcfg,
                            serve_fsdp=serve_fsdp)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    if cfg.family == "encdec" and shape.kind != "decode":
        tokens /= 2
    return {"hlo_flops": RA.step_flops(cfg, rshape, tcfg.remat) / mesh.size,
            "hlo_bytes": mem.total,
            "memory_breakdown": dataclasses.asdict(mem),
            "model_flops": model_flops(cfg.param_count(),
                                       cfg.active_param_count(), tokens,
                                       shape.kind)}


@pytest.mark.parametrize("mname", MESHES)
@pytest.mark.parametrize("cid", IDS)
def test_small_cells(runs, cid, mname):
    arch, moe, shape, layout, gd, sf, sdt = CELLS[IDS.index(cid)]
    r = runs["cells"][f"{mname}/{cid}"]
    info = r["info"]
    mcfg = MESHES[mname]
    mesh = S.MeshView(mcfg.axis_names, mcfg.shape)
    sizes = dict(zip(mcfg.axis_names, mcfg.shape))
    colls = collections.Counter(tuple(c) for c in r["colls"])

    per_use = layout in ("tp", "fsdp")
    if moe or per_use:
        assert info["counted_flops"] == r["real_flops"] > 0
        assert colls == collections.Counter(tuple(c)
                                            for c in r["real_colls"])
    if moe:
        route = {"a2a": "all-to-all", "ep": "all-reduce"}[moe]
        assert any(k == route for k, _, _ in colls)
    elif per_use:
        unsharded = _real_flops(arch, moe, shape, layout, gd, mesh)
        if layout == "fsdp":
            assert info["counted_flops"] == unsharded
        else:
            assert 0 < info["counted_flops"] < unsharded
    else:
        assert info["counted_flops"] == _real_flops(
            arch, moe, shape, layout, gd, mesh) > 0
        cfg = _cfg(arch, moe)
        assert colls == _closed_form(cfg, shape, layout, gd, sf, sdt, sizes)

    want = _ref_analytic(arch, moe, shape, layout, gd, sf, mesh)
    roof = info["roofline"]
    assert roof["hlo_flops"] == pytest.approx(want["hlo_flops"], rel=1e-12)
    assert roof["hlo_bytes"] == want["hlo_bytes"]
    assert roof["memory_breakdown"] == want["memory_breakdown"]
    assert roof["model_flops"] == want["model_flops"]
    assert roof["raw_cost_analysis"] == {
        "counted_flops": info["counted_flops"]}
    assert info["attn_impl"] == "torch"
    assert (info["chips"], info["mesh"]) == (
        8, "x".join(map(str, mcfg.shape)))

    # every cell runs the reference's program: the per-use gathers, the
    # tensor-parallel attention, MLP, vocabulary and recurrent layers, and
    # the sequence-split cache (LONG, B = 1)
    assert info["unfaithful_because"] == []
    assert info["faithful"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_s0", [False, True])
def test_wkv_stand_in_counts_what_the_scan_counts(with_s0, dtype):
    """``wkv_counted`` against the plain WKV loop on real CPU tensors:
    FlopCounterMode's forward and forward + backward counts, the output
    shapes and dtypes, and a gradient for every input."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels.rwkv6 import rwkv6_plain
    g = torch.Generator().manual_seed(0)
    B, S, H, D = 2, 7, 3, 8
    ins = [torch.randn(B, S, H, D, generator=g).to(getattr(torch, dtype))
           for _ in range(3)]
    ins += [torch.rand(B, S, H, D, generator=g),
            torch.randn(H, D, generator=g)]
    if with_s0:
        ins.append(torch.randn(B, H, D, D, generator=g))
    got = []
    for fn in (rwkv6_plain, dryrun.wkv_counted):
        leaves = [x.clone().requires_grad_() for x in ins]
        counter = FlopCounterMode(display=False)
        with counter:
            o, state = fn(*leaves)
            fwd = counter.get_total_flops()
            (o.float().sum() + state.sum()).backward()
        got.append((fwd, counter.get_total_flops(), o.shape, o.dtype,
                    state.shape, state.dtype,
                    [x.grad is not None for x in leaves]))
    assert got[0] == got[1]
    assert got[0][0] > 0 and all(got[0][-1])


@pytest.mark.parametrize("mname", MESHES)
def test_a_group_of_another_size_is_refused(runs, mname):
    assert "256-rank process group" in runs["cells"][f"{mname}/refused"]


def test_production_cell_on_256_fake_ranks(runs):
    prod = runs["prod"]
    assert prod.returncode == 0, prod.stderr[-3000:]
    assert "1 cells OK, 0 failed." in prod.stdout
    info = runs["prod_artifacts"]["starcoder2-3b_train_4k_16x16.json"]
    assert (info["chips"], info["layout"], info["kind"]) == (256, "tp",
                                                             "train")
    assert info["counted_flops"] > 0
    assert info["unfaithful_because"] == []
    from jax.sharding import AbstractMesh
    from repro import analytic as RA
    from repro import config as RC
    from repro.models.builder import build_model as rbuild
    cfg = RC.get_config("starcoder2-3b")
    shape = RC.SHAPES["train_4k"]
    tcfg = RC.TrainConfig(optimizer=RC.OptimizerConfig(name="adamw"))
    mem = RA.step_hbm_bytes(rbuild(cfg), cfg, shape,
                            AbstractMesh((16, 16), ("data", "model")),
                            tcfg=tcfg)
    roof = info["roofline"]
    assert roof["hlo_flops"] == pytest.approx(
        RA.step_flops(cfg, shape) / 256, rel=1e-12)
    assert roof["hlo_bytes"] == mem.total
    kinds = roof["collectives"]
    # per use: each layer leaf gathered in the forward and again in the
    # remat recompute, its gradient reduce-scattered once; the
    # embedding's tok and out gathered once each
    assert kinds["all-gather"]["count"] \
        == 2 * kinds["reduce-scatter"]["count"] - 2

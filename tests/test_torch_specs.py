"""The port's abstract inputs and their sharding specs
(``repro_torch.launch.specs``) against the JAX package's, for every
assigned arch x shape at full width, on the production meshes (16, 16)
and (2, 16, 16):

- every leaf's shape equals the reference's ``jax.eval_shape`` result.
  The reference's ``make_batch`` draws its numpy data even under
  ``eval_shape``, and the vlm and encdec batches are gigabytes at these
  shapes, so for those two families the reference is evaluated at 2
  rows and its leading (batch) dimension scaled to the cell's;
- every dtype is the reference's, except the batch's integer leaves
  (tokens, labels, M-RoPE positions), which are int64 in the port
  (``make_batch``) where the reference's are int32;
- every spec equals the reference's ``PartitionSpec`` entries (a
  one-axis tuple entry read as the axis), the cache leaves paired by
  path (the port's cache trees carry the reference's keys).

The reference's spec functions read a mesh's axis names and sizes only,
so they run on a ``jax.sharding.AbstractMesh``. Also: the port's ``meta``
batches draw nothing, and every train and prefill cell of the dry-run's
default and optimized passes splits its rows over the data ranks
(``sharding.local_batch`` refuses rows that do not split).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import sharding as S  # noqa: E402
from repro_torch.config import ASSIGNED_ARCHS, SHAPES, get_config  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.models.builder import build_model  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}
LAYOUTS = ("tp", "fsdp", "zero1")
REF_ROWS = 2             # the reference's vlm / encdec batches, scaled


def _entries(spec):
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _dtype_name(dt):
    return str(dt).replace("torch.", "")


def _ref_inputs(arch, shape):
    import dataclasses
    import jax
    from repro.config import get_config as rget
    from repro.launch import specs as RS
    from repro.models.builder import build_model as rbuild
    cfg = rget(arch)
    model = rbuild(cfg)
    if shape.kind != "decode":
        heavy = cfg.family in ("vlm", "encdec")
        small = dataclasses.replace(shape, global_batch=REF_ROWS) \
            if heavy else shape
        batch = RS.train_batch_specs(cfg, small)
        batch = {k: jax.ShapeDtypeStruct(
            (shape.global_batch,) + tuple(v.shape[1:]), v.dtype)
            for k, v in batch.items()}
        return RS, {"batch": batch}
    return RS, RS.input_specs(model, cfg, shape)


def _ref_leaves(tree):
    import jax
    return {"/".join(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("shape_name", SHAPES)
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_specs_match_the_reference(arch, shape_name):
    from jax.sharding import AbstractMesh
    shape = SHAPES[shape_name]
    cfg = get_config(arch)
    model = build_model(cfg, "cpu")
    got = specs.input_specs(model, cfg, shape)
    RS, want = _ref_inputs(arch, shape)
    assert got.keys() == want.keys()
    meshes = {name: (AbstractMesh(sizes, names), S.MeshView(names, sizes))
              for name, (names, sizes) in MESHES.items()}
    if shape.kind != "decode":
        wb, gb = want["batch"], got["batch"]
        assert gb.keys() == wb.keys()
        for k, w in wb.items():
            assert gb[k].shape == tuple(w.shape), k
            want_dt = _dtype_name(w.dtype)
            if want_dt == "int32":
                want_dt = "int64"           # the port's batch integers
            assert _dtype_name(gb[k].dtype) == want_dt, k
        for rmesh, pmesh in meshes.values():
            for layout in LAYOUTS:
                rs = RS.batch_shardings(wb, rmesh, layout)
                ps = specs.batch_shardings(gb, pmesh, layout)
                for k in wb:
                    assert _entries(ps[k]) == _entries(rs[k].spec), \
                        (layout, k)
        return
    wc, gc = _ref_leaves(want["cache"]), dict(tree_leaves(got["cache"]))
    assert gc.keys() == wc.keys()
    for k, w in wc.items():
        assert gc[k].shape == tuple(w.shape), k
        assert _dtype_name(gc[k].dtype) == _dtype_name(w.dtype), k
    assert got["tokens"].shape == tuple(want["tokens"].shape)
    for rmesh, pmesh in meshes.values():
        rs = _ref_leaves(RS.cache_shardings(want["cache"], rmesh, cfg))
        ps = dict(tree_leaves(specs.cache_shardings(got["cache"], pmesh,
                                                    cfg)))
        for k in wc:
            assert _entries(ps[k]) == _entries(rs[k].spec), k
        assert _entries(specs.token_sharding(got["tokens"], pmesh)) == \
            _entries(RS.token_sharding(want["tokens"], rmesh).spec)


def test_meta_batches_draw_nothing():
    """qwen2-vl's train_4k batch holds ~1.9 GB of patch embeddings; on the
    meta device it is shapes only."""
    cfg = get_config("qwen2-vl-7b")
    b = specs.train_batch_specs(cfg, SHAPES["train_4k"])
    assert b["patch_embeds"] == specs.TensorSpec((256, 1024, 3584),
                                                 torch.bfloat16)
    assert b["mrope_positions"].shape == (256, 4096, 3)


@pytest.mark.parametrize("optimized", [False, True])
def test_train_and_prefill_rows_split_over_the_data_ranks(optimized):
    for multi, (names, sizes) in zip((False, True), MESHES.values()):
        mesh = S.MeshView(names, sizes)
        for arch in ASSIGNED_ARCHS:
            for shape in SHAPES.values():
                if shape.kind == "decode":
                    continue
                kw = dryrun.optimized_overrides(arch, shape, multi) \
                    if optimized else {}
                tcfg = kw.get("tcfg_override") or dryrun._tcfg(
                    get_config(arch))
                n = S.data_size(mesh, tcfg.layout)
                assert shape.global_batch % n == 0, (arch, shape.name, n)

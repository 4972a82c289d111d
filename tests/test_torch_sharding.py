"""The port's sharding layer against the JAX package's: the logical axes
of every parameter, the partition-spec rules (``param_spec``,
``act_spec``, ``data_axes``, ``data_size``) on stand-in meshes with no
process group, and the execution helpers (``local_shard``, the
differentiable ``gather``, ``local_batch``, ``all_reduce``,
``all_to_all``) on 1, 2 and 4 CPU ranks joined by gloo.

Specs are compared entry for entry: the reference's ``PartitionSpec``
as a tuple against the port's plain tuple. The resnet conv weights are
OIHW in the port and HWIO in the reference, so their axes and specs are
compared through that permutation. The collectives are checked exactly
(float32 values that are gathered or summed in one order).

The gloo ranks are spawned once per world size, in a module fixture
that runs every scenario and returns the results the tests assert on.
The workers import nothing of JAX: the spawned processes import this
module.
"""
import itertools
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import sharding as S  # noqa: E402
from repro_torch.config import (MeshConfig, get_config, list_archs,  # noqa: E402
                                reference_block)
from repro_torch.launch import mesh as LM  # noqa: E402
from repro_torch.models.axes import param_axes, param_shapes  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

MESHES = [MeshConfig(data=1, model=1), MeshConfig(data=2, model=2),
          MeshConfig(data=4, model=2), MeshConfig(data=16, model=16),
          MeshConfig(pods=2, data=16, model=16)]


def _ref():
    import jax
    from jax.sharding import PartitionSpec as P
    from repro import config as JC
    from repro import sharding as JS
    from repro.models import layers as JL
    from repro.models.builder import build_model
    return jax, P, JC, JS, JL, build_model


def _ref_boxed(arch, reduced):
    """{path: (axes, shape)} of the reference's parameters."""
    jax, _, JC, _, JL, build_model = _ref()
    jcfg = JC.get_config(arch, reduced=reduced)
    boxed = build_model(jcfg).abstract_params()
    leaves = tree_leaves(jax.tree.map(lambda b: b, boxed, is_leaf=JL.is_boxed))
    return jcfg, {p: (b.axes, tuple(b.value.shape)) for p, b in leaves}


def _to_port(entries, cfg):
    """A reference per-dim tuple in the port's dim order."""
    entries = tuple(entries)
    if cfg.family == "resnet" and len(entries) == 4:
        return tuple(entries[i] for i in (3, 2, 0, 1))
    return entries


# ---------------------------------------------------------------------------
# Logical axes and spec rules (no process group)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("arch", list_archs())
def test_param_axes_match_the_reference(arch, reduced):
    """The reference's axes of every leaf (rwkv6-7b with the reference's
    block: ``reference_block``)."""
    cfg = reference_block(get_config(arch, reduced=reduced))
    _, want = _ref_boxed(arch, reduced)
    got = dict(tree_leaves(param_axes(cfg)))
    assert got.keys() == want.keys()
    for path, (axes, _) in want.items():
        assert got[path] == _to_port(axes, cfg), path


@pytest.mark.parametrize("mcfg", MESHES, ids=lambda m: "x".join(
    map(str, m.shape)))
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_match_the_reference(arch, mcfg):
    """Every leaf x every layout x fsdp on/off, at full width and reduced:
    ``param_shardings`` gives the reference's spec (the reference's rules
    run on the port's ``MeshView``, which has the attributes they
    read)."""
    _, P, JC, JS, _, _ = _ref()
    mesh = S.MeshView.from_config(mcfg)
    assert mesh.axis_names == JC.MeshConfig(
        data=mcfg.data, model=mcfg.model, pods=mcfg.pods).axis_names
    for reduced in (False, True):
        cfg = get_config(arch, reduced=reduced)
        jcfg, ref = _ref_boxed(arch, reduced)
        axes = param_axes(cfg)
        for layout, fsdp in itertools.product(S.LAYOUTS, (True, False)):
            got = dict(tree_leaves(S.param_shardings(
                axes, cfg, mesh, fsdp=fsdp, layout=layout)))
            for path, (jaxes, jshape) in ref.items():
                want = JS.param_spec(jaxes, jcfg, mesh, jshape, fsdp=fsdp,
                                     layout=layout)
                assert isinstance(want, P)
                assert got[path].spec == _to_port(want, cfg), \
                    (path, layout, fsdp)
                assert got[path].axes == _to_port(jaxes, cfg)
                opt = JS.opt_state_spec(jaxes, jcfg, mesh, jshape,
                                        zero1=fsdp)
                assert S.opt_state_spec(got[path].axes, cfg, mesh,
                                        _to_port(jshape, cfg), zero1=fsdp) \
                    == _to_port(opt, cfg)


ACT_CASES = [
    (("batch", None, None), [(256, 128, 64), (1, 128, 64), (8, 16, 64)]),
    (("batch", None, "heads", None), [(256, 128, 40, 128),
                                      (256, 128, 32, 128), (4, 8, 2, 4)]),
    (("batch", "kv_seq", "kv_heads", None), [(1, 4096, 8, 128),
                                             (32, 4096, 1, 128)]),
    (("batch", None, "vocab"), [(64, 128, 152064), (2, 8, 100)]),
    (("batch", None, "ff"), [(64, 128, 13824)]),
    (("experts", "batch", None, None), [(64, 32, 8, 2048)]),
    (("batch", None, "ssm_inner"), [(16, 64, 4096)]),
    ((None, "embed"), [(3, 2048)]),
]


@pytest.mark.parametrize("mcfg", MESHES, ids=lambda m: "x".join(
    map(str, m.shape)))
def test_act_specs_and_data_axes_match_the_reference(mcfg):
    _, _, _, JS, _, _ = _ref()
    mesh = S.MeshView.from_config(mcfg)
    for layout in S.LAYOUTS:
        assert S.data_axes(mesh, layout) == JS.data_axes(mesh, layout)
        assert S.data_size(mesh, layout) == JS.data_size(mesh, layout)
        for axes, shapes in ACT_CASES:
            assert S.act_spec(axes, mesh, None, layout) == tuple(
                JS.act_spec(axes, mesh, None, layout))
            for shape in shapes:
                assert S.act_spec(axes, mesh, shape, layout) == tuple(
                    JS.act_spec(axes, mesh, shape, layout)), (axes, shape)
    assert S.data_axes(mesh) == JS.data_axes(mesh)


def test_use_mesh_is_thread_local_and_nests():
    import threading
    outer, inner = (S.MeshView.from_config(MeshConfig(data=d, model=1))
                    for d in (2, 4))
    assert S.current_mesh() is None and S.current_layout() == "tp"
    with S.use_mesh(outer, "fsdp"):
        seen = []
        t = threading.Thread(target=lambda: seen.append(S.current_mesh()))
        t.start()
        t.join()
        assert seen == [None]
        with S.use_mesh(inner, "zero1"):
            assert S.current_mesh() is inner
            assert S.current_layout() == "zero1"
        assert S.current_mesh() is outer and S.current_layout() == "fsdp"
    assert S.current_mesh() is None and S.current_layout() == "tp"
    with pytest.raises(AssertionError):
        with S.use_mesh(outer, "dp"):
            pass
    x = torch.ones(2, 3)
    assert S.shard_act(x, ("batch", None)) is x


# --- the reference's test_sharding.py cases, on the port -------------------

QWEN = get_config("qwen2.5-14b")
M16 = S.MeshView(("data", "model"), (16, 16))


def test_model_axis_requires_divisibility():
    assert S.param_spec(("embed", "heads", "head_dim"), QWEN, M16,
                        (5120, 40, 128)) == ("data", None, None)
    assert S.param_spec(("embed", "heads", "head_dim"), QWEN, M16,
                        (6144, 48, 128)) == ("data", "model", None)


def test_mqa_kv_head_replicated():
    spec = S.param_spec(("embed", "kv_heads", "head_dim"), QWEN, M16,
                        (6144, 1, 128))
    assert spec[1] is None


def test_fsdp_skips_non_divisible_embed():
    assert S.param_spec(("embed", "ff"), QWEN, M16, (5000, 13824)) == \
        (None, "model")


def test_only_first_model_axis_used():
    assert S.param_spec(("ff", "vocab"), QWEN, M16, (13824, 152064)) == \
        ("model", None)


def test_act_spec_divisibility():
    assert S.act_spec(("batch", None, None), M16, (256, 128, 64))[0] == "data"
    assert S.act_spec(("batch", None, None), M16, (1, 128, 64))[0] is None
    assert S.act_spec(("batch", None, "heads", None), M16,
                      (256, 128, 40, 128))[2] is None
    assert S.act_spec(("batch", None, "heads", None), M16,
                      (256, 128, 32, 128))[2] == "model"


def test_data_axes_multi_pod():
    m = S.MeshView.from_config(MeshConfig(pods=2, data=16, model=16))
    assert m.shape == {"pod": 2, "data": 16, "model": 16} and m.size == 512
    assert S.data_axes(m) == ("pod", "data")
    assert S.data_size(m) == 32


def test_param_shardings_cover_every_leaf():
    """(The reference's ``test_real_mesh_end_to_end``: its 1 x 1 mesh is a
    view here.)"""
    cfg = get_config("zamba2-1.2b", reduced=True)
    mesh = S.MeshView.from_config(MeshConfig(data=1, model=1))
    tree = S.param_shardings(param_axes(cfg), cfg, mesh)
    n_params = len(list(tree_leaves(param_axes(cfg))))
    shards = [s for _, s in tree_leaves(tree)]
    assert len(shards) == n_params
    assert all(isinstance(s, S.NamedSharding) and s.mesh is mesh
               for s in shards)


def test_meshes_refuse_a_world_of_another_size():
    """Without a process group, and with one of the wrong size, every
    mesh constructor raises before making a mesh."""
    with pytest.raises(RuntimeError, match="init_process_group"):
        LM.single_device_mesh(device_type="cpu")
    msgs = LM.run_ranks(_wrong_world, 1)[0]
    assert [m.split(" mesh needs ")[1] for m in msgs] == [
        "256 ranks; the process group has 1",
        "512 ranks; the process group has 1",
        "4 ranks; the process group has 1",
        "2 ranks; the process group has 1"]


def _wrong_world(rank):
    out = []
    for build in (lambda: LM.make_production_mesh(device_type="cpu"),
                  lambda: LM.make_production_mesh(multi_pod=True,
                                                  device_type="cpu"),
                  lambda: LM.survivor_mesh(1, data=2, model=2,
                                           device_type="cpu"),
                  lambda: LM.make_mesh(MeshConfig(data=2, model=1),
                                       device_type="cpu")):
        try:
            build()
            out.append("built")
        except ValueError as e:
            out.append(str(e))
    return out


# ---------------------------------------------------------------------------
# Execution helpers on gloo ranks
# ---------------------------------------------------------------------------

WORLD_MESHES = {1: [MeshConfig(data=1, model=1)],
                2: [MeshConfig(data=1, model=2), MeshConfig(data=2, model=1)],
                4: [MeshConfig(data=2, model=2), MeshConfig(data=1, model=4),
                    MeshConfig(pods=2, data=1, model=2)]}


def _spec_cases(mesh):
    """Every distinct (spec, shape) the reduced architectures' parameters
    get on ``mesh`` under every layout, and every spec of single- and
    multi-axis entries on a small 3-D shape."""
    cases = {}
    for arch in list_archs():
        cfg = get_config(arch, reduced=True)
        shapes = dict(tree_leaves(param_shapes(cfg)))
        for layout in S.LAYOUTS:
            for path, s in tree_leaves(S.param_shardings(
                    param_axes(cfg), cfg, mesh, layout=layout)):
                cases.setdefault((s.spec, shapes[path]), None)
    names = mesh.axis_names
    entries = [None] + list(names) + [
        c for r in range(2, len(names) + 1)
        for c in itertools.combinations(names, r)]
    n = mesh.size
    for spec in itertools.product(entries, repeat=3):
        if len(S.spec_axes(spec)) == len(set(S.spec_axes(spec))):
            cases.setdefault((spec, (2 * n, n, 4 * n)), None)
    return list(cases)


def _collectives_worker(rank, mcfgs):
    results = {}
    for mcfg in mcfgs:
        mesh = LM.make_mesh(mcfg, device_type="cpu")
        name = "x".join(map(str, mcfg.shape))
        world = mesh.size
        gather_ok, backward_ok, n_cases = True, True, 0
        for spec, shape in _spec_cases(mesh):
            gen = torch.Generator().manual_seed(zlib.crc32(repr((spec, shape))
                                                           .encode()))
            x = torch.randn(shape, generator=gen)
            loc = S.local_shard(x, spec, mesh).requires_grad_()
            full = S.gather(loc, spec, mesh)
            gather_ok &= torch.equal(full, x) and full.is_contiguous()
            w = [torch.randn(shape, generator=torch.Generator()
                             .manual_seed(r + 7)) for r in range(world)]
            (full * w[rank]).sum().backward()
            axes = tuple(a for a in mesh.axis_names
                         if a in S.spec_axes(spec))
            ranks = (torch.distributed.get_process_group_ranks(
                mesh.group(axes)) if axes else [rank])
            want = S.local_shard(sum(w[r] for r in ranks), spec, mesh)
            backward_ok &= bool(torch.allclose(loc.grad, want, rtol=0,
                                               atol=1e-5))
            n_cases += 1
        # the group of a subset of axes: ranks in row-major order of it
        groups_ok = True
        for axes, g in mesh.groups.items():
            ranks = torch.distributed.get_process_group_ranks(g)
            groups_ok &= ranks[mesh.index(axes)] == rank
        # local_batch: contiguous rows per data rank, in row-major order
        batch = {"tokens": torch.arange(8 * world).view(4 * world, 2)}
        rows = {layout: S.local_batch(batch, mesh, layout)["tokens"]
                for layout in S.LAYOUTS}
        # differentiable all_to_all and all_reduce over every axis
        everything = mesh.axis_names
        src = torch.arange(world * 3.0).view(world, 3) + 100 * rank
        src.requires_grad_()
        got = S.all_to_all(src, mesh, everything)
        (got * (rank + 1)).sum().backward()
        a2a = (got.detach(), src.grad.clone())
        red_in = torch.full((2,), float(rank + 1), requires_grad=True)
        red = S.all_reduce(red_in, mesh, everything)
        (red * (rank + 1)).sum().backward()
        view_ok = S.MeshView.from_device_mesh(mesh.device_mesh) == \
            S.MeshView(mesh.axis_names, mesh.sizes)
        results[name] = dict(
            coords=mesh.coords, n_cases=n_cases, gather_ok=gather_ok,
            view_ok=view_ok,
            backward_ok=backward_ok, groups_ok=groups_ok,
            rows={k: v.tolist() for k, v in rows.items()},
            a2a=a2a, red=(red.detach(), red_in.grad.clone()))
    return results


@pytest.fixture(scope="module")
def gloo():
    return {world: LM.run_ranks(_collectives_worker, world, mcfgs)
            for world, mcfgs in WORLD_MESHES.items()}


CASES = [(w, m) for w, ms in WORLD_MESHES.items() for m in ms]
IDS = ["x".join(map(str, m.shape)) for _, m in CASES]


@pytest.mark.parametrize("world,mcfg", CASES, ids=IDS)
def test_gather_inverts_local_shard(gloo, world, mcfg):
    name = "x".join(map(str, mcfg.shape))
    for rank, res in enumerate(gloo[world]):
        r = res[name]
        assert r["n_cases"] > 20 and r["gather_ok"], (rank, r)


@pytest.mark.parametrize("world,mcfg", CASES, ids=IDS)
def test_gather_backward_is_the_summed_reduce_scatter(gloo, world, mcfg):
    name = "x".join(map(str, mcfg.shape))
    assert all(res[name]["backward_ok"] for res in gloo[world])


@pytest.mark.parametrize("world,mcfg", CASES, ids=IDS)
def test_mesh_coords_groups_and_local_batch_rows(gloo, world, mcfg):
    name = "x".join(map(str, mcfg.shape))
    shape = mcfg.shape
    coords = [res[name]["coords"] for res in gloo[world]]
    assert coords == list(itertools.product(*(range(n) for n in shape)))
    mesh = S.MeshView.from_config(mcfg)
    for rank, res in enumerate(gloo[world]):
        r = res[name]
        assert r["groups_ok"] and r["view_ok"]
        for layout, rows in r["rows"].items():
            axes = S.data_axes(mesh, layout)
            n = S.data_size(mesh, layout)
            coord = dict(zip(mcfg.axis_names, coords[rank]))
            i = 0
            for a in axes:
                i = i * mesh.shape[a] + coord[a]
            per = 4 * world // n
            want = torch.arange(8 * world).view(4 * world, 2)[
                i * per:(i + 1) * per]
            assert rows == want.tolist(), (rank, layout)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_all_to_all_and_all_reduce_are_differentiable(gloo, world):
    name = "x".join(map(str, WORLD_MESHES[world][0].shape))
    for rank, res in enumerate(gloo[world]):
        got, grad = res[name]["a2a"]
        # block j of the result is block `rank` of rank j's input
        want = torch.stack([torch.arange(rank * 3.0, rank * 3.0 + 3)
                            + 100 * j for j in range(world)])
        assert torch.equal(got, want)
        # rank j weighted its result by j + 1; block j of the input went
        # to rank j
        assert torch.equal(grad, torch.arange(1.0, world + 1)[:, None]
                           .expand(world, 3))
        red, red_grad = res[name]["red"]
        total = world * (world + 1) / 2
        assert torch.equal(red, torch.full((2,), total))
        assert torch.equal(red_grad, torch.full((2,), total))


def test_local_batch_refuses_rows_that_do_not_split():
    res = LM.run_ranks(_uneven_batch, 2)
    assert res == ["does not split"] * 2


def _uneven_batch(rank):
    mesh = LM.make_mesh(MeshConfig(data=2, model=1), device_type="cpu")
    try:
        S.local_batch({"tokens": torch.zeros(3, 4)}, mesh)
    except ValueError as e:
        return "does not split" if "does not split" in str(e) else str(e)
    return "split"


def test_local_shard_owns_its_storage():
    res = LM.run_ranks(_owns_storage, 1)
    assert res == [True]


def _owns_storage(rank):
    mesh = LM.single_device_mesh(device_type="cpu")
    x = torch.arange(12.0).view(3, 4)
    loc = S.local_shard(x, (("data", "model"), None), mesh)
    loc.add_(1)
    return bool(np.array_equal(x.numpy(), np.arange(12.0).reshape(3, 4)))

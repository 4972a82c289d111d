"""The port's roofline (``repro_torch.roofline``): the reference's HLO
parsers and wire models (``tests/test_roofline.py``, run on the port),
the H100 constants, the kernel roofline, ``build_report`` from counts,
and the collective recorder.

The recorder is held on 2 and 4 CPU ranks joined by gloo, meshes
(data 2, model 1) and (data 2, model 2): one zero1 step (float32) and
one fsdp step (bf16 gradients) of reduced starcoder2-3b, and an a2a
forward of reduced moonshot-v1-16b-a3b, must record exactly the
collectives they issue, with the bytes of their outputs equal to the
closed form:

- an all-gather per sharded dim of each leaf's spec, its output the leaf
  gathered so far at the compute dtype (the whole leaf, for a leaf
  sharded on one dim), over the group of that entry's axes; under
  fsdp, which gathers per use, one such gather of each layer's block of
  a layer-stacked leaf in the forward and one in the remat recompute,
  of each other leaf one at its use;
- a reduce-scatter for each all-gather (per use: for each forward
  gather), its output that gather's input at the gradient dtype;
- an all-reduce of the block's gradient over the axes its spec does not
  name, one of the (loss, aux) metrics (8 bytes) and one of the squared
  norm (4 bytes) over every rank;
- per MoE layer of the a2a forward, two all-to-alls of the (E * cap, D)
  dispatch buffer over the expert ranks, and the aux's all-reduce.

The ranks are spawned once per world size in a module fixture; the
workers import nothing of JAX.
"""
import collections
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch import roofline as R  # noqa: E402
from repro_torch import sharding as S  # noqa: E402
from repro_torch.config import (MeshConfig, OptimizerConfig,  # noqa: E402
                                TrainConfig, get_config)
from repro_torch.launch import mesh as LM  # noqa: E402
from repro_torch.models import ffn  # noqa: E402
from repro_torch.models.axes import param_axes, param_shapes  # noqa: E402
from repro_torch.models.builder import build_model  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

HLO = """\
HloModule jit_train_step, entry_computation_layout={...}

%region_cond.1 (arg.1: (s32[])) -> pred[] {
  %iv = s32[] get-tuple-element(%arg.1), index=0
  %bound = s32[] constant(30)
  ROOT %lt = pred[] compare(%iv, %bound), direction=LT
}

%region_body.2 (arg.2: (s32[])) -> (s32[]) {
  %ar.1 = f32[1024,512]{1,0} all-reduce(%x), replica_groups=[16,16]<=[256], to_apply=%add
  %ag.1 = bf16[2048,128]{1,0} all-gather(%y), replica_groups={{0,1,2,3}}, dimensions={0}
  ROOT %t = (s32[]) tuple(%iv2)
}

ENTRY %main.3 (p: f32[8]) -> f32[8] {
  %w = (s32[]) while(%init), condition=%region_cond.1, body=%region_body.2
  %ar.2 = f32[4096]{0} all-reduce(%z), replica_groups=[1,256]<=[256], to_apply=%add
  %cp = f32[64,64]{1,0} collective-permute(%q), source_target_pairs={{0,1}}
  ROOT %r = f32[8] add(%p, %p)
}
"""


# ---------------------------------------------------------------------------
# The reference's parser and wire-model tests, on the port
# ---------------------------------------------------------------------------

def test_shape_bytes():
    assert R._shape_bytes("f32[1024,512]{1,0}") == 1024 * 512 * 4
    assert R._shape_bytes("bf16[2048,128]") == 2048 * 128 * 2
    assert R._shape_bytes("(f32[4], s32[2])") == 16 + 8


def test_parse_collectives_flat():
    colls = R.parse_collectives(HLO)
    kinds = sorted(c.kind for c in colls)
    assert kinds == ["all-gather", "all-reduce", "all-reduce",
                     "collective-permute"]


def test_group_sizes():
    colls = {(c.kind, c.out_bytes): c for c in R.parse_collectives(HLO)}
    ar_big = colls[("all-reduce", 1024 * 512 * 4)]
    assert ar_big.group == 16                    # iota form [16,16]
    ag = colls[("all-gather", 2048 * 128 * 2)]
    assert ag.group == 4                         # explicit {{0,1,2,3}}


def test_wire_models():
    ar = R.Collective("all-reduce", 1000, 10)
    assert ar.wire_bytes == pytest.approx(2 * 1000 * 9 / 10)
    ag = R.Collective("all-gather", 1000, 10)
    assert ag.wire_bytes == pytest.approx(1000 * 9 / 10)
    rs = R.Collective("reduce-scatter", 100, 10)
    assert rs.wire_bytes == pytest.approx(100 * 9)
    cp = R.Collective("collective-permute", 1000, 2)
    assert cp.wire_bytes == 1000


def test_loop_aware_trip_multiplication():
    out = R.parse_collectives_loop_aware(HLO)
    by_kind = {}
    for c, trips in out:
        by_kind.setdefault(c.kind, []).append(trips)
    assert sorted(by_kind["all-reduce"]) == [1, 30]   # entry + in-loop
    assert by_kind["all-gather"] == [30]
    assert by_kind["collective-permute"] == [1]


def test_report_terms_and_bottleneck():
    """The reference's test at the H100's rates (its own uses its own
    constants)."""
    r = R.RooflineReport(
        arch="x", shape="train_4k", mesh="16x16", chips=256,
        hlo_flops=R.PEAK_FLOPS_BF16 * 0.1,      # 100 ms of compute
        hlo_bytes=R.HBM_BW * 0.05,              # 50 ms of HBM
        wire_bytes=R.NVLINK_BW * 0.2,           # 200 ms of NVLink
        model_flops=R.PEAK_FLOPS_BF16 * 0.1 * 256 * 0.8,
        collectives={})
    assert r.t_compute == pytest.approx(0.1)
    assert r.t_memory == pytest.approx(0.05)
    assert r.t_collective == pytest.approx(0.2)
    assert r.bottleneck == "collective"
    assert r.useful_flops_ratio == pytest.approx(0.8)
    assert r.roofline_fraction == pytest.approx(0.8 * 0.1 / 0.2)


# ---------------------------------------------------------------------------
# The port's own surface
# ---------------------------------------------------------------------------

def test_one_rank_group_moves_nothing():
    for kind in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all"):
        assert R.Collective(kind, 1000, 1).wire_bytes == 0.0
        assert R.Collective(kind, 1000, 2).wire_bytes > 0


def test_h100_constants():
    """NVIDIA's H100 SXM datasheet, dense: bf16 989 TFLOP/s, float32 67
    TFLOP/s, HBM3 3.35 TB/s, NVLink 4 900 GB/s both ways together."""
    assert (R.PEAK_FLOPS_BF16, R.PEAK_FLOPS_FP32, R.HBM_BW, R.NVLINK_BW) \
        == (989e12, 67e12, 3.35e12, 450e9)


def test_kernel_roofline_takes_the_peak_of_its_arithmetic():
    k = R.kernel_roofline(67e9, 3.35e9)
    assert k.t_memory == pytest.approx(1e-3)
    assert k.t_compute == pytest.approx(67e9 / 989e12)
    assert k.bottleneck == "memory" and k.t_bound == k.t_memory
    k32 = R.kernel_roofline(67e9 * 2, 3.35e9, peak_flops=R.PEAK_FLOPS_FP32)
    assert k32.t_compute == pytest.approx(2e-3)
    assert k32.bottleneck == "compute"
    assert k32.achieved_fraction(4e-3) == pytest.approx(0.5)


def test_build_report_from_counts():
    colls = [(R.Collective("all-gather", 1000, 4), 2),
             (R.Collective("all-gather", 500, 4), 1),
             (R.Collective("all-reduce", 100, 2), 3)]
    r = R.build_report(arch="a", shape="s", mesh_name="2x2", chips=4,
                       counted_flops=8e9, collectives=colls, mflops=1e9)
    assert r.hlo_flops == 8e9 and r.hlo_bytes == 0.0
    assert r.raw_cost_analysis == {"counted_flops": 8e9}
    assert r.peak_memory_bytes is None
    assert r.collectives["all-gather"] == {
        "count": 2, "executions": 3, "out_bytes": 2500.0,
        "wire_bytes": 2500 * 3 / 4}
    assert r.collectives["all-reduce"]["wire_bytes"] == 3 * 2 * 100 / 2
    assert r.wire_bytes == pytest.approx(2500 * 3 / 4 + 300)
    a = R.build_report(arch="a", shape="s", mesh_name="2x2", chips=4,
                       counted_flops=8e9, collectives=[], mflops=1e9,
                       analytic_flops=16e9, analytic_bytes=7.0)
    assert (a.hlo_flops, a.hlo_bytes) == (4e9, 7.0)
    assert a.raw_cost_analysis == {"counted_flops": 8e9}
    assert R.format_table([r, a]).count("\n") == 3


def test_recorder_is_off_outside_its_block():
    assert S.recorders == []
    with R.record_collectives() as outer:
        with R.record_collectives() as inner:
            assert S.recorders == [outer, inner]
        assert S.recorders == [outer]
    assert S.recorders == []


# ---------------------------------------------------------------------------
# The recorder on gloo ranks
# ---------------------------------------------------------------------------

MESHES = {2: MeshConfig(data=2, model=1), 4: MeshConfig(data=2, model=2)}
STEPS = {"zero1": "float32", "fsdp": "bfloat16"}     # layout: grad dtype
B, SEQ = 4, 8


def _cfg(arch, **kw):
    return get_config(arch, reduced=True).replace(
        dtype="float32", attn_impl="torch", ssm_impl="torch",
        rwkv_impl="torch", **kw)


def _record(colls):
    return [(c.kind, c.out_bytes, c.group) for c in colls]


def _worker(rank, world):
    from repro_torch.data.pipeline import make_batch
    from repro_torch.train.step import init_state, make_train_step
    mesh = LM.make_mesh(MESHES[world], device_type="cpu")
    out = {}
    cfg = _cfg("starcoder2-3b")
    model = build_model(cfg, "cpu")
    axes = param_axes(cfg)
    batch = make_batch(cfg, B, SEQ, device="cpu")
    for layout, gd in STEPS.items():
        tcfg = TrainConfig(optimizer=OptimizerConfig(name="adamw"),
                           layout=layout, grad_dtype=gd)
        sh = S.param_shardings(axes, cfg, mesh, layout=layout)
        full = model.init(model.generator(0), dtype=torch.float32)
        state = init_state(model, tcfg, params=S.shard_tree(full, sh))
        step = make_train_step(
            model, tcfg, param_shardings=sh,
            zero1_mask=tree_map(lambda a: "experts" not in a, axes))
        with R.record_collectives() as colls, S.use_mesh(mesh, layout):
            step(state, batch)
        out[layout] = _record(colls)

    mcfg = _cfg("moonshot-v1-16b-a3b", moe_impl="a2a")
    moe = build_model(mcfg, "cpu")
    params = moe.init(moe.generator(0), dtype=torch.float32)
    tokens = S.local_batch(make_batch(mcfg, B, SEQ, device="cpu"), mesh,
                           "fsdp")
    ffn.moe_routes.clear()
    with torch.no_grad(), R.record_collectives() as colls, \
            S.use_mesh(mesh, "fsdp"):
        moe.apply(params, tokens, remat=False)
    out["a2a"] = _record(colls)
    out["a2a_routes"] = dict(ffn.moe_routes)
    return out


@pytest.fixture(scope="module")
def gloo():
    return {world: LM.run_ranks(_worker, world, world) for world in MESHES}


def _sizes(world):
    m = MESHES[world]
    return dict(zip(m.axis_names, m.shape))


def step_closed_form(cfg, layout, grad_dtype, sizes):
    """The collectives of one sharded step (module docstring), as a
    multiset of (kind, out_bytes, group)."""
    mesh = S.MeshView(tuple(sizes), tuple(sizes.values()))
    esize = 2 if grad_dtype == "bfloat16" else 4
    axes = param_axes(cfg)
    sh = dict(tree_leaves(S.param_shardings(axes, cfg, mesh, layout=layout)))
    want = []
    everything = math.prod(sizes.values())
    for path, shape in tree_leaves(param_shapes(cfg)):
        spec = sh[path].spec
        # (gathered shape, its spec, reduce-scatters, all-gathers)
        if layout == "fsdp" and path.startswith("layers/"):
            L = shape[0]
            uses = (shape[1:], spec[1:], L, 2 * L)
        else:
            uses = (shape, spec, 1, 1)
        gshape, gspec, n_rs, n_ag = uses
        cur = list(gshape)
        for dim, entry in enumerate(gspec):
            cur[dim] //= math.prod(sizes[a] for a in S.entry_axes(entry))
        for dim, entry in enumerate(gspec):
            n = math.prod(sizes[a] for a in S.entry_axes(entry))
            if S.entry_axes(entry):
                want += [("reduce-scatter", math.prod(cur) * esize, n)] * n_rs
                cur[dim] *= n
                want += [("all-gather", math.prod(cur) * esize, n)] * n_ag
        rest = [a for a in sizes if a not in S.spec_axes(spec)]
        if rest:
            block = math.prod(shape) // math.prod(
                sizes[a] for a in S.spec_axes(spec))
            want.append(("all-reduce", block * esize,
                         math.prod(sizes[a] for a in rest)))
    want += [("all-reduce", 8, everything), ("all-reduce", 4, everything)]
    return collections.Counter(want)


@pytest.mark.parametrize("layout", STEPS)
@pytest.mark.parametrize("world", MESHES)
def test_recorder_sees_every_collective_of_a_sharded_step(gloo, world,
                                                          layout):
    want = step_closed_form(_cfg("starcoder2-3b"), layout, STEPS[layout],
                            _sizes(world))
    for r in gloo[world]:
        assert collections.Counter(r[layout]) == want
    kinds = collections.Counter(k for k, _, _ in gloo[world][0][layout])
    # every gather of the forward has its reduce-scatter; fsdp's remat
    # recompute gathers each layer's block of a stacked leaf once more
    cfg = _cfg("starcoder2-3b")
    mesh = S.MeshView(tuple(_sizes(world)), tuple(_sizes(world).values()))
    sh = S.param_shardings(param_axes(cfg), cfg, mesh, layout=layout)
    again = 0
    if layout == "fsdp":
        again = sum(cfg.num_layers * sum(bool(S.entry_axes(e))
                                         for e in s.spec[1:])
                    for path, s in tree_leaves(sh)
                    if path.startswith("layers/"))
    assert kinds["all-gather"] == kinds["reduce-scatter"] + again
    assert kinds["reduce-scatter"] > 0


@pytest.mark.parametrize("world", MESHES)
def test_recorder_sees_the_a2a_all_to_alls(gloo, world):
    cfg = _cfg("moonshot-v1-16b-a3b", moe_impl="a2a")
    n_moe = cfg.num_layers - cfg.first_dense_layers
    cap = ffn.a2a_capacity(B // world * SEQ, cfg)
    E = cfg.num_experts
    ep = world if E % world == 0 else MESHES[world].model
    buf = E * cap * cfg.d_model * 4
    want = collections.Counter({("all-to-all", buf, ep): 2 * n_moe,
                                ("all-reduce", 4, world): n_moe})
    for r in gloo[world]:
        assert r["a2a_routes"] == {"a2a": n_moe}
        assert collections.Counter(r["a2a"]) == want

"""The port's analytic FLOPs / HBM-bytes model (``repro_torch.analytic``)
and its cell shapes and parameter counts (``repro_torch.config``)
against the JAX package's.

- The reference's own invariants (``tests/test_analytic.py``), run on
  the port; its one-device mesh is a (1, 1) ``MeshView`` here.
- Every number equals the reference's, for every assigned arch (and
  resnet32) x shape: ``fwd_flops`` and ``step_flops`` (remat full and
  none) to 1e-12 relative, ``sharded_param_bytes`` and every field of
  ``step_hbm_bytes`` exactly, for the layouts tp, fsdp and zero1 on the
  production meshes (16, 16) and (2, 16, 16), ``serve_fsdp`` both ways,
  with the attention names mapped: the reference's ``"xla"`` (its plain
  path) is the port's ``"torch"``, its ``"pallas"`` the port's
  ``"cuda"``. The reference's functions read a mesh's axis names and
  sizes only, so its side runs on a ``jax.sharding.AbstractMesh``.
"""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro_torch import analytic  # noqa: E402
from repro_torch.config import (ASSIGNED_ARCHS, SHAPES, OptimizerConfig,  # noqa: E402
                                TrainConfig, get_config, list_archs,
                                reference_block)
from repro_torch.sharding import MeshView  # noqa: E402

ONE = MeshView(("data", "model"), (1, 1))
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}
IMPLS = {"torch": "xla", "cuda": "pallas"}      # port's name: reference's
LAYOUTS = ("tp", "fsdp", "zero1")


def _ref(arch, reduced=False):
    from repro import analytic as RA
    from repro import config as RC
    from repro.models.builder import build_model
    cfg = RC.get_config(arch, reduced=reduced)
    return RA, RC, cfg, build_model(cfg)


# ---------------------------------------------------------------------------
# The reference's invariants, on the port
# ---------------------------------------------------------------------------

def test_fwd_flops_linear_in_batch():
    cfg = get_config("qwen2.5-14b")
    f1 = analytic.fwd_flops(cfg, 1, 4096)
    f4 = analytic.fwd_flops(cfg, 4, 4096)
    assert f4 == pytest.approx(4 * f1, rel=1e-9)


def test_train_flops_exceed_prefill():
    cfg = get_config("granite-20b")
    shape = SHAPES["train_4k"]
    tr = analytic.step_flops(cfg, shape, remat="full")
    pf = analytic.fwd_flops(cfg, shape.global_batch, shape.seq_len)
    assert tr == pytest.approx(4 * pf, rel=1e-9)       # fwd+bwd+remat
    assert analytic.step_flops(cfg, shape, remat="none") == \
        pytest.approx(3 * pf, rel=1e-9)


def test_fwd_flops_close_to_6nd_heuristic():
    """For a big dense model at moderate seq, matmul flops ~ 2 N D."""
    for arch in ("qwen2.5-14b", "granite-20b", "rwkv6-7b"):
        cfg = get_config(arch)
        T = 256 * 4096
        got = analytic.fwd_flops(cfg, 256, 4096)
        ideal = 2.0 * cfg.active_param_count() * T
        assert 0.8 < got / ideal < 1.6, (arch, got / ideal)


def test_moe_flops_track_active_params():
    cfg = get_config("arctic-480b")
    got = analytic.fwd_flops(cfg, 8, 4096)
    dense_equiv = 2.0 * cfg.param_count() * 8 * 4096
    active_equiv = 2.0 * cfg.active_param_count() * 8 * 4096
    assert got < 0.2 * dense_equiv                     # far from dense
    assert got == pytest.approx(active_equiv, rel=0.6)


def test_decode_flops_much_smaller_than_prefill():
    cfg = get_config("gemma3-27b")
    pf = analytic.step_flops(cfg, SHAPES["prefill_32k"])
    dc = analytic.step_flops(cfg, SHAPES["decode_32k"])
    assert dc < pf / 100


def test_sliding_window_reduces_attn_flops():
    cfg = get_config("gemma3-27b")                     # 5:1 local:global
    full = cfg.replace(sliding_window=0, global_every=0)
    assert analytic.fwd_flops(cfg, 1, 32768) < \
        analytic.fwd_flops(full, 1, 32768)


def test_sharded_param_bytes_layouts():
    cfg = get_config("starcoder2-3b", reduced=True)
    full = analytic.sharded_param_bytes(None, cfg, ONE, 4)
    # 1-device mesh: nothing shards; both layouts give the whole model
    assert analytic.sharded_param_bytes(None, cfg, ONE, 4,
                                        layout="fsdp") == full
    assert full == pytest.approx(cfg.param_count() * 4, rel=0.01)


def test_memory_breakdown_decode_dominated_by_weights_or_kv():
    cfg = get_config("qwen2.5-14b", reduced=True)
    mb = analytic.step_hbm_bytes(None, cfg, SHAPES["decode_32k"], ONE,
                                 tcfg=TrainConfig())
    assert mb.total > 0
    assert mb.params + mb.kv_cache > 0.5 * mb.total


def test_remat_flag_changes_memory_model():
    cfg = get_config("starcoder2-3b", reduced=True)
    with_remat = analytic.step_hbm_bytes(
        None, cfg, SHAPES["train_4k"], ONE, tcfg=TrainConfig(remat="full"))
    without = analytic.step_hbm_bytes(
        None, cfg, SHAPES["train_4k"], ONE, tcfg=TrainConfig(remat="none"))
    assert without.activations < with_remat.activations


def test_only_the_plain_attention_counts_scores():
    """The port's "torch" attention materialises scores (the reference's
    "xla"), its "cuda" kernels do not (the reference's "pallas")."""
    cfg = get_config("starcoder2-3b")
    shape, tcfg = SHAPES["train_4k"], TrainConfig()
    plain = analytic.step_hbm_bytes(None, cfg, shape, ONE, tcfg=tcfg,
                                    attn_impl="torch")
    kernel = analytic.step_hbm_bytes(None, cfg, shape, ONE, tcfg=tcfg,
                                     attn_impl="cuda")
    assert plain.attn_scores > 0 and kernel.attn_scores == 0
    assert dataclasses.replace(plain, attn_scores=0.0) == kernel


# ---------------------------------------------------------------------------
# Equal to the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", list_archs())
def test_param_counts_match_the_reference(arch, reduced):
    _, _, rcfg, _ = _ref(arch, reduced)
    cfg = get_config(arch, reduced=reduced)
    assert cfg.param_count() == rcfg.param_count()
    assert cfg.active_param_count() == rcfg.active_param_count()


def test_shapes_match_the_reference():
    from repro import config as RC
    assert ASSIGNED_ARCHS == RC.ASSIGNED_ARCHS
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in RC.SHAPES.items()}
    from repro_torch.config import shape_applicable
    for arch in ASSIGNED_ARCHS:
        fam = get_config(arch).family
        for s in SHAPES.values():
            assert shape_applicable(arch, s, fam) == \
                RC.shape_applicable(arch, RC.SHAPES[s.name], fam)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_flops_match_the_reference(arch):
    RA, _, rcfg, _ = _ref(arch)
    cfg = get_config(arch)
    for shape in SHAPES.values():
        for remat in ("full", "none"):
            assert analytic.step_flops(cfg, shape, remat) == pytest.approx(
                RA.step_flops(rcfg, shape, remat), rel=1e-12)
        assert analytic.fwd_flops(cfg, shape.global_batch, shape.seq_len) \
            == pytest.approx(RA.fwd_flops(rcfg, shape.global_batch,
                                          shape.seq_len), rel=1e-12)
    assert analytic.fwd_flops(cfg, 4, 1, kv_len=32768) == pytest.approx(
        RA.fwd_flops(rcfg, 4, 1, kv_len=32768), rel=1e-12)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS + ("resnet32-cifar10",))
def test_bytes_match_the_reference(arch, mesh):
    from jax.sharding import AbstractMesh
    RA, RC, rcfg, rmodel = _ref(arch)
    cfg = reference_block(get_config(arch))     # rwkv6-7b: no Finch leaves
    names, sizes = MESHES[mesh]
    rmesh, pmesh = AbstractMesh(sizes, names), MeshView(names, sizes)
    for layout in LAYOUTS:
        for fsdp in (True, False):
            assert analytic.sharded_param_bytes(
                None, cfg, pmesh, 4, layout=layout, fsdp=fsdp) == \
                RA.sharded_param_bytes(rmodel, rcfg, rmesh, 4, layout=layout,
                                       fsdp=fsdp), (layout, fsdp)
        if cfg.family == "resnet":
            continue
        tcfg = TrainConfig(optimizer=OptimizerConfig(name="adamw"),
                           layout=layout)
        rtcfg = RC.TrainConfig(optimizer=RC.OptimizerConfig(name="adamw"),
                               layout=layout)
        for shape in SHAPES.values():
            for impl, rimpl in IMPLS.items():
                for serve_fsdp in (True, False):
                    got = analytic.step_hbm_bytes(
                        None, cfg, shape, pmesh, tcfg=tcfg, attn_impl=impl,
                        serve_fsdp=serve_fsdp)
                    want = RA.step_hbm_bytes(
                        rmodel, rcfg, RC.SHAPES[shape.name], rmesh,
                        tcfg=rtcfg, attn_impl=rimpl, serve_fsdp=serve_fsdp)
                    assert dataclasses.astuple(got) == \
                        dataclasses.astuple(want), (layout, shape.name, impl,
                                                    serve_fsdp)

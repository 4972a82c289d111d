"""The sharded training step of the port (``make_train_step`` with
``param_shardings`` and ``zero1_mask``, and ``grad_dtype="bfloat16"``)
on 1 and 2 CPU ranks joined by gloo: meshes (1, 1), (1, 2) and (2, 1).

Reduced starcoder2-3b in float32 starts from the reference's initial
weights (zero-initialised leaves given seeded values, as in
``test_torch_train.py``) bridged into the port, with the same numpy
batches. Three steps under each layout (``tp``, ``fsdp``, ``zero1``)
are held to the port's unsharded step and to the reference's plain
``make_train_step``, with ``test_torch_train.py``'s tolerances: loss and
``lr`` 1e-5 relative, ``grad_norm`` 1e-4 relative, every parameter 1e-5
relative + 3e-5 absolute, the moments 1e-5 relative + 1e-7 (``m``) or
1e-9 (``v``) absolute.

``grad_dtype="bfloat16"`` is held to float32 by the bound of the
reference's ``test_bf16_grads_close_to_fp32``: the cosine between the
bf16 and the float32 first-step parameter updates above 0.98, with and
without a mesh. ``zero1`` trains: its loss falls over the 12 steps of the
reference's ``test_zero1_trains``. Reduced moonshot-v1-16b-a3b under
``zero1`` with ``moe_impl="a2a"`` keeps its expert weights sharded (the
state's and the compute copy's) and equals the unsharded step whose MoE
layers run the a2a route's oracle on each rank's rows, with the same
tolerances.

The ranks are spawned once per mesh, in a module fixture.
"""
import dataclasses
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import config as C  # noqa: E402
from repro_torch import sharding as S  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.data import ShardedDataset  # noqa: E402
from repro_torch.launch import mesh as LM  # noqa: E402
from repro_torch.models import ffn  # noqa: E402
from repro_torch.models.axes import param_axes  # noqa: E402
from repro_torch.models.builder import build_model  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

ARCH, MOE_ARCH = "starcoder2-3b", "moonshot-v1-16b-a3b"
B, SEQ, STEPS, TRAIN_STEPS = 4, 16, 3, 12
MESHES = {"1x1": C.MeshConfig(data=1, model=1),
          "1x2": C.MeshConfig(data=1, model=2),
          "2x1": C.MeshConfig(data=2, model=1)}
LAYOUTS = ("tp", "fsdp", "zero1")
GRAD_DTYPES = ("float32", "bfloat16")


def _cfg(arch, **kw):
    return C.get_config(arch, reduced=True).replace(
        dtype="float32", attn_impl="torch", ssm_impl="torch",
        rwkv_impl="torch", **kw)


def _tcfg(**kw):
    """``test_torch_train.py``'s configuration."""
    return C.TrainConfig(
        optimizer=C.OptimizerConfig(name="adamw", lr=1e-3,
                                    weight_decay=1e-4, grad_clip=1.0),
        schedule=C.ScheduleConfig(kind="cosine", warmup_steps=2,
                                  total_steps=10), **kw)


def _trains_tcfg():
    """The reference's ``test_layout_training._tcfg``."""
    return C.TrainConfig(
        optimizer=C.OptimizerConfig(name="adamw", lr=1e-3),
        schedule=C.ScheduleConfig(kind="constant", warmup_steps=1,
                                  total_steps=100),
        checkpoint_every=0, layout="zero1", remat="none")


def _numpy(tree):
    return tree_map(lambda t: t.detach().numpy().copy(), tree)


def _oracle_rows(n):
    """apply_moe as the a2a route computes it for ``n`` ranks that hold
    the batch's rows in order: each rank's rows flattened and dispatched
    row-locally at the a2a capacity; the aux averaged over ranks."""
    def moe(p, x, cfg):
        outs, auxes = [], []
        for xr in x.chunk(n):
            b, s, d = xr.shape
            out, aux = ffn._rows(p, xr.reshape(1, b * s, d), cfg,
                                 ffn.a2a_capacity(b * s, cfg))
            outs.append(ffn._dense_branches(p, xr, out.view(b, s, d)))
            auxes.append(aux)
        return torch.cat(outs), sum(auxes) / n
    return moe


def _run(model, tc, params, batches, shardings=None, mesh=None, mask=None,
         lr_scale=0.5):
    """Steps from ``params`` (full float32 trees): metrics per step, the
    full parameters after each step and the full moments at the end."""
    full = params_from_numpy(params, model.cfg, "cpu", dtype=torch.float32)
    if shardings is not None:
        full = S.shard_tree(full, shardings)
    state = TS.init_state(model, tc, params=full)
    step = TS.make_train_step(model, tc, param_shardings=shardings,
                              zero1_mask=mask)
    unshard = ((lambda t: t) if shardings is None
               else (lambda t: S.unshard_tree(t, shardings)))
    metrics, after = [], []
    for b in batches:
        batch = {k: torch.from_numpy(v) for k, v in b.items()}
        with S.use_mesh(mesh, tc.layout):
            state, m = step(state, batch, lr_scale)
        metrics.append({k: float(v) for k, v in m.items()})
        after.append(_numpy(unshard(state.params)))
    return dict(metrics=metrics, params=after,
                m=_numpy(unshard(state.opt["m"])),
                v=_numpy(unshard(state.opt["v"])),
                local=[tuple(t.shape) for _, t in tree_leaves(state.params)],
                local_m=[tuple(t.shape) for _, t in
                         tree_leaves(state.opt["m"])])


def _worker(rank, mname, tree, batches, trains_batches, moe_tree,
            moe_batches):
    mesh = LM.make_mesh(MESHES[mname], device_type="cpu")
    cfg = _cfg(ARCH)
    model = build_model(cfg, "cpu")
    out = {}
    for layout in LAYOUTS:
        shardings = S.param_shardings(param_axes(cfg), cfg, mesh,
                                      layout=layout)
        for gd in GRAD_DTYPES:
            tc = _tcfg(layout=layout, grad_dtype=gd)
            out[(layout, gd)] = _run(model, tc, tree, batches, shardings,
                                     mesh)
    if mname == "1x2":
        tc = _trains_tcfg()
        shardings = S.param_shardings(param_axes(cfg), cfg, mesh,
                                      layout="zero1")
        out["trains"] = _run(model, tc, tree, trains_batches, shardings,
                             mesh, lr_scale=1.0)["metrics"]
    if mesh.size > 1:
        out["moe"] = _moe_zero1_a2a(mesh, moe_tree, moe_batches)
    return out


def _moe_zero1_a2a(mesh, tree, batches):
    cfg = _cfg(MOE_ARCH)
    axes = param_axes(cfg)
    shardings = S.param_shardings(axes, cfg, mesh, layout="zero1")
    mask = tree_map(lambda a: "experts" not in a, axes)
    tc = _tcfg(layout="zero1")
    seen = []
    a2a_local = ffn._a2a_local

    def spy(x, router, wi, wg, wo, **kw):
        seen.append((tuple(router.shape), tuple(wi.shape)))
        return a2a_local(x, router, wi, wg, wo, **kw)

    with mock.patch.object(ffn, "_a2a_local", spy):
        got = _run(build_model(cfg.replace(moe_impl="a2a"), "cpu"), tc,
                   tree, batches, shardings, mesh, mask)
    with mock.patch.object(ffn, "apply_moe", _oracle_rows(mesh.size)):
        want = _run(build_model(cfg, "cpu"), tc, tree, batches)
    return dict(got=got, want=want, seen=sorted(set(seen)),
                specs={p: s.spec for p, s in tree_leaves(shardings)})


# ---------------------------------------------------------------------------
# the reference's weights and batches, and the runs in this process
# ---------------------------------------------------------------------------

def _ref_tree(arch):
    import jax
    from repro import config as JC
    from repro.models import layers as JL
    from repro.models.builder import build_model as jax_build
    jm = jax_build(JC.get_config(arch, reduced=True).replace(
        dtype="float32", attn_impl="xla"))
    tree = jax.tree.map(np.asarray, JL.unbox(jm.init(jax.random.key(0))))
    rng = np.random.default_rng(0)

    def randomise(t):
        for key, val in t.items():
            if isinstance(val, dict):
                randomise(val)
            elif key in ("gamma", "bq", "bk", "bv"):
                t[key] = (val + rng.normal(0.0, 0.2, val.shape)).astype(
                    np.float32)
        return t
    return jm, randomise(tree)


def _batches(arch, n, seed=1):
    ds = ShardedDataset(_cfg(arch), global_batch=B, seq_len=SEQ, seed=seed,
                        device="cpu")
    return [{k: v.numpy() for k, v in ds.global_batch_at(i).items()}
            for i in range(n)]


@pytest.fixture(scope="module")
def runs():
    import jax
    import jax.numpy as jnp
    from repro import config as JC
    from repro.train import step as JTS
    jm, tree = _ref_tree(ARCH)
    _, moe_tree = _ref_tree(MOE_ARCH)
    batches = _batches(ARCH, STEPS)
    moe_batches = _batches(MOE_ARCH, STEPS)
    ds = ShardedDataset(_cfg(ARCH), global_batch=B, seq_len=SEQ,
                        device="cpu")
    trains_batches = [{k: v.numpy() for k, v in ds.global_batch_at(i)
                       .items()} for i in range(TRAIN_STEPS)]
    ranks = {name: LM.run_ranks(_worker, m.num_devices, name, tree, batches,
                                trains_batches, moe_tree, moe_batches)
             for name, m in MESHES.items()}
    model = build_model(_cfg(ARCH), "cpu")
    plain = {gd: _run(model, _tcfg(grad_dtype=gd), tree, batches)
             for gd in GRAD_DTYPES}
    # the reference's plain step on the same weights and batches
    opt = dict(name="adamw", lr=1e-3, weight_decay=1e-4, grad_clip=1.0)
    jt = JC.TrainConfig(optimizer=JC.OptimizerConfig(**opt),
                        schedule=JC.ScheduleConfig(kind="cosine",
                                                   warmup_steps=2,
                                                   total_steps=10))
    jstate = JTS.init_state(jm, jt, jax.random.key(0),
                            jax.tree.map(jnp.asarray, tree))
    jstep = jax.jit(JTS.make_train_step(jm, jt))
    ref = {"metrics": []}
    for b in batches:
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in
                                      b.items()}, jnp.float32(0.5))
        ref["metrics"].append({k: float(v) for k, v in jmet.items()})
    ref.update(params=jax.tree.map(np.asarray, jstate.params),
               m=jax.tree.map(np.asarray, jstate.opt["m"]),
               v=jax.tree.map(np.asarray, jstate.opt["v"]))
    return dict(ranks=ranks, plain=plain, ref=ref, tree=tree)


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _assert_close(got, want, rtol, atol):
    got, want = dict(tree_leaves(got)), dict(tree_leaves(want))
    assert got.keys() == want.keys()
    for path in got:
        np.testing.assert_allclose(got[path], want[path], rtol=rtol,
                                   atol=atol, err_msg=path)


def _assert_matches(run, want, final):
    """``run``'s metrics, final parameters and moments against ``want``'s
    (``final``: want's final params, m, v)."""
    for i, (m, w) in enumerate(zip(run["metrics"], want["metrics"])):
        assert rel(m["loss"], w["loss"]) < 1e-5, (i, "loss")
        assert rel(m["grad_norm"], w["grad_norm"]) < 1e-4, (i, "grad_norm")
        assert rel(m["lr"], w["lr"]) < 1e-5, (i, "lr")
        assert m["aux"] == w["aux"] == 0
    params, m, v = final
    _assert_close(run["params"][-1], params, 1e-5, 3e-5)
    _assert_close(run["m"], m, 1e-5, 1e-7)
    _assert_close(run["v"], v, 1e-5, 1e-9)


CASES = [(m, layout) for m in MESHES for layout in LAYOUTS]
IDS = [f"{m}-{layout}" for m, layout in CASES]


@pytest.mark.parametrize("mname,layout", CASES, ids=IDS)
def test_layout_steps_match_the_unsharded_step_and_the_reference(
        runs, mname, layout):
    plain, ref = runs["plain"]["float32"], runs["ref"]
    for rank_out in runs["ranks"][mname]:
        got = rank_out[(layout, "float32")]
        _assert_matches(got, plain, (plain["params"][-1], plain["m"],
                                     plain["v"]))
        _assert_matches(got, ref, (ref["params"], ref["m"], ref["v"]))
    # ZeRO: the moments are the rank's blocks, shaped as its params
    first = runs["ranks"][mname][0][(layout, "float32")]
    assert first["local_m"] == first["local"]
    full = [p.shape for _, p in tree_leaves(plain["params"][-1])]
    n = MESHES[mname].num_devices
    sharded = sum(a != tuple(b) for a, b in zip(first["local"], full))
    assert (sharded > 0) == (n > 1)


def _cosine(run, ref_run, init):
    flat = lambda t: np.concatenate([x.ravel() for _, x in tree_leaves(t)])  # noqa: E731
    p0 = flat(init)
    du, dw = flat(run["params"][0]) - p0, flat(ref_run["params"][0]) - p0
    return float(du @ dw / (np.linalg.norm(du) * np.linalg.norm(dw)))


@pytest.mark.parametrize("mname,layout", [(None, None)] + CASES,
                         ids=["no-mesh"] + IDS)
def test_bf16_grads_close_to_fp32(runs, mname, layout):
    if mname is None:
        pairs = [(runs["plain"]["bfloat16"], runs["plain"]["float32"])]
    else:
        pairs = [(r[(layout, "bfloat16")], r[(layout, "float32")])
                 for r in runs["ranks"][mname]]
    for bf16, fp32 in pairs:
        assert _cosine(bf16, fp32, runs["tree"]) > 0.98
        assert all(np.isfinite(m["loss"]) for m in bf16["metrics"])


@pytest.mark.parametrize("mname,layout", CASES, ids=IDS)
def test_sharded_bf16_step_matches_the_unsharded_bf16_step(runs, mname,
                                                            layout):
    """The bf16 compute copy is cast before the gather, the gradients
    reduced in bf16: on these meshes the sums are of one or two terms, so
    the sharded bf16 step follows the unsharded one closely (the update
    cosine above 0.9999)."""
    for r in runs["ranks"][mname]:
        assert _cosine(r[(layout, "bfloat16")], runs["plain"]["bfloat16"],
                       runs["tree"]) > 0.9999


def test_zero1_trains(runs):
    for r in runs["ranks"]["1x2"]:
        losses = [m["loss"] for m in r["trains"]]
        assert len(losses) == TRAIN_STEPS and all(map(np.isfinite, losses))
        assert losses[-1] < losses[0]


@pytest.mark.parametrize("mname", ["1x2", "2x1"])
def test_zero1_a2a_keeps_expert_weights_sharded(runs, mname):
    cfg = _cfg(MOE_ARCH)
    E, n = cfg.num_experts, MESHES[mname].num_devices
    for r in runs["ranks"][mname]:
        moe = r["moe"]
        # every expert stack is split over the whole mesh (E % n == 0),
        # the router is gathered whole: the a2a route saw only blocks
        for path in ("layers/moe/wi", "layers/moe/wg", "layers/moe/wo"):
            assert moe["specs"][path][1] == ("data", "model"), path
        assert moe["seen"] == [((cfg.d_model, E),
                                (E // n, cfg.d_model, cfg.d_ff))]
        got, want = moe["got"], moe["want"]
        shapes = dict(zip([p for p, _ in tree_leaves(got["params"][-1])],
                          got["local"]))
        assert shapes["layers/moe/wi"][1] == E // n
        assert got["local_m"] == got["local"]
        for i, (m, w) in enumerate(zip(got["metrics"], want["metrics"])):
            assert rel(m["loss"], w["loss"]) < 1e-5, i
            assert rel(m["aux"], w["aux"]) < 1e-5, i
            assert m["aux"] > 0
            assert rel(m["grad_norm"], w["grad_norm"]) < 1e-4, i
        _assert_close(got["params"][-1], want["params"][-1], 1e-5, 3e-5)
        _assert_close(got["m"], want["m"], 1e-5, 1e-7)
        _assert_close(got["v"], want["v"], 1e-5, 1e-9)


def test_step_options_are_checked():
    model = build_model(_cfg(ARCH), "cpu")
    with pytest.raises(ValueError, match="grad_dtype"):
        TS.make_train_step(model, dataclasses.replace(
            _tcfg(), grad_dtype="float16"))

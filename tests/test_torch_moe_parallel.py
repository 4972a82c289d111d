"""The expert-parallel MoE routes of the port (``moe_impl="ep"`` and
``"a2a"``) on 2 and 4 CPU ranks joined by gloo, meshes (1, 2), (2, 2)
and (1, 4), reduced moonshot-v1-16b-a3b and arctic-480b in float32.

The reference's own tests of these routes fail on this tree (jax 0.9
against a shard_map shim for 0.4.x), so the oracles are:

- ``ep`` (layout tp): the port's row-local ``apply_moe`` on the rank's
  rows; its aux loss is the mean over the data ranks of the row-local
  aux of each rank's rows;
- ``a2a`` (layouts fsdp, zero1): the row-local dispatch of each rank's
  flattened (1, B*S, D) tokens at the a2a capacity ``cap`` (from the
  rank's B*S tokens, not ``moe_capacity``: the routes drop differently,
  as the reference's do), its aux the mean over every rank; held also to
  the reference's ``apply_moe`` at the same capacity on CPU JAX, which
  needs no mesh;
- gradients through ``a2a``: the oracle's, per rank for the tokens and
  the router, summed over ranks for the expert weights (each rank's
  experts see every rank's tokens).

Tolerances (float32; the routes differ from their oracles only in the
shape of the expert einsums and in the collectives' summation order):
outputs and logits 1e-5 absolute (values of order 1), aux 1e-6
relative, gradients 1e-5 relative to the largest. Greedy tokens equal.

The ranks are spawned once per mesh, in a module fixture that runs
every scenario; the parametrised tests assert on its results.
"""
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import sharding as S  # noqa: E402
from repro_torch.config import MeshConfig, get_config  # noqa: E402
from repro_torch.launch import mesh as LM  # noqa: E402
from repro_torch.models import ffn  # noqa: E402
from repro_torch.models.builder import build_model  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

ARCHS = ("moonshot-v1-16b-a3b", "arctic-480b")
MESHES = {"1x2": MeshConfig(data=1, model=2),
          "2x2": MeshConfig(data=2, model=2),
          "1x4": MeshConfig(data=1, model=4)}
# (arch, num_experts override) per mesh: 8 experts divide every mesh
# (a2a over all axes); 6 divide the model axis of 2x2 only (a2a over
# model) and neither axis of 1x4 (both routes fall back)
CASES = {"1x2": [(a, 0) for a in ARCHS],
         "2x2": [(a, 0) for a in ARCHS] + [(ARCHS[0], 6)],
         "1x4": [(a, 0) for a in ARCHS] + [(ARCHS[0], 6)]}
B, SEQ, DECODE_STEPS = 4, 8, 4


def _cfg(arch, experts=0, **kw):
    cfg = get_config(arch, reduced=True).replace(
        dtype="float32", attn_impl="torch", ssm_impl="torch",
        rwkv_impl="torch", **kw)
    return cfg.replace(num_experts=experts) if experts else cfg


def _oracle_moe(p, x, cfg):
    """Row-local dispatch of the rank's flattened tokens at the a2a
    capacity (the a2a route's oracle)."""
    b, s, d = x.shape
    out, aux = ffn._rows(p, x.reshape(1, b * s, d), cfg,
                         ffn.a2a_capacity(b * s, cfg))
    return ffn._dense_branches(p, x, out.view(b, s, d)), aux


def _patched(fn):
    """``ffn.apply_moe`` replaced for the block (the model calls it
    through the module)."""
    return mock.patch.object(ffn, "apply_moe", fn)


def _rows_of(x, mesh, layout):
    return S.local_batch({"x": x}, mesh, layout)["x"]


def _routes(fn):
    ffn.moe_routes.clear()
    out = fn()
    return out, dict(ffn.moe_routes)


def _greedy(model, params, first):
    from repro_torch.train.step import make_serve_step
    step = make_serve_step(model)
    cache = model.init_cache(first.shape[0], 16)
    tok, toks = first, []
    for _ in range(DECODE_STEPS):
        tok, cache = step(params, cache, tok)
        toks.append(tok)
    return torch.cat(toks, 1)


def _worker(rank, mname):
    torch.manual_seed(0)
    mesh = LM.make_mesh(MESHES[mname], device_type="cpu")
    res = {}
    for arch, experts in CASES[mname]:
        cfg = _cfg(arch, experts)
        model = build_model(cfg, "cpu")
        params = model.init(model.generator(0), dtype=torch.float32)
        p = tree_map(lambda t: t[0], params["layers"]["moe"])
        rng = np.random.default_rng(1)
        x = torch.from_numpy(rng.normal(
            size=(B, SEQ, cfg.d_model)).astype(np.float32))
        r = {"p": p}
        ep_cfg, a2a_cfg = cfg.replace(moe_impl="ep"), cfg.replace(
            moe_impl="a2a")

        # ep under tp: the rank's data rows, replicated over model
        xt = _rows_of(x, mesh, "tp")
        with S.use_mesh(mesh, "tp"):
            (r["ep"], r["ep_aux"]), r["ep_routes"] = _routes(
                lambda: ffn.apply_moe(p, xt, ep_cfg))
            # a2a belongs to the token-unique layouts: falls back here
            (r["a2a_tp"], _), r["a2a_tp_routes"] = _routes(
                lambda: ffn.apply_moe(p, xt, a2a_cfg))
            # ep needs S > 1: a decode step falls back
            _, r["ep_s1_routes"] = _routes(
                lambda: ffn.apply_moe(p, xt[:, :1], ep_cfg))
        r["rows_tp"], r["rows_tp_aux"] = ffn.apply_moe(p, xt, cfg)

        # a2a under fsdp and zero1: the rank's own rows
        xf = _rows_of(x, mesh, "fsdp")
        r["xf"] = xf
        for layout in ("fsdp", "zero1"):
            with S.use_mesh(mesh, layout):
                (r[f"a2a_{layout}"], r[f"a2a_{layout}_aux"]), \
                    r[f"a2a_{layout}_routes"] = _routes(
                        lambda: ffn.apply_moe(p, xf, a2a_cfg))
        with S.use_mesh(mesh, "fsdp"):
            (r["ep_fsdp"], _), r["ep_fsdp_routes"] = _routes(
                lambda: ffn.apply_moe(p, xf, ep_cfg))
        r["oracle"], r["oracle_aux"] = _oracle_moe(p, xf, cfg)
        r["rows_f"], _ = ffn.apply_moe(p, xf, cfg)
        # outside a mesh both routes are the row-local path
        (r["nomesh_a2a"], _), r["nomesh_routes"] = _routes(
            lambda: (ffn.apply_moe(p, xf, a2a_cfg), ffn.apply_moe(
                p, xf, ep_cfg))[0])

        # gradients through a2a against the oracle's
        w = torch.from_numpy(np.random.default_rng(10 + rank).normal(
            size=tuple(xf.shape)).astype(np.float32))
        grads = {}
        for key, fn, ctx in (("a2a", lambda q, z: ffn.apply_moe(
                q, z, a2a_cfg), lambda: S.use_mesh(mesh, "zero1")),
                ("oracle", lambda q, z: _oracle_moe(q, z, cfg),
                 lambda: S.use_mesh(None))):
            leaves = {k: v.detach().clone().requires_grad_()
                      for k, v in p.items() if torch.is_tensor(v)}
            q = dict(p, **leaves)
            z = xf.clone().requires_grad_()
            with ctx():
                out, aux = fn(q, z)
            ((out * w).sum() + aux).backward()
            g = {k: v.grad for k, v in leaves.items()}
            # each rank's experts learn from every rank's tokens: compare
            # the expert weights' gradients summed over the ranks
            for k in ("wi", "wg", "wo"):
                torch.distributed.all_reduce(g[k])
            grads[key] = dict(g, x=z.grad)
        r["grads"] = grads

        # the model: logits of Model.apply and greedy decode tokens
        tokens = torch.from_numpy(np.random.default_rng(2).integers(
            0, cfg.vocab_size, size=(B, SEQ))).long()
        tt, tf = _rows_of(tokens, mesh, "tp"), _rows_of(tokens, mesh, "fsdp")
        with torch.no_grad():
            r["logits_rows_tp"] = model.apply(params, {"tokens": tt})[0]
            r["logits_rows_f"] = model.apply(params, {"tokens": tf})[0]
            with S.use_mesh(mesh, "tp"):
                (r["logits_ep"], _), r["model_ep_routes"] = _routes(
                    lambda: build_model(ep_cfg, "cpu").apply(
                        params, {"tokens": tt}))
                (r["logits_gspmd"], _), r["model_gspmd_routes"] = _routes(
                    lambda: model.apply(params, {"tokens": tt}))
            with S.use_mesh(mesh, "fsdp"):
                (r["logits_a2a"], r["logits_a2a_aux"]), \
                    r["model_a2a_routes"] = _routes(
                        lambda: build_model(a2a_cfg, "cpu").apply(
                            params, {"tokens": tf}))
            with _patched(_oracle_moe):
                r["logits_oracle"], r["logits_oracle_aux"] = model.apply(
                    params, {"tokens": tf})
        with S.use_mesh(mesh, "fsdp"):
            r["decode_a2a"], r["decode_routes"] = _routes(
                lambda: _greedy(build_model(a2a_cfg, "cpu"), params,
                                tf[:, :1]))
        with _patched(_oracle_moe):
            r["decode_oracle"] = _greedy(model, params, tf[:, :1])
        r["decode_rows"] = _greedy(model, params, tf[:, :1])
        res[(arch, experts)] = r
    return res


@pytest.fixture(scope="module")
def gloo():
    return {name: LM.run_ranks(_worker, MESHES[name].num_devices, name)
            for name in MESHES}


PARAMS = [(m, a, e) for m, cases in CASES.items() for a, e in cases]
IDS = [f"{m}-{a}" + (f"-E{e}" if e else "") for m, a, e in PARAMS]


def _close(a, b, tol=1e-5):
    return float((a - b).abs().max()) <= tol


def _ranks(gloo, mname, arch, experts):
    return [res[(arch, experts)] for res in gloo[mname]]


def _applies(mname, experts):
    mcfg = MESHES[mname]
    E = experts or 8
    return E % mcfg.model == 0, E % mcfg.num_devices == 0 or \
        E % mcfg.model == 0


@pytest.mark.parametrize("mname,arch,experts", PARAMS, ids=IDS)
def test_ep_equals_the_row_local_path(gloo, mname, arch, experts):
    ranks = _ranks(gloo, mname, arch, experts)
    ep_ok, _ = _applies(mname, experts)
    mcfg = MESHES[mname]
    for r in ranks:
        assert r["ep_routes"] == ({"ep": 1} if ep_ok else {"gspmd": 1})
        assert _close(r["ep"], r["rows_tp"])
    # the aux: mean over the data ranks of each rank's row-local aux
    if ep_ok:
        per_data = [ranks[d * mcfg.model]["rows_tp_aux"]
                    for d in range(mcfg.data)]
        want = float(sum(per_data)) / mcfg.data
        for r in ranks:
            assert float(r["ep_aux"]) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("mname,arch,experts", PARAMS, ids=IDS)
def test_a2a_equals_its_oracle(gloo, mname, arch, experts):
    ranks = _ranks(gloo, mname, arch, experts)
    _, a2a_ok = _applies(mname, experts)
    mean_aux = float(sum(r["oracle_aux"] for r in ranks)) / len(ranks)
    for r in ranks:
        for layout in ("fsdp", "zero1"):
            if a2a_ok:
                assert r[f"a2a_{layout}_routes"] == {"a2a": 1}
                assert _close(r[f"a2a_{layout}"], r["oracle"])
                assert float(r[f"a2a_{layout}_aux"]) == pytest.approx(
                    mean_aux, rel=1e-6)
            else:
                assert r[f"a2a_{layout}_routes"] == {"gspmd": 1}
                assert _close(r[f"a2a_{layout}"], r["rows_f"])


@pytest.mark.parametrize("mname,arch,experts", PARAMS, ids=IDS)
def test_a2a_oracle_is_the_references_dispatch_at_cap(gloo, mname, arch,
                                                      experts, monkeypatch):
    """The oracle against the reference's ``apply_moe`` (``_route_row``
    and its einsums) on the same flattened tokens, its capacity patched
    to the a2a ``cap``."""
    import jax.numpy as jnp
    from repro import config as JC
    from repro.models import ffn as JF
    jcfg = JC.get_config(arch, reduced=True).replace(dtype="float32")
    if experts:
        jcfg = jcfg.replace(num_experts=experts)
    for r in _ranks(gloo, mname, arch, experts):
        xf = r["xf"]
        b, s, d = xf.shape
        cap = ffn.a2a_capacity(b * s, _cfg(arch, experts))
        monkeypatch.setattr(JF, "moe_capacity", lambda S_, c: cap)
        jp = tree_map(lambda t: jnp.asarray(t.numpy()), r["p"])
        out, aux = JF.apply_moe(jp, jnp.asarray(xf.numpy().reshape(
            1, b * s, d)), jcfg)
        want = torch.from_numpy(np.array(out)).view(b, s, d)
        assert _close(r["oracle"], want)
        assert float(r["oracle_aux"]) == pytest.approx(float(aux), rel=1e-6)


@pytest.mark.parametrize("mname,arch,experts", PARAMS, ids=IDS)
def test_a2a_gradients_equal_the_oracles(gloo, mname, arch, experts):
    for r in _ranks(gloo, mname, arch, experts):
        got, want = r["grads"]["a2a"], r["grads"]["oracle"]
        assert got.keys() == want.keys()
        for k in want:
            scale = float(want[k].abs().max())
            assert scale > 0, k
            assert _close(got[k], want[k], 1e-5 * scale), k


@pytest.mark.parametrize("mname,arch,experts", PARAMS, ids=IDS)
def test_routes_fall_back_outside_a_mesh_and_in_the_wrong_layout(
        gloo, mname, arch, experts):
    for r in _ranks(gloo, mname, arch, experts):
        assert r["nomesh_routes"] == {"gspmd": 2}
        assert _close(r["nomesh_a2a"], r["rows_f"], 0.0)
        assert r["a2a_tp_routes"] == {"gspmd": 1}
        assert _close(r["a2a_tp"], r["rows_tp"], 0.0)
        assert r["ep_fsdp_routes"] == {"gspmd": 1}
        assert _close(r["ep_fsdp"], r["rows_f"], 0.0)
        assert r["ep_s1_routes"] == {"gspmd": 1}


@pytest.mark.parametrize("mname,arch,experts", PARAMS, ids=IDS)
def test_model_logits_and_decode_tokens_under_each_moe_impl(
        gloo, mname, arch, experts):
    cfg = _cfg(arch, experts)
    n_moe = cfg.num_layers - cfg.first_dense_layers
    ep_ok, a2a_ok = _applies(mname, experts)
    ranks = _ranks(gloo, mname, arch, experts)
    for r in ranks:
        assert r["model_gspmd_routes"] == {"gspmd": n_moe}
        assert _close(r["logits_gspmd"], r["logits_rows_tp"], 0.0)
        assert r["model_ep_routes"] == {"ep" if ep_ok else "gspmd": n_moe}
        assert _close(r["logits_ep"], r["logits_rows_tp"])
        assert r["model_a2a_routes"] == {"a2a" if a2a_ok else "gspmd": n_moe}
        want = r["logits_oracle"] if a2a_ok else r["logits_rows_f"]
        assert _close(r["logits_a2a"], want)
        assert r["decode_routes"] == {
            "a2a" if a2a_ok else "gspmd": n_moe * DECODE_STEPS}
        assert torch.equal(r["decode_a2a"], r["decode_oracle"])
        # at S = 1 no expert of the oracle overflows its capacity of 8:
        # the row-local decode gives the same tokens
        assert torch.equal(r["decode_a2a"], r["decode_rows"])
    if a2a_ok:
        mean_aux = float(sum(r["logits_oracle_aux"] for r in ranks)) \
            / len(ranks)
        for r in ranks:
            assert float(r["logits_a2a_aux"]) == pytest.approx(mean_aux,
                                                               rel=1e-6)


# --- layout rules (the reference's test_moe_parallel.py cases) -------------

M16 = S.MeshView(("data", "model"), (16, 16))


def test_fsdp_layout_shards_largest_dim_over_all_axes():
    cfg = get_config("starcoder2-3b")
    assert S.param_spec(("embed", "ff"), cfg, M16, (3072, 12288),
                        layout="fsdp") == (None, ("data", "model"))


def test_fsdp_layout_skips_layer_stacked_dim():
    cfg = get_config("starcoder2-3b")
    spec = S.param_spec(("layers", "embed", "ff"), cfg, M16,
                        (512, 3072, 12288), layout="fsdp")
    assert spec[0] is None


def test_zero1_expert_weights_stay_ep_sharded():
    cfg = get_config("moonshot-v1-16b-a3b")
    spec = S.param_spec(("experts", "embed", "ff"), cfg, M16,
                        (64, 2048, 1408), layout="zero1")
    assert spec[0] == "model"
    assert spec[1] == "data"


def test_tp_layout_unchanged_for_divisible_heads():
    cfg = get_config("granite-20b")
    assert S.param_spec(("embed", "heads", "head_dim"), cfg, M16,
                        (6144, 48, 128), layout="tp") == \
        ("data", "model", None)


def test_moe_impl_is_checked():
    cfg = get_config("moonshot-v1-16b-a3b", reduced=True)
    assert cfg.moe_impl == "gspmd"
    for impl in ("ep", "a2a"):
        assert cfg.replace(moe_impl=impl).moe_impl == impl
    with pytest.raises(ValueError, match="moe_impl"):
        cfg.replace(moe_impl="shard_map")


def test_row_local_path_refuses_expert_blocks():
    cfg = _cfg("moonshot-v1-16b-a3b")
    model = build_model(cfg, "cpu")
    p = tree_map(lambda t: t[0], model.init(model.generator(0),
                                            dtype=torch.float32)["layers"]
                 ["moe"])
    p = dict(p, **{k: p[k][:4] for k in ("wi", "wg", "wo")})
    with pytest.raises(ValueError, match="row-local MoE path needs all"):
        ffn.apply_moe(p, torch.zeros(1, 2, cfg.d_model), cfg)

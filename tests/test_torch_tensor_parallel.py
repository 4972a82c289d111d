"""The port's sharded programs under the ``tp`` and ``fsdp`` layouts on
CPU ranks joined by gloo: per-use gathers, tensor-parallel attention, MLP
and vocabulary, and the sharded serve step.

Meshes (data 2, model 2) and (pod 2, data 1, model 2) on 4 ranks, and
(data 1, model 2) on 2: each pod's pair of the 4, half the cases on
each. Reduced float32 configs: dense (starcoder2-3b:
query and KV heads split), its GQA cases (granite-20b: one KV head,
replicated, and two query heads a rank, fewer than its group of four;
starcoder2-3b with 3 query heads and 1 KV head: query heads replicated,
since 3 does not divide 2), MoE (moonshot-v1-16b-a3b: its shared experts
and dense first layer tensor-parallel; under tp the routed experts on
the row-local route run on the rank's 4 of 8 experts, or, with 3
experts, on the rank's block of ``ff``, and with ``moe_impl="ep"`` on
the (data 1, model 2) mesh on the ep route), vlm (qwen2-vl-7b) and
encdec (seamless-m4t-large-v2).
Weights are the port's seeded initial ones (RMS gammas and biases given
seeded values), bridged into the reference for its forward.

On every rank and layout: the forward's logits (the vocabulary blocks of
the model ranks put together) equal the reference's unsharded forward's;
three train steps equal the port's unsharded step (loss 1e-5 relative,
grad norm 1e-4 relative, parameters 1e-5 relative + 3e-5 absolute, as
``test_torch_layout_training.py`` holds them); a prompt of 3 tokens and 3
greedy tokens through the sharded prefill and serve steps equal the
unsharded ones token for token. The (data 1, model 2) mesh runs the
dense, MoE, vlm and encdec cases under both layouts and the GQA cases,
the 3-expert MoE and the ep route under tp (fsdp computes no head split); the (data 2,
model 2) mesh the dense case under both and the mqa, MoE and encdec
cases under tp; the (pod 2, data 1, model 2) mesh the dense and vlm
cases under tp, whose data axes it makes (pod, data). Plus what the programs hold in place of
whole copies: under tp every attention, MLP and vocabulary leaf that its
spec splits over ``model`` reaches the compute as the rank's block, and
a ragged query-head split is refused.

On fake process groups (``dryrun.fake_world``, a subprocess): the
(data 1, model 2) tp train cell of reduced starcoder2-3b, whose model
dims all divide 2, counts half the unsharded step's FLOPs within 2%, and
reduced moonshot-v1-16b-a3b's tp train and decode cells within 3%; the
(data 2, model 2) tp and fsdp train cells' collectives are per-layer
gathers (each layer leaf gathered once in the forward and once in the
remat recompute) and, under tp, one all-reduce after each row-parallel
product (two a layer, forward and recompute) besides the backward's.
"""
import collections
import json
import math
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import config as C  # noqa: E402
from repro_torch import sharding as S  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.data import ShardedDataset  # noqa: E402
from repro_torch.launch import mesh as LM  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.axes import param_axes  # noqa: E402
from repro_torch.models.builder import build_model  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

B, SEQ, STEPS, PROMPT, NEW = 4, 16, 3, 3, 3
MESHES = {"1x2": C.MeshConfig(data=1, model=2),
          "2x2": C.MeshConfig(data=2, model=2),
          "2x1x2": C.MeshConfig(pods=2, data=1, model=2)}
LAYOUTS = ("tp", "fsdp")
# (case, layout) pairs each mesh runs: the expert-parallel route (whose
# aux is each data rank's own, averaged, where the unsharded step's is
# over the whole batch) where the data axis is 1; the pod axis under tp,
# where it is one of the data axes (fsdp flattens every axis alike)
RUNS = {"1x2": [(c, lay) for c in ("dense", "moe", "vlm", "encdec")
                for lay in LAYOUTS]
        + [(c, "tp") for c in ("mqa", "qrep", "moe-ff", "moe-ep")],
        "2x2": [("dense", "fsdp")] + [(c, "tp") for c in (
            "dense", "mqa", "moe", "encdec")],
        "2x1x2": [(c, "tp") for c in ("dense", "vlm")]}
# case -> (arch, config overrides)
CASES = {
    "dense": ("starcoder2-3b", {}),
    "mqa": ("granite-20b", {}),
    "qrep": ("starcoder2-3b", dict(num_heads=3, num_kv_heads=1)),
    "moe": ("moonshot-v1-16b-a3b", {}),
    # 3 experts do not split over 2 ranks: tp splits their ff instead
    "moe-ff": ("moonshot-v1-16b-a3b", dict(num_experts=3)),
    "moe-ep": ("moonshot-v1-16b-a3b", dict(moe_impl="ep")),
    "vlm": ("qwen2-vl-7b", {}),
    "encdec": ("seamless-m4t-large-v2", {}),
}


def _cfg(case):
    arch, kw = CASES[case]
    return C.get_config(arch, reduced=True).replace(
        dtype="float32", attn_impl="torch", ssm_impl="torch",
        rwkv_impl="torch", **kw)


def _tcfg(layout="tp"):
    return C.TrainConfig(
        optimizer=C.OptimizerConfig(name="momentum", lr=0.1,
                                    weight_decay=1e-4, grad_clip=1.0),
        schedule=C.ScheduleConfig(kind="cosine", warmup_steps=2,
                                  total_steps=10), layout=layout)


def _numpy(tree):
    return tree_map(lambda t: t.detach().numpy().copy(), tree)


def _batches(case, n):
    ds = ShardedDataset(_cfg(case), global_batch=B, seq_len=SEQ, seed=1,
                        device="cpu")
    return [{k: v.numpy() for k, v in ds.global_batch_at(i).items()}
            for i in range(n)]


def _prompt(case):
    cfg = _cfg(case)
    rng = np.random.default_rng(2)
    out = {"tokens": rng.integers(0, cfg.vocab_size, size=(B, PROMPT))}
    if cfg.family == "encdec":
        out["frames"] = rng.normal(size=(B, 8, cfg.d_model)).astype(
            np.float32)
    return out


def _decode(model, params, prompt, rows, shardings=None, mesh=None,
            layout="tp"):
    """The prompt through the prefill step, then NEW greedy tokens, on
    ``rows`` of the batch; a sharded run makes the rank's cache block."""
    cfg = model.cfg
    tokens = torch.from_numpy(prompt["tokens"][rows])
    kv = None
    cache_sh = None
    if mesh is not None:
        _, _, kv = specs.attention_cache_block(cfg, B, PROMPT + NEW, mesh,
                                               layout)
        cache_sh = specs.cache_shardings(
            model.init_cache(B, PROMPT + NEW, device=specs.META,
                             enc_len=8 if cfg.family == "encdec" else 0),
            mesh, cfg)
    cache = model.init_cache(len(tokens), PROMPT + NEW, kv_heads=kv,
                             enc_len=8 if cfg.family == "encdec" else 0)
    if cfg.family == "encdec":
        frames = torch.from_numpy(prompt["frames"][rows])
        if mesh is None:
            cache = T.encode_for_decode(params, cfg, frames, cache)
        else:
            with S.use_mesh(mesh, layout):
                cache = T.encode_for_decode(
                    S.wrap_tree(params, shardings, layout), cfg, frames,
                    cache)
    kw = dict(param_shardings=shardings, cache_shardings=cache_sh,
              layout=layout)
    prefill = TS.make_prefill_step(model, **kw)
    serve = TS.make_serve_step(model, **kw)
    cache = prefill(params, cache, tokens[:, :-1],
                    [PROMPT - 1] * len(tokens))
    tok, out = tokens[:, -1:], []
    for _ in range(NEW):
        tok, cache = serve(params, cache, tok)
        out.append(tok)
    return torch.cat(out, 1).numpy()


def _gather_vocab(logits, mesh):
    """The model ranks' vocabulary blocks of the logits, in order."""
    g = mesh.group(("model",))
    parts = [torch.empty_like(logits) for _ in range(mesh.shape["model"])]
    torch.distributed.all_gather(parts, logits.contiguous(), group=g)
    return torch.cat(parts, -1)


def _run_case(case, mesh, layout, tree, batches, prompt):
    cfg = _cfg(case)
    model = build_model(cfg, "cpu")
    sh = S.param_shardings(param_axes(cfg), cfg, mesh, layout=layout)
    tc = _tcfg(layout)
    full = params_from_numpy(tree, cfg, "cpu", dtype=torch.float32)
    blocks = S.shard_tree(full, sh)
    out = {}
    # forward on the rank's rows (tp: the data ranks' rows)
    batch = {k: torch.from_numpy(v) for k, v in batches[0].items()}
    rows = S.local_batch(batch, mesh, layout)
    logits, _ = TS.make_forward(model, param_shardings=sh,
                                layout=layout)(blocks, rows)
    if logits.shape[-1] != cfg.vocab_size:
        logits = _gather_vocab(logits, mesh)
    dax = S.data_axes(mesh, layout)
    n, i = mesh.group_size(dax), mesh.index(dax)
    out["rows"] = list(range(i * B // n, (i + 1) * B // n))
    out["logits"] = logits.numpy()
    # train steps
    state = TS.init_state(model, tc, params=S.shard_tree(full, sh))
    step = TS.make_train_step(model, tc, param_shardings=sh)
    metrics = []
    for b in batches:
        with S.use_mesh(mesh, layout):
            state, m = step(state, {k: torch.from_numpy(v)
                                    for k, v in b.items()}, 0.5)
        metrics.append({k: float(v) for k, v in m.items()})
    out["metrics"] = metrics
    out["params"] = _numpy(S.unshard_tree(state.params, sh))
    # greedy decode on the rank's rows (the cache's data axes)
    cdax = S.data_axes(mesh)
    n, i = mesh.group_size(cdax), mesh.index(cdax)
    drows = list(range(i * B // n, (i + 1) * B // n))
    out["drows"] = drows
    out["tokens"] = _decode(model, blocks, prompt, drows, sh, mesh, layout)
    return out


def _splits(mesh):
    """Under tp, the dense and mqa cases' leaves of one layer and the
    embedding: path -> (block shape, compute shape, split axes)."""
    out = {}
    for case in ("dense", "mqa"):
        cfg = _cfg(case)
        sh = S.param_shardings(param_axes(cfg), cfg, mesh, layout="tp")
        blocks = S.shard_tree(build_model(cfg, "cpu").init(
            torch.Generator().manual_seed(0), dtype=torch.float32), sh)
        tree = S.wrap_tree(blocks, sh, "tp")
        layer = T.tree_unbind(tree["layers"])[0]
        for path, leaf in tree_leaves({"layer": layer,
                                       "embed": tree["embed"]}):
            out[f"{case}/{path}"] = (tuple(leaf.block.shape),
                                     tuple(S.take(leaf).shape),
                                     S.split_axes(leaf))
    return out


def _cases(mesh, mname, runs):
    res = {}
    for case, layout in runs:
        res[(case, layout)] = _run_case(case, mesh, layout, _tree(case),
                                        _batches(case, STEPS), _prompt(case))
    res["splits"] = _splits(mesh)
    if mname == "1x2":
        res["ragged"] = _ragged(mesh)
    return res


def _pair(mesh):
    """The (data 1, model 2) mesh of this rank's pod of a (pod 2, data 1,
    model 2) mesh: its groups over the axes without ``pod`` are those of
    the rank's pod alone, so the two pods run 2-rank meshes side by
    side."""
    keep = ("data", "model")
    return S.Mesh(axis_names=keep, sizes=(1, 2),
                  coords=tuple(c for a, c in zip(mesh.axis_names,
                                                 mesh.coords) if a in keep),
                  groups={k: g for k, g in mesh.groups.items()
                          if "pod" not in k}, device=mesh.device)


def _worker(rank):
    """The (data 2, model 2) and (pod 2, data 1, model 2) meshes in turn
    over 4 ranks, then the (data 1, model 2) cases, half of them on each
    pod's pair of ranks. The ranks make the seeded inputs themselves: a
    process that spawns ranks with megabytes of arguments starts them
    one after another."""
    out = {}
    for mname in ("2x2", "2x1x2"):
        mesh = LM.make_mesh(MESHES[mname], device_type="cpu")
        out[mname] = _cases(mesh, mname, RUNS[mname])
    pod = mesh.index(("pod",))
    out["1x2"] = _cases(_pair(mesh), "1x2", RUNS["1x2"][pod::2])
    return out


# ---------------------------------------------------------------------------
# the reference's weights, the unsharded runs, and the ranks
# ---------------------------------------------------------------------------

def _tree(case):
    """The port's seeded initial weights as a numpy tree (the reference's
    layout), the zero-initialised leaves given seeded values."""
    model = build_model(_cfg(case), "cpu")
    tree = _numpy(model.init(model.generator(0), dtype=torch.float32))
    rng = np.random.default_rng(0)

    def randomise(t):
        for key, val in t.items():
            if isinstance(val, dict):
                randomise(val)
            elif key in ("gamma", "bq", "bk", "bv"):
                t[key] = (val + rng.normal(0.0, 0.2, val.shape)).astype(
                    np.float32)
        return t
    return randomise(tree)


def _ref_logits(case, tree, batch):
    """The reference's unsharded forward on the bridged weights."""
    import jax
    import jax.numpy as jnp
    from repro import config as JC
    from repro.models.builder import build_model as jax_build
    arch, kw = CASES[case]
    jcfg = JC.get_config(arch, reduced=True).replace(
        dtype="float32", attn_impl="xla", **{k: v for k, v in kw.items()
                                             if k != "moe_impl"})
    jm = jax_build(jcfg)
    return np.asarray(jax.jit(jm.apply)(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()})[0])


def _unsharded(case, tree, batches, prompt):
    cfg = _cfg(case).replace(moe_impl="gspmd")      # no mesh: row-local
    model = build_model(cfg, "cpu")
    tc = _tcfg()
    state = TS.init_state(model, tc, params=params_from_numpy(
        tree, cfg, "cpu", dtype=torch.float32))
    step = TS.make_train_step(model, tc)
    metrics = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in b.items()}, 0.5)
        metrics.append({k: float(v) for k, v in m.items()})
    params = params_from_numpy(tree, cfg, "cpu", dtype=torch.float32)
    return dict(metrics=metrics, params=_numpy(state.params),
                tokens=_decode(model, params, prompt, list(range(B))))




@pytest.fixture(scope="module")
def runs():
    """The 4 ranks and the fake cells run at once in other processes
    while this one runs the reference's forward and the port's unsharded
    programs."""
    from concurrent.futures import ThreadPoolExecutor
    trees = {case: _tree(case) for case in CASES}
    batches = {case: _batches(case, STEPS) for case in CASES}
    prompts = {case: _prompt(case) for case in CASES}
    fake = _start_fake()
    with ThreadPoolExecutor(1) as pool:
        world = pool.submit(LM.run_ranks, _worker, 4)
        ref_logits = {case: _ref_logits(case, trees[case], batches[case][0])
                      for case in CASES if case != "moe-ep"}
        ref_logits["moe-ep"] = ref_logits["moe"]
        plain = {case: _unsharded(case, trees[case], batches[case],
                                  prompts[case]) for case in CASES}
        ranks = {name: [r[name] for r in world.result()] for name in MESHES}
    return dict(ranks=ranks, ref_logits=ref_logits, plain=plain,
                fake=_finish_fake(fake))


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


PARAMS = [(m, c, lay) for m in MESHES for c, lay in RUNS[m]]
IDS = [f"{m}-{c}-{lay}" for m, c, lay in PARAMS]


@pytest.mark.parametrize("mname,case,layout", PARAMS, ids=IDS)
def test_sharded_programs_equal_the_unsharded_ones(runs, mname, case,
                                                    layout):
    want = runs["plain"][case]
    ref = runs["ref_logits"][case]
    ran = [r[(case, layout)] for r in runs["ranks"][mname]
           if (case, layout) in r]
    assert len(ran) == MESHES[mname].num_devices
    for got in ran:
        np.testing.assert_allclose(got["logits"], ref[got["rows"]],
                                   rtol=1e-4, atol=1e-4)
        for i, (m, w) in enumerate(zip(got["metrics"], want["metrics"])):
            assert rel(m["loss"], w["loss"]) < 1e-5, (i, "loss")
            assert rel(m["grad_norm"], w["grad_norm"]) < 1e-4, (i, "norm")
            assert abs(m["aux"] - w["aux"]) <= 1e-5 * max(abs(w["aux"]), 1)
        p, q = dict(tree_leaves(got["params"])), dict(tree_leaves(
            want["params"]))
        assert p.keys() == q.keys()
        for path in p:
            np.testing.assert_allclose(p[path], q[path], rtol=1e-5,
                                       atol=3e-5, err_msg=path)
        assert np.array_equal(got["tokens"], want["tokens"][got["drows"]])


@pytest.mark.parametrize("mname", MESHES)
def test_tp_computes_split_leaves_as_the_ranks_blocks(runs, mname):
    """Under tp on a model axis of 2, the leaves split over ``model`` (the
    query and KV heads, ``ff``, the vocabulary) reach the compute as the
    rank's block, gathered over the data axes only; granite's single KV
    head is whole on every rank; no leaf is gathered over ``model``."""
    cfg = {c: _cfg(c) for c in ("dense", "mqa")}
    for r in runs["ranks"][mname]:
        sp = r["splits"]
        for path, (block, comp, axes) in sp.items():
            case, _, leaf = path.partition("/")
            full = dict(tree_leaves(param_shapes_1(cfg[case])))[leaf]
            if axes:
                assert axes == ("model",), path
                assert sum(c * 2 == f for c, f in zip(comp, full)) == 1, \
                    path
                assert all(c in (f, f // 2) for c, f in zip(comp, full))
            else:
                assert comp == full, path
        for leaf in ("layer/attn/wq", "layer/attn/wo", "layer/attn/bq",
                     "layer/attn/wk", "layer/mlp/wi", "layer/mlp/wo",
                     "embed/tok", "embed/out"):
            assert sp[f"dense/{leaf}"][2] == ("model",), leaf
        assert sp["mqa/layer/attn/wq"][2] == ("model",)
        assert sp["mqa/layer/attn/wk"][2] == ()


def param_shapes_1(cfg):
    """The leaf shapes of one layer (``layer/...``) and the embedding."""
    from repro_torch.models.axes import param_shapes
    shapes = param_shapes(cfg)
    out = {"embed": shapes["embed"]}
    out["layer"] = tree_map(lambda s: s[1:], shapes["layers"])
    return out


def test_a_ragged_query_head_split_is_refused(runs):
    """6 query heads over 2 ranks with 3 KV heads: rank 0's heads 0-2 read
    KV heads 0, 0 and 1, which no slice of whole groups gives."""
    res = [r["ragged"] for r in runs["ranks"]["1x2"]]
    assert all("unevenly" in r for r in res), res


def _ragged(mesh):
    cfg = _cfg("dense").replace(num_heads=6, num_kv_heads=3)
    sh = S.param_shardings(param_axes(cfg), cfg, mesh, layout="tp")
    blocks = S.shard_tree(build_model(cfg, "cpu").init(
        torch.Generator().manual_seed(0), dtype=torch.float32), sh)
    lp = T.tree_unbind(S.wrap_tree(blocks, sh, "tp")["layers"])[0]
    try:
        A.kv_range(lp["attn"], cfg)
    except ValueError as e:
        return str(e)
    return "accepted"


# ---------------------------------------------------------------------------
# fake process groups: counted FLOPs and collectives
# ---------------------------------------------------------------------------

SCRIPT = """
import sys, json
sys.path[:0] = [{src!r}, {tests!r}]
import test_torch_tensor_parallel as t
json.dump({{w: t._fake_main(w) for w in (2, 4)}}, open({out!r}, "w"))
"""


TRAIN = C.ShapeConfig("train_4k", "train", 32, 8)
DECODE = C.ShapeConfig("decode_32k", "decode", 32, 8)


def _fake_main(world):
    import dataclasses
    from repro_torch.launch import dryrun
    cfg = C.get_config("starcoder2-3b", reduced=True)
    mcfg = (C.MeshConfig(data=1, model=2) if world == 2
            else C.MeshConfig(data=2, model=2))
    res = {}
    with dryrun.fake_world(world):
        mesh = LM.make_mesh(mcfg, device_type="cpu")
        cells = [(layout, cfg, TRAIN, layout) for layout in LAYOUTS]
        if world == 2:
            moe = C.get_config("moonshot-v1-16b-a3b", reduced=True)
            cells += [("moe-train", moe, TRAIN, "tp"),
                      ("moe-decode", moe, DECODE, "tp")]
        for name, c, shape, layout in cells:
            tc = C.TrainConfig(optimizer=C.OptimizerConfig(name="adamw"),
                               layout=layout)
            counts = dryrun.count_cell(c, shape, tc, mesh)
            res[name] = {"flops": counts.flops, "colls": [
                dataclasses.astuple(c) for c in counts.collectives]}
    return res


def _start_fake():
    """Both fake worlds, one after the other, in one subprocess (a fake
    group is process-wide)."""
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    tmp = tempfile.mkdtemp()
    path = os.path.join(tmp, "fake.json")
    proc = subprocess.Popen(
        [sys.executable, "-c", SCRIPT.format(
            src=os.path.abspath(src),
            tests=os.path.dirname(os.path.abspath(__file__)), out=path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return tmp, path, proc


def _finish_fake(started):
    import shutil
    tmp, path, proc = started
    try:
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
        with open(path) as f:
            return {int(w): v for w, v in json.load(f).items()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


@pytest.fixture(scope="module")
def fake(runs):
    return runs["fake"]


def _unsharded_flops(arch, shape, rows):
    """FlopCounterMode's count of the unsharded train step, or serve step
    over a cache of ``shape.seq_len`` positions, on ``rows`` rows."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch import dryrun
    cfg = C.get_config(arch, reduced=True).replace(**dryrun.PLAIN_IMPLS)
    model = build_model(cfg, "cpu")
    tc = C.TrainConfig(optimizer=C.OptimizerConfig(name="adamw"))
    params = model.init(model.generator(0), dtype=torch.float32)
    counter = FlopCounterMode(display=False)
    if shape.kind == "decode":
        cache = model.init_cache(rows, shape.seq_len)
        with counter:
            TS.make_serve_step(model)(params, cache, torch.zeros(
                (rows, 1), dtype=torch.long))
        return counter.get_total_flops()
    state = TS.init_state(model, tc, params=params)
    with counter:
        TS.make_train_step(model, tc)(state, make_batch(
            cfg, rows, shape.seq_len, device="cpu"))
    return counter.get_total_flops()


def test_tp_halves_the_counted_flops_on_two_model_ranks(fake):
    """Every model dim of reduced starcoder2-3b divides 2: its tp train
    cell on (data 1, model 2) counts half the unsharded step's FLOPs
    (within 2%: norms, rotary and the loss run replicated); fsdp's count
    is the unsharded step's on the rank's rows."""
    whole = _unsharded_flops("starcoder2-3b", TRAIN, 8)
    assert fake[2]["tp"]["flops"] * 2 == pytest.approx(whole, rel=0.02)
    assert fake[2]["fsdp"]["flops"] == _unsharded_flops("starcoder2-3b",
                                                        TRAIN, 4)


@pytest.mark.parametrize("cell", ["moe-train", "moe-decode"])
def test_tp_splits_the_routed_experts(fake, cell):
    """Reduced moonshot-v1-16b-a3b under tp on (data 1, model 2), a train
    cell and a decode cell (S = 1), both on the row-local MoE route: the
    routed experts run on the rank's 4 of 8 experts, as its attention,
    shared experts, dense first layer and vocabulary run on its blocks,
    so the rank counts half the unsharded FLOPs (within 3%: the router
    and the norms run replicated). Experts gathered whole would count
    far more."""
    shape = TRAIN if cell == "moe-train" else DECODE
    whole = _unsharded_flops("moonshot-v1-16b-a3b", shape, 8)
    assert fake[2][cell]["flops"] * 2 == pytest.approx(whole, rel=0.03)


def _closed_form(layout):
    """The (kind, bytes, group size) multiset of reduced starcoder2-3b's
    train cell (8 rows of 32 tokens, float32) on a (data 2, model 2)
    mesh under per-use gathers:

    - every layer leaf is gathered over its spec's entries that are not
      ``model`` under tp (all of them under fsdp) once in the forward and
      once in the remat recompute of each layer, its gradient
      reduce-scattered once a layer; the embedding's ``tok`` and ``out``
      and the final norm once each (one use each: lookup, unembedding);
    - the gradients of the leaves whose specs do not name every data
      axis are all-reduced over the others; the metrics (8 bytes) and
      the squared norm (4 bytes) over all 4 ranks;
    - tp: each rank holds the data group's 4 rows, and the activations
      (4, 32, 64) in the config's bf16 are all-reduced over ``model``:
      after the vocabulary-parallel lookup, after each layer's attention
      output and MLP output, again after the attention output in each
      layer's recompute (the recompute stops once it has what the
      backward saved, before the MLP's sum), and, in the backward, at each
      layer's attention input and MLP input and at the unembedding's
      input; the loss adds a max (4 x 32 float32) and one sum of two
      (2 x 4 x 32 float32) over ``model``."""
    from repro_torch.models.axes import param_shapes
    cfg = C.get_config("starcoder2-3b", reduced=True)
    sizes = {"data": 2, "model": 2}
    mesh = S.MeshView(("data", "model"), (2, 2))
    sh = dict(tree_leaves(S.param_shardings(param_axes(cfg), cfg, mesh,
                                            layout=layout)))
    L = cfg.num_layers
    tp = ("model",) if layout == "tp" else ()
    dax = ("data",) if layout == "tp" else ("data", "model")
    want = collections.Counter()
    for path, shape in tree_leaves(param_shapes(cfg)):
        spec = sh[path].spec
        stacked = path.startswith("layers/")
        if stacked:
            shape, spec = shape[1:], spec[1:]
        cur = [n // math.prod(sizes[a] for a in S.entry_axes(e))
               for n, e in zip(shape, spec)]
        for dim, entry in enumerate(spec):
            axes = S.entry_axes(entry)
            if not axes or set(axes) <= set(tp):
                continue
            n = math.prod(sizes[a] for a in axes)
            want[("reduce-scatter", math.prod(cur) * 4, n)] += \
                L if stacked else 1
            cur[dim] *= n
            want[("all-gather", math.prod(cur) * 4, n)] += \
                2 * L if stacked else 1
        rest = [a for a in dax if a not in S.spec_axes(spec)]
        if rest:
            block = math.prod(n // math.prod(sizes[a] for a in
                                             S.entry_axes(e))
                              for n, e in zip(shape, spec))
            want[("all-reduce", block * 4 * (L if stacked else 1),
                  math.prod(sizes[a] for a in rest))] += 1
    want[("all-reduce", 8, 4)] += 1
    want[("all-reduce", 4, 4)] += 1
    if layout == "tp":
        act = 4 * 32 * cfg.d_model * 2
        want[("all-reduce", act, 2)] += (1 + 2 * L) + L + (2 * L + 1)
        want[("all-reduce", 4 * 32 * 4, 2)] += 1
        want[("all-reduce", 2 * 4 * 32 * 4, 2)] += 1
    return want


@pytest.mark.parametrize("layout", LAYOUTS)
def test_collectives_are_per_layer_gathers_and_row_parallel_reduces(
        fake, layout):
    got = collections.Counter(tuple(c) for c in fake[4][layout]["colls"])
    assert got == _closed_form(layout)


@pytest.mark.parametrize("arch,shape,layout,want", [
    # starcoder2's 2 KV heads do not divide 16: every rank holds both
    ("starcoder2-3b", "decode_32k", "tp", (8, 32768, 2)),
    # zamba2's 32 KV heads split over model; B = 1 splits the positions
    ("zamba2-1.2b", "long_500k", "tp", (1, 32768, 2)),
    ("gemma3-27b", "decode_32k", "tp", (8, 32768, 1)),
    # outside tp the attention computes every head: the cache holds all
    ("gemma3-27b", "decode_32k", "fsdp", (8, 32768, 16)),
])
def test_a_ranks_cache_block(arch, shape, layout, want):
    """``specs.attention_cache_block`` on the 16 x 16 production mesh,
    and the dense and paged caches ``Model`` builds for it."""
    cfg = C.get_config(arch)
    shp = C.SHAPES[shape]
    mesh = S.MeshView(("data", "model"), (16, 16))
    got = specs.attention_cache_block(cfg, shp.global_batch, shp.seq_len,
                                      mesh, layout)
    assert got == want
    model = build_model(cfg, "cpu")
    rows, positions, kv = got
    meta = torch.device("meta")
    cache = model.init_cache(rows, positions, device=meta, kv_heads=kv)
    leaf = cache["shared_kv" if cfg.family == "hybrid" else "kv"]["k"]
    assert tuple(leaf.shape[1:4]) == got
    paged = model.init_paged_cache(rows, positions, page_size=16,
                                   num_pages=8, device=meta, kv_heads=kv)
    pool = paged["shared_kv" if cfg.family == "hybrid" else "kv"]["k"]
    assert pool.shape[3] == kv

"""The recurrent layers' tensor-parallel programs under the ``tp`` layout,
on CPU ranks joined by gloo: zamba2's Mamba-2 layers and rwkv6's time and
channel mixers on the rank's heads.

Meshes (data 1, model 2), (data 2, model 2) and (data 1, model 4) on one
spawn of 4 ranks (the (data 1, model 2) cases run on each pod's pair of
a (pod 2, data 1, model 2) mesh, half on each). Reduced float32 configs:

- ``zamba2``: 8 Mamba heads; ``in_proj`` (296 columns: z, x, B, C, dt)
  and the conv (160 channels) split into blocks that do not follow the
  heads, so each rank's columns are regrouped by an uneven all-to-all;
- ``zamba2-sliced`` (model 4): ``ssm_state`` 15, so ``in_proj`` (294)
  and the conv (158) do not split over 4 ranks while the heads do: each
  rank slices its columns of the whole leaves, and their gradients are
  summed over the ranks;
- ``zamba2-whole`` (model 2): 3 heads of 64 (``ssm_expand`` 3) do not
  split over 2 ranks while the norm (192) and the conv (224) do: the
  layer computes on whole leaves;
- ``rwkv6``: 4 heads of 16, the channel mix on blocks of ``ff`` and of
  the channels;
- ``rwkv6-whole`` (model 4): 2 heads of 32, whose ``heads_flat`` (64)
  splits over 4 ranks while the heads do not: the time mix computes on
  whole leaves, the channel mix split.

Weights are the port's seeded initial ones, every zero- or
one-initialised leaf given seeded values, bridged into the reference for
its forward. On every rank: the forward's logits (the model ranks'
vocabulary blocks put together) equal the reference's unsharded
forward's (1e-4); three train steps equal the port's unsharded step
(loss 1e-5 relative, grad norm 1e-4 relative, every parameter as the
rank holds it 1e-5 relative + 3e-5 absolute, as
``test_torch_layout_training.py`` holds them: a gradient not summed over
``model`` makes the ranks' copies of a leaf differ); a prompt of 3
tokens and 3 greedy tokens through the sharded prefill and serve steps,
on the rank's cache block (``specs.cache_block``), equal the unsharded
ones token for token.

What the forward moves over ``model`` (``roofline.record_collectives``)
on the (data 1, model 2) and (data 1, model 4) meshes: per Mamba-2 layer
one uneven all-to-all for each of ``in_proj``, ``conv_w`` and
``conv_b`` (what the rank's columns need), one all-reduce of the gated
norm's sums of squares and one of the row-parallel output; per RWKV-6
layer one all-reduce of ``ln_x``'s sums of squares and one of the
time mix's output, one reduce-scatter and one all-gather of the channel
mix's activations; and no all-gather of a leaf. The rank's count of a
(data 1, model 2) train cell (``dryrun.count_cell`` on real tensors) is
half the unsharded step's, within the share of the work every rank
repeats.
"""
import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_tensor_parallel as tpt  # noqa: E402
from repro_torch import config as C  # noqa: E402
from repro_torch import sharding as S  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.data import ShardedDataset  # noqa: E402
from repro_torch.launch import mesh as LM  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models.axes import param_axes  # noqa: E402
from repro_torch.models.builder import build_model  # noqa: E402
from repro_torch.roofline import record_collectives  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

B, SEQ, STEPS, PROMPT, NEW = 4, 16, 3, 3, 3
MESHES = {"1x2": C.MeshConfig(data=1, model=2),
          "2x2": C.MeshConfig(data=2, model=2),
          "1x4": C.MeshConfig(data=1, model=4)}
CASES = {
    "zamba2": ("zamba2-1.2b", {}),
    "zamba2-sliced": ("zamba2-1.2b", dict(ssm_state=15)),
    "zamba2-whole": ("zamba2-1.2b", dict(ssm_expand=3, ssm_heads=3,
                                         ssm_head_dim=64)),
    "rwkv6": ("rwkv6-7b", {}),
    "rwkv6-whole": ("rwkv6-7b", dict(rwkv_head_dim=32)),
}
RUNS = {"1x2": ["zamba2", "rwkv6", "zamba2-whole"],
        "2x2": ["zamba2", "rwkv6"],
        "1x4": ["zamba2", "rwkv6", "zamba2-sliced", "rwkv6-whole"]}
TRAIN = C.ShapeConfig("train_4k", "train", 32, 8)
# leaves the reduced configs initialise to zeros or ones
SEEDED = ("gamma", "conv_b", "A_log", "D", "dt_bias", "norm", "w0", "ln_x")


def _cfg(case):
    arch, kw = CASES[case]
    return C.get_config(arch, reduced=True).replace(
        dtype="float32", attn_impl="torch", ssm_impl="torch",
        rwkv_impl="torch", **kw)


def _tree(case):
    model = build_model(_cfg(case), "cpu")
    tree = tpt._numpy(model.init(model.generator(0), dtype=torch.float32))
    rng = np.random.default_rng(0)

    def randomise(t):
        for key, val in t.items():
            if isinstance(val, dict):
                randomise(val)
            elif key in SEEDED:
                t[key] = (val + rng.normal(0.0, 0.2, val.shape)).astype(
                    np.float32)
        return t
    return randomise(tree)


def _batches(case):
    ds = ShardedDataset(_cfg(case), global_batch=B, seq_len=SEQ, seed=1,
                        device="cpu")
    return [{k: v.numpy() for k, v in ds.global_batch_at(i).items()}
            for i in range(STEPS)]


def _prompt(case):
    rng = np.random.default_rng(2)
    return rng.integers(0, _cfg(case).vocab_size, size=(B, PROMPT))


def _decode(model, params, prompt, rows, shardings=None, mesh=None):
    """The prompt through the prefill step, then NEW greedy tokens, on
    ``rows`` of the batch; a sharded run makes the rank's cache block."""
    tokens = torch.from_numpy(prompt[rows])
    block = {"batch": len(rows), "max_len": PROMPT + NEW}
    cache_sh = None
    if mesh is not None:
        block = specs.cache_block(model.cfg, B, PROMPT + NEW, mesh)
        assert block["batch"] == len(rows)
        cache_sh = specs.cache_shardings(
            model.init_cache(B, PROMPT + NEW, device=specs.META), mesh,
            model.cfg)
    cache = model.init_cache(**block)
    kw = dict(param_shardings=shardings, cache_shardings=cache_sh)
    prefill = TS.make_prefill_step(model, **kw)
    serve = TS.make_serve_step(model, **kw)
    cache = prefill(params, cache, tokens[:, :-1], [PROMPT - 1] * len(rows))
    tok, out = tokens[:, -1:], []
    for _ in range(NEW):
        tok, cache = serve(params, cache, tok)
        out.append(tok)
    return torch.cat(out, 1).numpy(), {path: tuple(t.shape) for path, t in
                                       tree_leaves(cache)}


def _run_case(case, mesh):
    cfg = _cfg(case)
    model = build_model(cfg, "cpu")
    sh = S.param_shardings(param_axes(cfg), cfg, mesh, layout="tp")
    full = params_from_numpy(_tree(case), cfg, "cpu", dtype=torch.float32)
    blocks = S.shard_tree(full, sh)
    batches = _batches(case)
    out = {}
    batch = {k: torch.from_numpy(v) for k, v in batches[0].items()}
    rows = S.local_batch(batch, mesh)
    with record_collectives() as colls:
        logits, _ = TS.make_forward(model, param_shardings=sh)(blocks, rows)
    out["colls"] = [(c.kind, c.out_bytes, c.group) for c in colls]
    if logits.shape[-1] != cfg.vocab_size:
        logits = tpt._gather_vocab(logits, mesh)
    n, i = mesh.group_size(("data",)), mesh.index(("data",))
    out["rows"] = list(range(i * B // n, (i + 1) * B // n))
    out["logits"] = logits.numpy()
    tc = tpt._tcfg()
    state = TS.init_state(model, tc, params=S.shard_tree(full, sh))
    step = TS.make_train_step(model, tc, param_shardings=sh)
    metrics = []
    for b in batches:
        with S.use_mesh(mesh):
            state, m = step(state, {k: torch.from_numpy(v)
                                    for k, v in b.items()}, 0.5)
        metrics.append({k: float(v) for k, v in m.items()})
    out["metrics"] = metrics
    out["params"] = tpt._numpy(S.unshard_tree(state.params, sh))
    out["tokens"], out["cache"] = _decode(model, blocks, _prompt(case),
                                          out["rows"], sh, mesh)
    return out


def _flops(mesh):
    from repro_torch.launch import dryrun
    tc = C.TrainConfig(optimizer=C.OptimizerConfig(name="adamw"))
    return {case: dryrun.count_cell(C.get_config(CASES[case][0],
                                                 reduced=True),
                                    TRAIN, tc, mesh, fake=False).flops
            for case in ("zamba2", "rwkv6")}


def _worker(rank):
    """The (data 2, model 2) and (data 1, model 4) meshes over the 4
    ranks, then the (data 1, model 2) cases on each pod's pair."""
    out = {}
    for mname in ("2x2", "1x4"):
        mesh = LM.make_mesh(MESHES[mname], device_type="cpu")
        out[mname] = {case: _run_case(case, mesh) for case in RUNS[mname]}
    pods = LM.make_mesh(C.MeshConfig(pods=2, data=1, model=2),
                        device_type="cpu")
    pair = tpt._pair(pods)
    pod = pods.index(("pod",))
    out["1x2"] = {case: _run_case(case, pair)
                  for case in RUNS["1x2"][pod::2]}
    if pod == 0:
        out["flops"] = _flops(pair)
    return out


def _ref_logits(case, batch):
    """The reference's unsharded forward on the bridged weights."""
    import jax
    import jax.numpy as jnp
    from repro import config as JC
    from repro.models.builder import build_model as jax_build
    arch, kw = CASES[case]
    jcfg = JC.get_config(arch, reduced=True).replace(dtype="float32", **kw)
    jm = jax_build(jcfg)
    return np.asarray(jax.jit(jm.apply)(
        jax.tree.map(jnp.asarray, _tree(case)),
        {k: jnp.asarray(v) for k, v in batch.items()})[0])


def _unsharded(case):
    cfg = _cfg(case)
    model = build_model(cfg, "cpu")
    tc = tpt._tcfg()
    state = TS.init_state(model, tc, params=params_from_numpy(
        _tree(case), cfg, "cpu", dtype=torch.float32))
    step = TS.make_train_step(model, tc)
    metrics = []
    for b in _batches(case):
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in b.items()}, 0.5)
        metrics.append({k: float(v) for k, v in m.items()})
    params = params_from_numpy(_tree(case), cfg, "cpu", dtype=torch.float32)
    tokens, _ = _decode(model, params, _prompt(case), list(range(B)))
    return dict(metrics=metrics, params=tpt._numpy(state.params),
                tokens=tokens)


@pytest.fixture(scope="module")
def runs():
    """The 4 ranks run in other processes while this one runs the
    reference's forwards and the port's unsharded programs, on one
    intra-op thread as each rank does (these small models' ops run
    several times slower on more)."""
    from concurrent.futures import ThreadPoolExecutor
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with ThreadPoolExecutor(1) as pool:
            world = pool.submit(LM.run_ranks, _worker, 4)
            ref = {case: _ref_logits(case, _batches(case)[0])
                   for case in CASES}
            plain = {case: _unsharded(case) for case in CASES}
            whole = {case: tpt._unsharded_flops(CASES[case][0], TRAIN, 8)
                     for case in ("zamba2", "rwkv6")}
            ranks = world.result()
    finally:
        torch.set_num_threads(threads)
    return dict(ranks=ranks, ref=ref, plain=plain, whole_flops=whole)


PARAMS = [(m, c) for m in MESHES for c in RUNS[m]]


def _ran(runs, mname, case):
    got = [r[mname][case] for r in runs["ranks"] if case in r[mname]]
    assert len(got) == MESHES[mname].num_devices
    return got


@pytest.mark.parametrize("mname,case", PARAMS,
                         ids=[f"{m}-{c}" for m, c in PARAMS])
def test_tp_recurrent_programs_equal_the_unsharded_ones(runs, mname, case):
    want, ref = runs["plain"][case], runs["ref"][case]
    for got in _ran(runs, mname, case):
        np.testing.assert_allclose(got["logits"], ref[got["rows"]],
                                   rtol=1e-4, atol=1e-4)
        for i, (m, w) in enumerate(zip(got["metrics"], want["metrics"])):
            assert tpt.rel(m["loss"], w["loss"]) < 1e-5, (i, "loss")
            assert tpt.rel(m["grad_norm"], w["grad_norm"]) < 1e-4, (i, "norm")
        p, q = dict(tree_leaves(got["params"])), dict(tree_leaves(
            want["params"]))
        assert p.keys() == q.keys()
        for path in p:
            np.testing.assert_allclose(p[path], q[path], rtol=1e-5,
                                       atol=3e-5, err_msg=path)
        assert np.array_equal(got["tokens"], want["tokens"][got["rows"]])


def _split(case, m):
    """The number of model ranks the case's recurrent heads split over."""
    cfg = _cfg(case)
    return specs.recurrent_split(cfg, S.MeshView(("data", "model"), (1, m)))


@pytest.mark.parametrize("mname,case", PARAMS,
                         ids=[f"{m}-{c}" for m, c in PARAMS])
def test_the_cache_holds_the_ranks_heads(runs, mname, case):
    """The rank's decode cache: the Mamba-2 ``state`` of its heads and
    ``conv`` of its channels [x, B, C]; the RWKV-6 ``wkv`` of its heads
    and the token shifts whole."""
    cfg = _cfg(case)
    m = MESHES[mname].model
    n = _split(case, m)
    assert n == {"zamba2-whole": 1, "rwkv6-whole": 1}.get(case, m)
    for got in _ran(runs, mname, case):
        c, rows = got["cache"], len(got["rows"])
        if cfg.family == "hybrid":
            H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
            assert c["blocks/state"][-4:] == (rows, H // n, N, P)
            assert c["blocks/conv"][-3:] == (
                rows, 3, cfg.ssm_d_inner // n + 2 * N)
        else:
            Dh = cfg.rwkv_head_dim
            assert c["wkv"][1:] == (rows, cfg.d_model // Dh // n, Dh, Dh)
            assert c["tok_t"][1:] == c["tok_c"][1:] == (rows, 1,
                                                        cfg.d_model)


def _forward_closed_form(case, m):
    """The (kind, bytes, group) multiset of what the forward of ``case``
    on (data 1, model m) moves over ``model`` (module docstring), rows
    B, float32."""
    cfg = _cfg(case)
    act = B * SEQ * cfg.d_model * 4
    want = collections.Counter()
    if cfg.family == "hybrid":
        d_in, N, H = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
        # in_proj's columns [z_i, x_i, B, C, dt_i], conv_w's and conv_b's
        # channels [x_i, B, C]
        for rows, cols in ((cfg.d_model, 2 * d_in // m + 2 * N + H // m),
                           (4, d_in // m + 2 * N), (1, d_in // m + 2 * N)):
            want[("all-to-all", rows * cols * 4, m)] += cfg.num_layers
        want[("all-reduce", B * SEQ * 4, m)] += cfg.num_layers
        want[("all-reduce", act, m)] += cfg.num_layers
        # the shared block: attention and MLP outputs, each invocation
        want[("all-reduce", act, m)] += 2 * (cfg.num_layers
                                             // cfg.shared_attn_every)
    else:
        L = cfg.num_layers
        want[("all-reduce", B * SEQ * 4, m)] += L
        want[("all-reduce", act, m)] += L
        want[("reduce-scatter", act // m, m)] += L
        want[("all-gather", act, m)] += L
    want[("all-reduce", act, m)] += 1           # the vocabulary lookup
    return want


@pytest.mark.parametrize("mname,case", [("1x2", "zamba2"), ("1x2", "rwkv6"),
                                        ("1x4", "zamba2"), ("1x4", "rwkv6")])
def test_forward_moves_what_the_ranks_heads_need(runs, mname, case):
    m = MESHES[mname].model
    for got in _ran(runs, mname, case):
        colls = collections.Counter(tuple(c) for c in got["colls"]
                                    if c[2] == m)
        assert colls == _forward_closed_form(case, m)


def test_sliced_leaves_move_nothing(runs):
    """``zamba2-sliced``: ``in_proj`` and the conv are whole on every
    rank, so the forward exchanges nothing; each rank slices its
    columns."""
    for got in _ran(runs, "1x4", "zamba2-sliced"):
        assert not [c for c in got["colls"] if c[0] == "all-to-all"]


@pytest.mark.parametrize("case,tol", [("zamba2", 0.05), ("rwkv6", 0.08)])
def test_tp_halves_the_recurrent_flops_on_two_model_ranks(runs, case, tol):
    """A (data 1, model 2) tp train cell of the reduced model counts half
    the unsharded step's FLOPs, plus what every rank repeats: zamba2's B
    and C columns of ``in_proj`` (32 of 296, 8% of a Mamba layer's
    products, fewer of the step's, whose shared block and vocabulary
    split) and their convolution, rwkv6's ``w_lora_a`` product (64 x 64
    of a layer's 49,152 multiply-adds a token, 8%), and both models'
    norms, lerps and loss."""
    got = runs["ranks"][0]["flops"][case]
    assert got * 2 == pytest.approx(runs["whole_flops"][case], rel=tol)
    assert got * 2 > runs["whole_flops"][case]

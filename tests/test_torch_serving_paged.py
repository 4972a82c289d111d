"""The port's paged serving engine against its dense engine and against
the reference's paged engine, token for token, on the same weights
(reduced configs, float32, nonzero gammas and biases), for the six
architectures the port serves: starcoder2-3b, gemma3-27b (sliding
windows), granite-20b (MQA), qwen2.5-14b (qkv bias), zamba2-1.2b
(hybrid) and rwkv6-7b (recurrent), with blocked and token prefill, at a
``max_len`` that is not a multiple of the page size.

Also: page accounting through the lifecycle, page-budget admission,
cache shipping (including packs that stay intact while the source
replica overwrites its pages), the fallback to replay, seeded lifecycle
schedules in the style of ``tests/test_serve_fuzz.py`` with the
reference's outcome on the same schedule, ``--queue slo`` (``SLOQueue``
with a capacity) and ``on_long_prompt="reject"`` against the reference.

Greedy parity runs in float32: bf16 logits can tie, and argmax would then
pick a side by rounding noise."""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.config import get_config as jax_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.builder import build_model as jax_build  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServeCluster as JCluster  # noqa: E402
from repro.serving import ServeEngine as JEngine  # noqa: E402
from repro.serving import SLOQueue as JSLOQueue  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.models.builder import build_model  # noqa: E402
from repro_torch.serving import (Request, ServeCluster, ServeEngine,  # noqa: E402
                                 SLOQueue)
from repro_torch.tree import tree_leaves  # noqa: E402

ARCHS = ("starcoder2-3b", "gemma3-27b", "granite-20b", "qwen2.5-14b",
         "zamba2-1.2b", "rwkv6-7b")
RANDOMISED = ("gamma", "bq", "bk", "bv", "norm", "ln_x", "conv_b", "A_log",
              "dt_bias", "D", "w0")
MAX_LEN, PAGE = 100, 16              # 100 is not a multiple of 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tests run many tiny ops: one intra-op thread is faster than
    a pool, most of all beside other test workers. Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randomise(tree, rng):
    for key, val in tree.items():
        if isinstance(val, dict):
            _randomise(val, rng)
        elif key in RANDOMISED:
            tree[key] = (val + rng.normal(0.0, 0.2, val.shape)).astype(
                np.float32)
    return tree


def _sides(arch):
    jcfg = jax_config(arch, reduced=True).replace(dtype="float32")
    jm = jax_build(jcfg)
    tree = _randomise(jax.tree.map(
        np.asarray, JL.unbox(jax.jit(jm.init)(jax.random.key(0)))),
        np.random.default_rng(0))
    jparams = jax.tree.map(jax.numpy.asarray, tree)
    cfg = get_config(arch, reduced=True).replace(
        dtype="float32", attn_impl="torch", ssm_impl="torch",
        rwkv_impl="torch")
    model = build_model(cfg, "cpu")
    params = params_from_numpy(tree, cfg, "cpu")
    jfns, tfns = {}, {}

    def make_jax(cache_impl="dense", **kw):
        kw.setdefault("max_batch", 3)
        kw.setdefault("max_len", MAX_LEN)
        kw.setdefault("prefill_block", 4)
        if cache_impl == "paged":
            kw.setdefault("page_size", PAGE)
        key = (cache_impl, kw["max_batch"], kw["max_len"],
               kw.get("page_size"), kw.get("prefill", "block"))
        eng = JEngine(jm, jparams, cache_impl=cache_impl,
                      shared_fns=jfns.get(key), **kw)
        jfns.setdefault(key, eng.shared_fns)
        return eng

    def make_torch(cache_impl="dense", **kw):
        kw.setdefault("max_batch", 3)
        kw.setdefault("max_len", MAX_LEN)
        kw.setdefault("prefill_block", 4)
        if cache_impl == "paged":
            kw.setdefault("page_size", PAGE)
        key = (cache_impl, kw["max_batch"], kw["max_len"],
               kw.get("page_size"), kw.get("prefill", "block"))
        eng = ServeEngine(model, params, cache_impl=cache_impl,
                          shared_fns=tfns.get(key), **kw)
        tfns.setdefault(key, eng.shared_fns)
        return eng

    return {"jax": SimpleNamespace(make=make_jax, Request=JRequest,
                                   Cluster=JCluster, SLOQueue=JSLOQueue,
                                   obs=jobs, vocab=jcfg.vocab_size),
            "torch": SimpleNamespace(make=make_torch, Request=Request,
                                     Cluster=ServeCluster, SLOQueue=SLOQueue,
                                     obs=obs, vocab=cfg.vocab_size,
                                     model=model)}


_CACHE = {}


@pytest.fixture(scope="module", params=ARCHS)
def sides(request):
    if request.param not in _CACHE:
        _CACHE.clear()
        _CACHE[request.param] = _sides(request.param)
    return _CACHE[request.param]


def _requests(side, plens, max_new, seed=0):
    rng = np.random.default_rng(seed)
    return [side.Request(rid=i,
                         prompt=rng.integers(1, side.vocab,
                                             size=(n,)).tolist(),
                         max_new_tokens=max_new)
            for i, n in enumerate(plens)]


def _waves(side, cache_impl, prefill):
    """More requests than slots, ragged prompts, one that runs into the
    cache's end (prompt 90 + 12 new > 100)."""
    eng = side.make(cache_impl, prefill=prefill)
    reqs = _requests(side, [5, 17, 9, 3, 90, 21], max_new=12)
    for r in reqs:
        assert eng.submit(r)
    eng.run_to_completion()
    assert all(r.done for r in reqs)
    if cache_impl == "paged":
        assert eng.allocator.used_pages == 0
        assert eng.allocator.peak_used > 0
    return [r.generated for r in reqs]


@pytest.mark.parametrize("prefill", ["block", "token"])
def test_paged_equals_dense_and_reference(sides, prefill):
    paged = _waves(sides["torch"], "paged", prefill)
    assert paged == _waves(sides["torch"], "dense", prefill)
    assert paged == _waves(sides["jax"], "paged", prefill)
    assert len(paged[4]) < 12                    # ended by the retire guard


# -- lifecycle, on the dense family and the recurrent one --------------------

@pytest.fixture(scope="module", params=["starcoder2-3b", "rwkv6-7b"])
def pair(request):
    return _sides(request.param)


def test_page_accounting_and_budget_admission(pair):
    """A pool too small for two worst cases at once: the second request
    waits at the head of the queue (no reorder), nothing is corrupted,
    and both finish with the reference's tokens; a request that can
    never fit is rejected at submit, not deadlocked."""
    outs = []
    for name in ("torch", "jax"):
        side = pair[name]
        eng = side.make("paged", max_batch=2, max_len=32, page_size=4,
                        num_pages=6)
        reqs = _requests(side, [9, 8], max_new=10, seed=4)
        for r in reqs:
            assert eng.submit(r)
        eng.step()
        assert eng.n_active == 1 and len(eng.queue) == 1
        assert eng.allocator.used_pages == 5 and eng.page_utilization == 5 / 6
        assert not eng.admission_headroom(reqs[1])
        eng.run_to_completion()
        big = side.Request(rid=9, prompt=[1] * 20, max_new_tokens=20)
        assert not eng.submit(big) and big.dropped
        outs.append(([r.generated for r in reqs], eng.requests_rejected,
                     eng.allocator.peak_used))
    assert outs[0] == outs[1]


def _ship(side, overwrite):
    """Decode two requests on a paged engine, drain it (packs built), then
    optionally reopen the source and serve other requests on the freed
    pages (overwriting them in place) before the packs land on a second
    engine."""
    src = side.make("paged", max_batch=2, max_len=32, page_size=4)
    reqs = _requests(side, [6, 5], max_new=10, seed=5)
    for r in reqs:
        src.submit(r)
    while not all(len(r.generated) >= 3 for r in reqs):
        src.step()
    n_pages = sum(len(src.allocator.pages_of(r.rid)) for r in reqs)
    migrated = src.begin_drain(grace_tokens=0)
    assert all(r._pack is not None for r in migrated)
    if overwrite and isinstance(src, ServeEngine):
        ptrs = {t.untyped_storage().data_ptr()
                for _, t in tree_leaves(src.cache)}
        for r in migrated:
            for path, leaf in tree_leaves(r._pack.tree):
                assert leaf.untyped_storage().data_ptr() not in ptrs, path
    if overwrite:
        src.draining = False
        others = _requests(side, [7, 7], max_new=6, seed=6)
        for i, r in enumerate(others):
            r.rid = 100 + i
            src.submit(r)
        src.run_to_completion()
    dst = side.make("paged", max_batch=2, max_len=32, page_size=4)
    for r in migrated:
        assert dst.submit(r)
    assert dst.n_active == 2                     # landed, not queued
    dst.run_to_completion()
    assert all(r.done for r in reqs)
    return ([r.generated for r in reqs], dst.tokens_replayed,
            dst.pages_shipped, dst.requests_imported, n_pages)


def _undisturbed(side, plens, max_new, seed, **kw):
    eng = side.make("paged", max_batch=2, max_len=32, page_size=4, **kw)
    reqs = _requests(side, plens, max_new, seed)
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    return [r.generated for r in reqs]


@pytest.mark.parametrize("overwrite", [False, True])
def test_cache_shipping_lands_without_replay(pair, overwrite):
    """Shipped requests resume where they left off (no replay, every page
    shipped) with the undisturbed tokens, even after the source replica
    reused and overwrote the pages the packs came from."""
    tokens, replayed, shipped, imported, n_pages = _ship(pair["torch"],
                                                         overwrite)
    assert replayed == 0 and imported == 2 and shipped == n_pages > 0
    assert tokens == _undisturbed(pair["torch"], [6, 5], 10, 5)
    assert (tokens, replayed, shipped) == _ship(pair["jax"], overwrite)[:3]


def test_shipping_falls_back_to_replay_when_target_full(pair):
    """A target without a free slot cannot land the pack: the request
    queues for replay, which is charged then, and still finishes with
    the undisturbed tokens, as in the reference."""
    outs = []
    for name in ("torch", "jax"):
        side = pair[name]
        src = side.make("paged", max_batch=2, max_len=32, page_size=4)
        reqs = _requests(side, [6, 5], max_new=10, seed=5)
        for r in reqs:
            src.submit(r)
        while not all(len(r.generated) >= 3 for r in reqs):
            src.step()
        migrated = src.begin_drain(grace_tokens=0)
        dst = side.make("paged", max_batch=1, max_len=32, page_size=4)
        blocker = side.Request(rid=50, prompt=[3, 4, 5], max_new_tokens=4)
        dst.submit(blocker)
        dst.step()
        for r in migrated:
            assert dst.submit(r)
        dst.run_to_completion()
        outs.append(([r.generated for r in reqs], dst.tokens_replayed,
                     dst.requests_imported, blocker.generated))
    assert outs[0] == outs[1]
    assert outs[0][1] > 0 and outs[0][2] == 0
    assert outs[0][0] == _undisturbed(pair["torch"], [6, 5], 10, 5)


def test_shared_fns_key_rejects_geometry_mismatch(pair):
    side = pair["torch"]
    eng = side.make("paged", max_batch=2, max_len=32, page_size=4)
    with pytest.raises(ValueError, match="shared_fns"):
        ServeEngine(side.model, eng.params, max_batch=2, max_len=32,
                    cache_impl="paged", page_size=8,
                    shared_fns=eng.shared_fns)
    with pytest.raises(ValueError, match="cache_impl"):
        ServeEngine(side.model, eng.params, max_batch=2, max_len=32,
                    cache_impl="ring")


def test_paged_revoke_slot_and_slot_reuse(pair):
    """A fired slot regenerates from scratch on recycled pages; the row's
    next occupant sees nothing of the previous one (reference tokens)."""
    outs = []
    for name in ("torch", "jax"):
        side = pair[name]
        eng = side.make("paged", max_batch=2, max_len=32, page_size=4)
        reqs = _requests(side, [5, 6, 4, 7], max_new=6, seed=7)
        for r in reqs:
            eng.submit(r)
        while not all(r is not None and r.generated for r in eng.slots):
            eng.step()
        assert eng.revoke_slot(0) is reqs[0]
        eng.run_to_completion()
        outs.append(([r.generated for r in reqs], eng.tokens_lost,
                     reqs[0].timing.n_restarts))
    assert outs[0] == outs[1] and outs[0][1] > 0


# -- seeded lifecycle schedules (tests/test_serve_fuzz.py) -------------------

F_BATCH, F_LEN, F_PAGE, F_OPS, F_REQS = 2, 32, 4, 50, 10


def _fuzz_requests(side, seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, F_REQS + 1))
    return [side.Request(rid=i,
                         prompt=rng.integers(1, side.vocab,
                                             size=int(rng.integers(2, 7))
                                             ).tolist(),
                         max_new_tokens=int(rng.integers(3, 8)))
            for i in range(n)]


def _schedule(seed, n_reqs):
    rng = np.random.default_rng(seed + 1000)
    ops, submitted = [], 0
    for _ in range(F_OPS):
        r = rng.random()
        if r < 0.40 and submitted < n_reqs:
            ops.append(("submit", submitted))
            submitted += 1
        elif r < 0.80:
            ops.append(("step", 0))
        elif r < 0.88:
            ops.append(("warn", int(rng.integers(0, 8)),
                        int(rng.integers(0, 3))))
        elif r < 0.94:
            ops.append(("revoke_slot", int(rng.integers(0, 8)),
                        int(rng.integers(0, F_BATCH))))
        else:
            ops.append(("hard_revoke", int(rng.integers(0, 8))))
    ops.extend(("submit", i) for i in range(submitted, n_reqs))
    return ops


def _check_invariants(cl, completed):
    occupied = [r.rid for e in cl.replicas for r in e.slots if r is not None]
    assert len(occupied) == len(set(occupied))
    for e in cl.replicas:
        assert all(r.rid not in completed for r in e.slots if r is not None)
        if e.allocator is not None:
            a = e.allocator
            assert a.free_pages + a.used_pages == a.num_pages
            held = {rid for rid in range(F_REQS) if a.holds(rid)}
            assert held == {r.rid for r in e.slots if r is not None}
            pages = [p for rid in held for p in a.pages_of(rid)]
            assert len(pages) == len(set(pages))


def _fuzz_run(side, reqs, ops, cache_impl):
    cl = side.Cluster(lambda: side.make(cache_impl, max_batch=F_BATCH,
                                        max_len=F_LEN, page_size=F_PAGE)
                      if cache_impl == "paged" else
                      side.make(max_batch=F_BATCH, max_len=F_LEN),
                      n_replicas=2)
    completed = {}
    for op in ops:
        live = [i for i, e in enumerate(cl.replicas) if not e.draining]
        if op[0] == "submit":
            assert cl.submit(reqs[op[1]])
        elif op[0] == "step":
            cl.step()
        elif op[0] == "warn" and len(live) >= 2:
            cl.warn(live[op[1] % len(live)], grace_tokens=op[2])
            cl.scale_to(2)
        elif op[0] == "revoke_slot" and live:
            cl.replicas[live[op[1] % len(live)]].revoke_slot(op[2])
        elif op[0] == "hard_revoke" and len(live) >= 2:
            cl.revoke(live[op[1] % len(live)])
            cl.scale_to(2)
        for r in reqs:
            if r.done:
                assert completed.setdefault(r.rid, tuple(r.generated)) \
                    == tuple(r.generated)
        _check_invariants(cl, completed)
    cl.run_to_completion(max_steps=5000)
    assert all(r.done for r in reqs)
    return ({r.rid: tuple(r.generated) for r in reqs}, cl.tokens_lost,
            cl.tokens_replayed, cl.pages_shipped, cl.requests_imported)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lifecycle_schedules_dense_paged_solo_and_reference(pair, seed):
    t = pair["torch"]
    ops = _schedule(seed, len(_fuzz_requests(t, seed)))
    dense = _fuzz_run(t, _fuzz_requests(t, seed), ops, "dense")
    paged = _fuzz_run(t, _fuzz_requests(t, seed), ops, "paged")
    assert dense[0] == paged[0]
    for ref in _fuzz_requests(t, seed):
        solo = t.make(max_batch=1, max_len=F_LEN)
        solo.submit(ref)
        solo.run_to_completion()
        assert dense[0][ref.rid] == tuple(ref.generated)
    j = pair["jax"]
    assert paged == _fuzz_run(j, _fuzz_requests(j, seed), ops, "paged")
    assert dense == _fuzz_run(j, _fuzz_requests(j, seed), ops, "dense")


# -- the SLO queue and long-prompt rejection ---------------------------------

def _slo_run(side, cache_impl):
    """An ``SLOQueue`` with a backlog bound on a stepped clock: priorities
    and deadlines reorder admission, pushes past the capacity and
    expired requests are shed."""
    clock = {"t": 0.0}
    eng = side.make(cache_impl, max_batch=2, max_len=32,
                    **({"page_size": 4} if cache_impl == "paged" else {}),
                    queue=side.SLOQueue(capacity=3),
                    clock=lambda: clock["t"])
    rng = np.random.default_rng(8)
    reqs = []
    for i in range(9):
        reqs.append(side.Request(
            rid=i, prompt=rng.integers(1, side.vocab, size=(4,)).tolist(),
            max_new_tokens=4, priority=int(rng.integers(0, 3)),
            deadline_s=float(rng.uniform(0.5, 4.0)), arrival_s=clock["t"]))
        accepted = eng.submit(reqs[-1])
        if i % 2:
            eng.step()
            clock["t"] += 0.25
        assert accepted != reqs[-1].dropped
    while eng.has_work():
        eng.step()
        clock["t"] += 0.25
    return ([(r.rid, r.done, r.dropped, r.generated, r.timing.t_complete)
             for r in reqs], eng.requests_rejected)


@pytest.mark.parametrize("cache_impl", ["dense", "paged"])
def test_slo_queue_admission_matches_reference(pair, cache_impl):
    got = _slo_run(pair["torch"], cache_impl)
    assert got == _slo_run(pair["jax"], cache_impl)
    assert got[1] > 0 and any(done for _, done, *_ in got[0])


def _long_prompt(side, mode):
    rec = side.obs.Recorder(deterministic=True)
    kw = {} if mode is None else {"on_long_prompt": mode}
    eng = side.make(max_batch=2, max_len=16, recorder=rec, **kw)
    long_req = side.Request(rid=0, prompt=list(range(1, 31)),
                            max_new_tokens=3)
    short = side.Request(rid=1, prompt=[5, 6, 7], max_new_tokens=3)
    ok = [eng.submit(long_req), eng.submit(short)]
    eng.run_to_completion()
    rejects = [e.args.get("reason") for e in rec.events
               if e.name == side.obs.EV_REJECT]
    return (ok, long_req.dropped, len(long_req.prompt), long_req.generated,
            short.generated, eng.requests_rejected, rejects,
            rec.metrics.total("requests_rejected"))


@pytest.mark.parametrize("mode", [None, "reject"])
def test_on_long_prompt_matches_reference(pair, mode):
    got = _long_prompt(pair["torch"], mode)
    assert got == _long_prompt(pair["jax"], mode)
    if mode == "reject":
        assert got[:3] == ([False, True], True, 30)
        assert got[5:] == (1, ["long_prompt"], 1)
    else:
        assert got[:3] == ([True, True], False, 15) and got[5] == 0
    with pytest.raises(ValueError, match="on_long_prompt"):
        pair["torch"].make(on_long_prompt="drop")

"""Decode attention over a KV cache split on its sequence axis (the
long-context cell's layout: B = 1, the positions over the data ranks),
on 2 and 4 CPU ranks joined by gloo, mesh (data n, model 1).

- The plain decode kernel's partials: with ``offset``, a block of the
  cache gives the (m, l) of its visible keys, and the blocks' outputs
  merged by (m, l) equal the unsplit call, for every window.
- ``attention.attend_decode`` on each rank's block of a float32 cache
  (B = 6 rows: a length ending in each block, one longer than the cache,
  one with no key at all; windows 0, one that straddles a block edge,
  and one that leaves the first blocks with no visible key) equals the
  unsplit plain decode to 1e-5, and a row with no visible key anywhere
  gives 0.
- ``attention.update_cache`` writes the new token only on the rank
  whose block holds ``pos``; the blocks put together equal the unsplit
  cache after the unsplit write.
- End to end: reduced zamba2-1.2b (its shared attention block) and
  starcoder2-3b, B = 1, through the sharded prefill and serve steps with
  the cache split on its positions (``specs.cache_shardings``'s spec),
  give the unsplit steps' tokens, the prompt and the generated tokens
  crossing block edges.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import config as C  # noqa: E402
from repro_torch import sharding as S  # noqa: E402
from repro_torch.kernels.decode_attention import ref  # noqa: E402
from repro_torch.launch import mesh as LM  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models.axes import param_axes  # noqa: E402
from repro_torch.models.builder import build_model  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402

SEQ, H, KV, D = 24, 4, 2, 16
WINDOWS = (0, 5, 9)
WORLDS = (2, 4)
PROMPT, NEW, MAX_LEN = 5, 4, 12


def _inputs(n):
    """q (B, 1, H, D), caches (B, SEQ, KV, D), and the rows' current
    index ``pos`` (B,): a length ending in each of the n blocks, one past
    the cache, one with no key (pos = -1)."""
    rng = np.random.default_rng(n)
    blk = SEQ // n
    pos = [b * blk + (blk // 2) for b in range(n)] + [SEQ + 3, -1]
    B = len(pos)
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    k = rng.normal(size=(B, SEQ, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, SEQ, KV, D)).astype(np.float32)
    return q, k, v, np.array(pos, dtype=np.int32)


def _attend_worker(rank, n, mesh):
    q, k, v, pos = (torch.from_numpy(a) for a in _inputs(n))
    blk = SEQ // n
    mine = slice(rank * blk, (rank + 1) * blk)
    out = {}
    with S.use_kv_seq(mesh, ("data",)):
        assert A.seq_offset(k[:, mine]) == rank * blk
        for w in WINDOWS:
            out[w] = A.attend_decode(q, k[:, mine].contiguous(),
                                     v[:, mine].contiguous(), pos,
                                     window=w, impl="torch", seq=True)
    # the write of a new token at each row's pos, on the rank's block
    kb, vb = k[:, mine].clone(), v[:, mine].clone()
    new_k = torch.full((len(pos), 1, KV, D), 7.0)
    new_v = torch.full((len(pos), 1, KV, D), -7.0)
    A.update_cache(kb, vb, new_k, new_v, pos, offset=rank * blk)
    out["k"], out["v"] = kb, vb
    out["changed"] = [bool((kb[b] != k[b, mine]).any())
                      for b in range(len(pos))]
    return out


def _worker(rank, n):
    mesh = LM.make_mesh(C.MeshConfig(data=n, model=1), device_type="cpu")
    return dict(_attend_worker(rank, n, mesh),
                model=_model_worker(rank, n, mesh))


@pytest.fixture(scope="module")
def ranks():
    """Each world's ranks, spawned once for the attention and the model
    checks; the worlds at once."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(WORLDS)) as pool:
        futures = {n: pool.submit(LM.run_ranks, _worker, n, n)
                   for n in WORLDS}
        return {n: f.result() for n, f in futures.items()}


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("window", WINDOWS)
def test_split_decode_equals_the_unsplit_plain_decode(ranks, n, window):
    q, k, v, pos = (torch.from_numpy(a) for a in _inputs(n))
    want = A.attend_decode(q, k, v, pos, window=window, impl="torch")
    for r in ranks[n]:
        got = r[window]
        assert got.shape == want.shape and got.dtype == want.dtype
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # the row with no visible key anywhere gives 0
    assert torch.equal(ranks[n][0][window][-1], torch.zeros(1, H, D))


@pytest.mark.parametrize("n", WORLDS)
def test_only_the_owning_rank_takes_the_write(ranks, n):
    q, k, v, pos = (torch.from_numpy(a) for a in _inputs(n))
    k, v = k.clone(), v.clone()
    A.update_cache(k, v, torch.full((len(pos), 1, KV, D), 7.0),
                   torch.full((len(pos), 1, KV, D), -7.0), pos)
    torch.testing.assert_close(torch.cat([r["k"] for r in ranks[n]], 1), k,
                               rtol=0, atol=0)
    torch.testing.assert_close(torch.cat([r["v"] for r in ranks[n]], 1), v,
                               rtol=0, atol=0)
    blk = SEQ // n
    for rank, r in enumerate(ranks[n]):
        owner = [0 <= p - rank * blk < blk for p in pos.tolist()]
        assert r["changed"] == owner


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("blocks", [2, 3, 4])
def test_plain_partials_merge_to_the_unsplit_call(blocks, window):
    """``decode_attention_plain`` with ``offset`` and ``return_lse`` on
    each block, merged by (m, l) (``ref.merge_partials``, as the card's
    smoke test merges the kernel's), equals the unsplit call; a block
    with no visible key gives m = -inf and l = 0."""
    q, k, v, pos = (torch.from_numpy(a) for a in _inputs(4))
    q, kt, vt = q[:, 0], k.transpose(1, 2), v.transpose(1, 2)
    lengths = pos + 1
    want = ref.decode_attention_plain(q, kt, vt, lengths, window=window)
    blk = SEQ // blocks
    parts = [ref.decode_attention_plain(
        q, kt[:, :, i * blk:(i + 1) * blk], vt[:, :, i * blk:(i + 1) * blk],
        lengths, window=window, offset=i * blk, return_lse=True)
        for i in range(blocks)]
    got = ref.merge_partials(torch.stack([o for o, _ in parts]),
                             torch.stack([lse for _, lse in parts]))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for i, (_, lse) in enumerate(parts):
        lo = i * blk
        empty = [not any(lo <= j < min(int(n), SEQ) and
                         (window <= 0 or j >= int(n) - window)
                         for j in range(lo, lo + blk))
                 for n in lengths.tolist()]
        for b, e in enumerate(empty):
            assert bool((lse[0, b] == float("-inf")).all()) == e
            assert bool((lse[1, b] == 0).all()) == e


# ---------------------------------------------------------------------------
# end to end: the sharded serve step over a sequence-split cache
# ---------------------------------------------------------------------------

ARCHS = ("zamba2-1.2b", "starcoder2-3b")


def _cfg(arch):
    return C.get_config(arch, reduced=True).replace(
        dtype="float32", attn_impl="torch", ssm_impl="torch",
        rwkv_impl="torch")


def _prompt(arch):
    rng = np.random.default_rng(3)
    return rng.integers(0, _cfg(arch).vocab_size, size=(1, PROMPT))


def _greedy(model, params, tokens, cache, **kw):
    prefill = TS.make_prefill_step(model, **kw)
    serve = TS.make_serve_step(model, **kw)
    cache = prefill(params, cache, tokens[:, :-1], [PROMPT - 1])
    tok, out = tokens[:, -1:], []
    for _ in range(NEW):
        tok, cache = serve(params, cache, tok)
        out.append(tok)
    return torch.cat(out, 1).numpy()


def _model_worker(rank, n, mesh):
    out = {}
    for arch in ARCHS:
        cfg = _cfg(arch)
        model = build_model(cfg, "cpu")
        params = model.init(model.generator(0), dtype=torch.float32)
        sh = S.param_shardings(param_axes(cfg), cfg, mesh, layout="tp")
        whole = model.init_cache(1, MAX_LEN, device=specs.META)
        cache_sh = specs.cache_shardings(whole, mesh, cfg)
        rows, positions, kv = specs.attention_cache_block(cfg, 1, MAX_LEN,
                                                          mesh)
        cache = model.init_cache(rows, positions, kv_heads=kv)
        tokens = torch.from_numpy(_prompt(arch))
        out[arch] = dict(
            positions=positions,
            tokens=_greedy(model, S.shard_tree(params, sh), tokens, cache,
                           param_shardings=sh, cache_shardings=cache_sh))
    return out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n", WORLDS)
def test_sharded_serve_over_a_sequence_split_cache(ranks, n, arch):
    cfg = _cfg(arch)
    model = build_model(cfg, "cpu")
    params = model.init(model.generator(0), dtype=torch.float32)
    want = _greedy(model, params, torch.from_numpy(_prompt(arch)),
                   model.init_cache(1, MAX_LEN))
    for r in ranks[n]:
        assert r["model"][arch]["positions"] == MAX_LEN // n
        assert np.array_equal(r["model"][arch]["tokens"], want)

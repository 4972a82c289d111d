"""The port's paged KV cache against the reference: the page allocator
(every operation sequence, and hypothesis properties), the attention-level
primitives (``gather_pages``, ``update_cache_paged``,
``attend_decode_paged``) on the same numpy inputs, the explicit write
mask that stands in for the reference's ``mode="drop"``, and cache packs
that own their storage.

Float32; the paged primitives must equal the reference to the bit (they
move data, and attention over the gathered view is the dense function)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as JA  # noqa: E402
from repro.serving import paging as JP  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.serving import paging as P  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402


def _both(fn_name, *args):
    return getattr(JP, fn_name)(*args), getattr(P, fn_name)(*args)


# -- the allocator -----------------------------------------------------------

def _ops(seed, n=80):
    rng = np.random.default_rng(seed)
    return [(("alloc", "free")[int(rng.integers(0, 2))],
             int(rng.integers(0, 6)), int(rng.integers(0, 9)))
            for _ in range(n)]


@pytest.mark.parametrize("seed", range(4))
def test_allocator_matches_reference_op_for_op(seed):
    """The same operation stream gives the same grants, frees, tables and
    counters in both packages."""
    ja, ta = JP.PageAllocator(13, 4), P.PageAllocator(13, 4)
    for kind, rid, n in _ops(seed):
        if kind == "alloc":
            assert ja.alloc(rid, n) == ta.alloc(rid, n)
        else:
            assert ja.free(rid) == ta.free(rid)
        assert (ja.free_pages, ja.used_pages, ja.peak_used) == \
            (ta.free_pages, ta.used_pages, ta.peak_used)
        for r in range(6):
            assert ja.pages_of(r) == ta.pages_of(r)
            assert ja.holds(r) == ta.holds(r)


def test_allocator_validation_and_adopt():
    for bad in ((0, 4), (4, 0)):
        with pytest.raises(ValueError):
            P.PageAllocator(*bad)
    a = P.PageAllocator(4, 2)
    with pytest.raises(ValueError):
        a.alloc(0, -1)
    a.adopt(7, [1, 2])
    assert a.pages_of(7) == [1, 2]
    with pytest.raises(ValueError, match="already holds"):
        a.adopt(7, [3])
    assert a.alloc(1, 5) is None and a.free_pages == 4   # all or nothing


@pytest.mark.parametrize("n_tokens,page_size", [(0, 4), (1, 4), (4, 4),
                                                (5, 4), (100, 16),
                                                (512, 16)])
def test_pages_needed_matches_reference(n_tokens, page_size):
    want, got = _both("pages_needed", n_tokens, page_size)
    assert got == want


# hypothesis mirrors of tests/test_paging_properties.py, against the
# reference allocator on every step
hyp = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

OPS = st.lists(st.tuples(st.sampled_from(["alloc", "free"]),
                         st.integers(min_value=0, max_value=7),
                         st.integers(min_value=0, max_value=12)),
               max_size=60)


@settings(max_examples=100, deadline=None)
@given(st.integers(min_value=1, max_value=24), OPS)
def test_allocator_invariants_and_reference_under_arbitrary_sequences(
        num_pages, ops):
    ja, ta = JP.PageAllocator(num_pages, 4), P.PageAllocator(num_pages, 4)
    held = {}
    for kind, rid, n in ops:
        free_before = ta.free_pages
        if kind == "alloc":
            grant = ta.alloc(rid, n)
            assert grant == ja.alloc(rid, n)
            if n > free_before:
                assert grant is None and ta.free_pages == free_before
            else:
                held[rid] = held.get(rid, 0) + n
        else:
            assert ta.free(rid) == ja.free(rid) == held.pop(rid, 0)
        assert ta.free_pages + ta.used_pages == ta.num_pages
        assert ta.used_pages == sum(held.values())
        pages = [p for r in held for p in ta.pages_of(r)]
        assert len(pages) == len(set(pages))        # no shared page
        assert ta.peak_used == ja.peak_used


@settings(max_examples=100, deadline=None)
@given(st.integers(min_value=0, max_value=1000),
       st.integers(min_value=1, max_value=64))
def test_pages_needed_is_exact_ceiling(n_tokens, page_size):
    n = P.pages_needed(n_tokens, page_size)
    assert n == JP.pages_needed(n_tokens, page_size)
    assert n * page_size >= n_tokens
    assert (n - 1) * page_size < max(n_tokens, 1)


# -- attention-level primitives ----------------------------------------------

def _pool(rng, n_pages, ps, KV=2, Dh=8):
    return rng.normal(size=(n_pages, ps, KV, Dh)).astype(np.float32)


def test_gather_pages_matches_reference():
    rng = np.random.default_rng(0)
    pages = _pool(rng, 9, 4)
    table = np.asarray([[4, 1, 0], [2, 8, 3]], np.int32)
    want = np.asarray(JA.gather_pages(jnp.asarray(pages),
                                      jnp.asarray(table)))
    got = A.gather_pages(torch.from_numpy(pages), torch.from_numpy(table))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("max_len,ps", [(32, 4), (100, 16)])
def test_update_cache_paged_matches_reference(max_len, ps):
    """Writes through the table (a position past the last page included,
    which both clip into it) equal the reference's, with and without a
    mask, also at a max_len that is not a multiple of the page size."""
    rng = np.random.default_rng(1)
    B, Lp = 3, -(-max_len // ps)
    n_pages = B * Lp
    kp, vp = _pool(rng, n_pages, ps), _pool(rng, n_pages, ps)
    table = rng.permutation(n_pages).reshape(B, Lp).astype(np.int32)
    pos = np.asarray([0, max_len - 1, Lp * ps + 3], np.int32)
    k_new = rng.normal(size=(B, 1, 2, 8)).astype(np.float32)
    v_new = rng.normal(size=(B, 1, 2, 8)).astype(np.float32)
    for mask in (None, np.asarray([True, False, True])):
        want = JA.update_cache_paged(
            *map(jnp.asarray, (kp, vp, k_new, v_new, table, pos)),
            None if mask is None else jnp.asarray(mask))
        kt, vt = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
        A.update_cache_paged(kt, vt, *map(torch.from_numpy,
                                          (k_new, v_new, table, pos)),
                             None if mask is None
                             else torch.from_numpy(mask))
        np.testing.assert_array_equal(kt.numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(want[1]))


def test_masked_write_leaves_every_page_bit_identical():
    """A masked row whose stale table points at a page another row now
    owns, at the very offset that row writes: the masked row changes no
    page at all, and the owner's write lands."""
    rng = np.random.default_rng(2)
    ps = 4
    kp, vp = _pool(rng, 6, ps), _pool(rng, 6, ps)
    table = np.asarray([[5, 2], [5, 2]], np.int32)    # row 0's pages are
    pos = np.asarray([6, 6], np.int32)                # stale: row 1 owns
    k_new = rng.normal(size=(2, 1, 2, 8)).astype(np.float32)
    v_new = rng.normal(size=(2, 1, 2, 8)).astype(np.float32)
    kt, vt = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    A.update_cache_paged(kt, vt, *map(torch.from_numpy,
                                      (k_new, v_new, table, pos)),
                         torch.tensor([False, True]))
    np.testing.assert_array_equal(kt[2, 2].numpy(), k_new[1, 0])
    np.testing.assert_array_equal(vt[2, 2].numpy(), v_new[1, 0])
    keep = np.ones(6 * ps, bool)
    keep[2 * ps + 2] = False
    np.testing.assert_array_equal(kt.reshape(6 * ps, 2, 8).numpy()[keep],
                                  kp.reshape(6 * ps, 2, 8)[keep])
    np.testing.assert_array_equal(vt.reshape(6 * ps, 2, 8).numpy()[keep],
                                  vp.reshape(6 * ps, 2, 8)[keep])
    # every row masked: nothing at all changes
    A.update_cache_paged(kt, vt, *map(torch.from_numpy,
                                      (v_new, k_new, table, pos)),
                         torch.tensor([False, False]))
    np.testing.assert_array_equal(kt[2, 2].numpy(), k_new[1, 0])


@pytest.mark.parametrize("max_len,ps,window", [(12, 4, 0), (100, 16, 0),
                                               (100, 16, 7)])
def test_attend_decode_paged_equals_dense_and_reference(max_len, ps, window):
    """The paged attention over a scrambled pool equals the dense
    ``attend_decode`` on the same logical rows, and the reference's."""
    rng = np.random.default_rng(3)
    B, H, KV, Dh = 3, 4, 2, 8
    Lp = -(-max_len // ps)
    n_pages = B * Lp + 2
    q = rng.normal(size=(B, 1, H, Dh)).astype(np.float32)
    dense_k = rng.normal(size=(B, Lp * ps, KV, Dh)).astype(np.float32)
    dense_v = rng.normal(size=(B, Lp * ps, KV, Dh)).astype(np.float32)
    pos = np.asarray([7, max_len - 1, 0], np.int32)
    perm = rng.permutation(n_pages)[:B * Lp].reshape(B, Lp).astype(np.int32)
    kp = np.zeros((n_pages, ps, KV, Dh), np.float32)
    vp = np.zeros_like(kp)
    for b in range(B):
        for j in range(Lp):
            kp[perm[b, j]] = dense_k[b, j * ps:(j + 1) * ps]
            vp[perm[b, j]] = dense_v[b, j * ps:(j + 1) * ps]
    t = torch.from_numpy
    dense = A.attend_decode(t(q), t(dense_k[:, :max_len]),
                            t(dense_v[:, :max_len]), t(pos).long(),
                            window=window, impl="torch")
    got = A.attend_decode_paged(t(q), t(kp), t(vp), t(perm), t(pos).long(),
                                window=window, impl="torch")
    ref = JA.attend_decode_paged(*map(jnp.asarray, (q, kp, vp, perm, pos)),
                                 window=window)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


# -- cache-shipping packs ----------------------------------------------------

_AXES = {"kv": {"k": P.POOL_AXIS_SENTINEL, "v": P.POOL_AXIS_SENTINEL},
         "page_table": 0, "pos": 0, "state": 0}


def _toy_cache(B=2, n_pages=6, ps=2, Lp=4):
    n = 2 * n_pages * ps * 3
    return {"kv": {"k": np.arange(n, dtype=np.float32)
                   .reshape(2, n_pages, ps, 3),
                   "v": -np.arange(n, dtype=np.float32)
                   .reshape(2, n_pages, ps, 3)},
            "page_table": np.zeros((B, Lp), np.int32),
            "pos": np.full((B,), 5, np.int32),
            "state": np.arange(B * 4, dtype=np.float32).reshape(B, 4)}


def test_pack_unpack_matches_reference():
    src = _toy_cache()
    src["page_table"][1, :2] = [4, 1]
    jpack = JP.pack_slot(tree_map(jnp.asarray, src), _AXES, 1, [4, 1],
                         ("toy", 2))
    tsrc = tree_map(torch.from_numpy, src)
    tpack = P.pack_slot(tsrc, _AXES, 1, [4, 1], ("toy", 2))
    assert (tpack.n_pages, tpack.pos, tpack.cache_key) == \
        (jpack.n_pages, jpack.pos, jpack.cache_key)
    for (path, leaf), (_, want) in zip(tree_leaves(tpack.tree),
                                       tree_leaves(jpack.tree)):
        assert leaf.device.type == "cpu", path
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(want))
    dst = tree_map(lambda ax, a: np.zeros_like(a)
                   if ax == P.POOL_AXIS_SENTINEL else a, _AXES, _toy_cache())
    want = JP.unpack_slot(tree_map(jnp.asarray, dst), _AXES, 0, [0, 3],
                          jpack)
    got = P.unpack_slot(tree_map(torch.from_numpy, dst), _AXES, 0, [0, 3],
                        tpack)
    for (path, leaf), (_, w) in zip(tree_leaves(got), tree_leaves(want)):
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(w), path)
    with pytest.raises(ValueError, match="pages"):
        P.unpack_slot(got, _AXES, 0, [1], tpack)


def test_pack_leaves_own_their_storage():
    """Every pack leaf is a copy: overwriting the source cache (as the
    source replica's next step does, in place) leaves the pack as it
    was, and no leaf shares storage with the source."""
    src = tree_map(torch.from_numpy, _toy_cache())
    pack = P.pack_slot(src, _AXES, 1, [4, 1], ("toy", 2))
    before = tree_map(lambda t: t.clone(), pack.tree)
    src_ptrs = {t.untyped_storage().data_ptr()
                for _, t in tree_leaves(src)}
    for path, leaf in tree_leaves(pack.tree):
        assert leaf.untyped_storage().data_ptr() not in src_ptrs, path
    tree_map(lambda t: t.fill_(123.0), src)
    for (path, leaf), (_, old) in zip(tree_leaves(pack.tree),
                                      tree_leaves(before)):
        assert torch.equal(leaf, old), path

"""The copied closed forms against cases worked by hand, and a family's
FLOPs found by name."""
import pytest

from bench_port import counts

TINY = {"family": "dense", "num_layers": 1, "d_model": 4, "num_heads": 2,
        "num_kv_heads": 1, "head_dim": 2, "d_ff": 8, "vocab_size": 10,
        "gated_mlp": False}


def brute_pairs(sq, sk, causal, window):
    """chip_smoke.py's loop."""
    n = 0
    for i in range(sq):
        hi = min(sk, i + 1) if causal else sk
        lo = max(0, i - window + 1) if window > 0 else 0
        n += max(0, hi - lo)
    return n


@pytest.mark.parametrize("s,causal,window", [
    (1, True, 0), (7, True, 0), (16, True, 4), (16, True, 16),
    (16, True, 17), (9, False, 0), (4096, True, 1024)])
def test_visible_pairs(s, causal, window):
    assert counts.visible_pairs(s, s, causal, window) == \
        brute_pairs(s, s, causal, window)


def test_mean_keys_at_16384_with_a_4096_window():
    assert counts.visible_pairs(16384, 16384, True, 4096) == \
        4096 * 4097 // 2 + 12288 * 4096          # 3,584.06 a query


def test_fwd_flops_by_hand():
    # T = 2 x 3 = 6 tokens. unembed 2*6*4*10 = 480. Attention
    # projections 2*6*4*(2*2 + 2*1*2) + 2*6*2*2*4 = 384 + 192 = 576;
    # scores with (3+1)/2 = 2 keys a query: 2*6*2*2*2*2 = 192. MLP
    # (non-gated) 4*6*4*8 = 768.
    assert counts.fwd_flops(TINY, 2, 3) == 480 + 576 + 192 + 768


def test_fwd_flops_window_counts_visible_keys():
    m = dict(TINY, sliding_window=2, global_every=5)
    # S = 3 with a window of 2: keys 1, 2, 2 -> 5/3 a query
    full = counts.fwd_flops(TINY, 1, 3)
    windowed = counts.fwd_flops(m, 1, 3)
    assert full - windowed == pytest.approx(2 * 3 * (2 - 5 / 3) * 2 * 2 * 2)


def test_flash_bound_by_hand():
    t, flops, nbytes = counts.flash_bound(1, 4, 4, 2, 1, 8, True, 0)
    assert flops == 4 * 2 * 8 * 10                 # 10 causal pairs
    assert nbytes == (2 * 4 * 2 * 8 + 2 * 4 * 1 * 8) * 2
    assert t == max(flops / counts.PEAK_FLOPS_BF16, nbytes / counts.HBM_BW)


def test_ssd_bound_triangle():
    # one 64-token chunk: the triangle has 64*65/2 = 2080 entries
    t, flops, nbytes = counts.ssd_bound(1, 64, 1, 8, 8, "float32")
    assert flops == 2 * 2080 * 8 + (2 * 2080 * 8 + 4 * 64 * 8 * 8)
    assert nbytes == (2 * 64 * 8 + 2 * 64 * 8) * 4 + 4 * 64
    # a 65th token opens a second chunk
    assert counts.ssd_bound(1, 65, 1, 8, 8)[1] == 2 * flops


def test_hybrid_counts_shared_block():
    m = {"family": "hybrid", "num_layers": 4, "d_model": 4, "num_heads": 2,
         "num_kv_heads": 2, "head_dim": 2, "d_ff": 8, "vocab_size": 10,
         "ssm_state": 2, "ssm_heads": 2, "ssm_head_dim": 4, "ssm_chunk": 4,
         "shared_attn_every": 2}
    no_attn = dict(m, shared_attn_every=8)
    one = counts._attn_flops(counts._Cfg(m), 3, 3, causal=True, window=0) \
        + counts._mlp_flops(counts._Cfg(m), 3)
    assert counts.fwd_flops(m, 1, 3) - counts.fwd_flops(no_attn, 1, 3) \
        == pytest.approx(2 * one)


def test_fwd_flops_of_a_family_found_by_name(tmp_path, monkeypatch):
    """A family the closed forms lack is counted by flops/<family>.py."""
    (tmp_path / "tri_mix.py").write_text(
        "def fwd_flops(model, batch, seq, kv_len):\n"
        "    return model['num_layers'] * batch * seq * (kv_len or 7)\n")
    monkeypatch.setattr(counts, "FLOPS", tmp_path)
    m = {"family": "tri_mix", "num_layers": 3}
    assert counts.fwd_flops(m, 2, 5) == 3 * 2 * 5 * 7
    assert counts.fwd_flops(m, 2, 5, kv_len=11) == 3 * 2 * 5 * 11
    # the families counted here are not looked up
    assert counts.fwd_flops(TINY, 2, 3) == 480 + 576 + 192 + 768


def test_fwd_flops_of_an_unknown_family_names_the_file():
    with pytest.raises(ValueError, match=r"bench_port/flops/no_such\.py"):
        counts.fwd_flops({"family": "no_such"}, 1, 4)

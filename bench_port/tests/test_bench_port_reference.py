"""The reference's own forms agree, and the program at a small size on
the CPU agrees with the reference within every cell's limits."""
import math

import pytest
import torch

from bench_port.reference import common as C
from bench_port.reference import hybrid

import bench_port_tiny as tiny


@pytest.mark.parametrize("S,chunk", [(37, 8), (64, 16), (5, 64)])
def test_ssd_chunked_is_the_recurrence(S, chunk):
    g = torch.Generator().manual_seed(S)
    b, H, P, N = 2, 3, 4, 5
    x = torch.randn(b, S, H, P, generator=g, dtype=torch.float64)
    dt = torch.rand(b, S, H, generator=g, dtype=torch.float64) * 0.5
    A = -torch.rand(H, generator=g, dtype=torch.float64) * 4
    Bm = torch.randn(b, S, N, generator=g, dtype=torch.float64)
    Cm = torch.randn(b, S, N, generator=g, dtype=torch.float64)
    want = hybrid.ssd_sequential(x, dt, A, Bm, Cm)
    got = hybrid.ssd_chunked(x, dt, A, Bm, Cm, chunk)
    assert torch.allclose(got, want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("window", [0, 5, 40])
def test_attention_blocks_equal_the_masked_softmax(window):
    g = torch.Generator().manual_seed(window)
    B, S, H, KV, D = 2, 23, 4, 2, 8
    q = torch.randn(B, S, H, D, generator=g, dtype=torch.float64)
    k = torch.randn(B, S, KV, D, generator=g, dtype=torch.float64)
    v = torch.randn(B, S, KV, D, generator=g, dtype=torch.float64)
    got = C.attention(q, k, v, window, block=4)
    kk, vv = k.repeat_interleave(H // KV, 2), v.repeat_interleave(H // KV, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) / math.sqrt(D)
    i, j = torch.arange(S)[:, None], torch.arange(S)[None, :]
    ok = (j <= i) & ((j > i - window) if window > 0 else True)
    p = torch.softmax(s.masked_fill(~ok, float("-inf")), -1)
    want = torch.einsum("bhqk,bkhd->bqhd", p, vv)
    assert torch.allclose(got, want, rtol=1e-10, atol=1e-10)


def test_fp8_rounds_and_float32_does_not():
    x = torch.randn(8, 16, generator=torch.Generator().manual_seed(0))
    w = torch.randn(16, 4, generator=torch.Generator().manual_seed(1))
    assert torch.equal(C.linear(x, w, "float32"), x @ w)
    low = C.linear(x, w, "fp8")
    rel = (low - x @ w).norm() / (x @ w).norm()
    assert 1e-3 < rel < 0.2


@pytest.mark.parametrize("name", tiny.cells())
def test_program_agrees_with_the_reference(name):
    line = tiny.run(name)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0

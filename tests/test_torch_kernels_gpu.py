"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips itself where no CUDA device is present.
Imports no JAX, so it runs on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Tolerances: float32 1e-4 x (1 + |ref|) (another summation order and
``expf``); bfloat16 2^-6 x (|ref| + rms(ref)), two bf16 ulps: both
outputs are rounded to bf16 from float32 values that agree to ~1e-6.
The Mamba-2 glue kernels round where their plain versions do: one bf16
ulp, 16 float32 ulps (``_assert_ulps``).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention import (decode_attend,  # noqa: E402
                                                  decode_attention,
                                                  decode_attention_plain)

# B, H, KV, S, D, lengths, window
CASES = [
    (4, 24, 2, 512, 128, [512, 300, 1, 0], 0),       # starcoder2 serve
    (4, 24, 2, 512, 128, [512, 300, 50, 700], 128),  # window, past S
    (3, 24, 1, 100, 128, [100, 37, 0], 0),           # G=24: two head chunks
    (2, 48, 1, 77, 128, [77, 5], 16),                # G=48 (granite)
    (3, 4, 2, 37, 16, [0, 42, 13], 5),               # the CPU tests' widths
    (2, 24, 2, 45, 64, [45, 3], 0),
    (2, 40, 8, 2049, 128, [2049, 1500], 0),          # G=5, long
    # the tensor-core path's tile edges (64 keys): S = 64 +- 1, G = 48
    (2, 24, 2, 65, 128, [65, 63], 0),
    (2, 48, 1, 129, 128, [129, 64], 0),
    (2, 48, 1, 600, 128, [600, 450], 100),           # window cuts tiles
    (4, 28, 4, 512, 128, [512, 300, 1, 0], 0),       # G=7 (qwen2-vl)
    # seamless's cross-attention: every row full, S not a tile multiple
    (2, 16, 16, 1000, 64, [1000, 1000], 0),
    (4, 16, 16, 1024, 64, [1024] * 4, 0),
]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    return torch.device("cuda")


def _inputs(case, dtype, dev, seed=0):
    B, H, KV, S, D, lengths, window = case
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, 1, H, D, generator=g, device=dev).to(dtype)
    kc = torch.randn(B, S, KV, D, generator=g, device=dev).to(dtype)
    vc = torch.randn(B, S, KV, D, generator=g, device=dev).to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kc, vc, lens, window


def _assert_close(got, want, dtype):
    err = (got.float() - want.float()).abs()
    ref = want.float().abs()
    if dtype == torch.float32:
        bound = 1e-4 * (1 + ref)
    else:
        bound = 2 ** -6 * (ref + ref.pow(2).mean().sqrt())
    assert torch.isfinite(got.float()).all()
    assert bool((err <= bound).all()), f"max err {float(err.max()):.3e}"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_decode_attention_kernel_matches_plain(case, dtype):
    dev = _cuda()
    q, kc, vc, lens, window = _inputs(case, dtype, dev)
    k, v = kc.transpose(1, 2), vc.transpose(1, 2)     # model layout, in place
    want = decode_attention_plain(q[:, 0], k, v, lens, window=window)
    for splits in (None, 1, 3):
        before = decode_attention.launches
        got = decode_attention(q[:, 0], k, v, lens, window=window,
                               num_splits=splits)
        torch.cuda.synchronize()
        assert decode_attention.launches == before + 1
        _assert_close(got, want, dtype)
    got = decode_attend(q, kc, vc, lens, window=window, impl="cuda")
    _assert_close(got[:, 0], want, dtype)
    assert got.dtype == dtype and got.shape == q.shape


@pytest.mark.gpu
def test_decode_attention_kernel_refuses_bad_inputs():
    dev = _cuda()
    q, kc, vc, lens, _ = _inputs(CASES[0], torch.bfloat16, dev)
    with pytest.raises(ValueError):
        decode_attention(q[:, 0], kc.transpose(1, 2).float(),
                         vc.transpose(1, 2), lens)
    with pytest.raises(ValueError):
        decode_attention(q[:, 0], kc.transpose(1, 2), vc.transpose(1, 2),
                         lens.cpu())
    # the tensor-core path copies 16-byte chunks: 264-byte cache rows
    padded = torch.zeros(*kc.shape[:3], kc.shape[3] + 4, dtype=kc.dtype,
                         device=dev)[..., :kc.shape[3]]
    with pytest.raises(ValueError, match="16-byte aligned"):
        decode_attention(q[:, 0], padded.transpose(1, 2), vc.transpose(1, 2),
                         lens)


# --- flash attention ------------------------------------------------------

# B, Sq, Sk, H, KV, D, causal, window: chip_smoke.py's flash-vs-plain
# shapes first, then edge cases
FLASH_CASES = [
    (4, 2048, 2048, 24, 2, 128, True, 0),      # starcoder2 forward
    (1, 4096, 4096, 32, 16, 128, True, 1024),  # gemma3 local layer
    (2, 2048, 2048, 48, 1, 128, True, 0),      # MQA (granite)
    (2, 1000, 1000, 24, 2, 128, True, 0),      # ragged: not a tile multiple
    (2, 1000, 1000, 24, 2, 128, False, 0),     # non-causal
    (2, 1024, 1024, 16, 4, 64, True, 256),     # D=64, window
    (2, 1000, 777, 8, 2, 128, False, 0),       # non-causal, Sk != Sq
    (2, 300, 300, 8, 4, 128, False, 64),       # non-causal with a window
    (2, 513, 513, 8, 2, 64, True, 100),        # D=64, ragged, window
    (3, 37, 37, 4, 2, 16, True, 5),            # the CPU tests' widths
    # the wgmma kernel's tile edges (128 queries x 128 keys): S = 128 +- 1,
    # windows that cut a tile, and a block whose consumers see other tiles
    (2, 127, 127, 8, 2, 128, True, 0),
    (2, 129, 129, 8, 2, 128, False, 0),
    (2, 129, 127, 8, 2, 64, False, 0),
    (1, 600, 600, 8, 2, 128, True, 200),
    (2, 700, 700, 8, 8, 64, True, 70),
    (2, 1024, 1024, 28, 4, 128, True, 0),      # G=7 (qwen2-vl)
    # seamless's encoder and cross-attention: non-causal at D=64
    (2, 1024, 1024, 16, 16, 64, False, 0),
    (2, 1000, 777, 16, 16, 64, False, 0),
]


def _flash_inputs(case, dtype, dev, seed=0, scale=1.0):
    """q, k, v as views of one fused projection output (B, S, H+2KV, D),
    so the kernel reads strided model-layout tensors, as after a fused
    QKV product."""
    B, Sq, Sk, H, KV, D, causal, window = case
    g = torch.Generator(device=dev).manual_seed(seed)
    q = (scale * torch.randn(B, Sq, H, D, generator=g, device=dev)).to(dtype)
    kv = torch.randn(B, Sk, 2 * KV + 8, D, generator=g, device=dev).to(dtype)
    return q, kv[:, :, 8:8 + KV], kv[:, :, 8 + KV:], causal, window


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(case, dtype):
    from repro_torch.kernels.flash_attention import (attention,
                                                     flash_attention,
                                                     flash_attention_plain)
    dev = _cuda()
    for scale in (1.0, 4.0):                    # 4: sharp softmax rows
        q, k, v, causal, window = _flash_inputs(case, dtype, dev,
                                                scale=scale)
        want = flash_attention_plain(q, k, v, causal=causal, window=window)
        before = flash_attention.launches
        got = flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        assert got.dtype == dtype and got.shape == q.shape
        _assert_close(got, want, dtype)
        got = attention(q, k, v, causal=causal, window=window, impl="cuda")
        _assert_close(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("v_scale", [1e6, 1e-15, 1e-30, 3e37])
def test_flash_attention_fp16_route_scales_v_into_range(v_scale):
    """fp16 holds 65504 at most and loses bits below 6e-5: at D = 64,
    where P meets V in fp16, the kernel scales V by a power of two first,
    so V far beyond either end of fp16's range (still normal in bf16)
    gives the plain version's answer, not inf or 0. Both outputs are
    divided by ``v_scale`` before the bound is taken, so that the bound's
    mean square neither overflows nor underflows in float32."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    dev = _cuda()
    for case in (FLASH_CASES[12], FLASH_CASES[5]):
        q, k, v, causal, window = _flash_inputs(case, torch.bfloat16, dev)
        v = (v.float() * v_scale).bfloat16()
        want = flash_attention_plain(q, k, v, causal=causal, window=window)
        got = flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert torch.isfinite(got.float()).all()
        _assert_close(got.double() / v_scale, want.double() / v_scale,
                      torch.bfloat16)


@pytest.mark.gpu
def test_flash_attention_kernel_refuses_bad_inputs():
    from repro_torch.kernels.flash_attention import flash_attention
    dev = _cuda()
    q, k, v, _, _ = _flash_inputs(FLASH_CASES[9], torch.bfloat16, dev)
    with pytest.raises(ValueError, match="dtypes"):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(*(torch.cat([t, t], -1) for t in (q, k, v)))
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)
    q, k, v, _, _ = _flash_inputs(FLASH_CASES[10], torch.bfloat16, dev)
    flat = torch.zeros(q.numel() + 8, dtype=q.dtype, device=dev)
    with pytest.raises(ValueError, match="TMA"):       # base + 2 bytes
        flash_attention(flat[1:1 + q.numel()].view(q.shape), k, v)
    with pytest.raises(ValueError, match="TMA"):       # 136-byte rows
        padded = torch.zeros(*k.shape[:3], k.shape[3] + 4, dtype=k.dtype,
                             device=dev)
        flash_attention(q, k, padded[..., :k.shape[3]])
    q, k, v, _, _ = _flash_inputs(FLASH_CASES[9], torch.bfloat16, dev)
    with pytest.raises(RuntimeError, match="no gradient either"):
        flash_attention(q.float().requires_grad_(), k.float(), v.float())
    with torch.no_grad():
        flash_attention(q.float().requires_grad_(), k.float(), v.float())


# --- SSD scan ---------------------------------------------------------------

# B, S, H, P, N, dA low bound: chip_smoke.py's zamba2 forward shape first,
# then edge cases
SSD_CASES = [
    (4, 2048, 64, 64, 64, -0.5),      # zamba2-1.2b forward
    (2, 1000, 8, 64, 64, -0.5),       # ragged: not a multiple of 64
    (2, 333, 4, 64, 64, -20.0),       # fast decays, ragged
    (3, 37, 8, 16, 16, -0.5),         # the CPU tests' widths
    (1, 1, 2, 32, 16, -0.5),          # one token
    # the bf16 tensor-core kernel's edges: heads that are not a multiple
    # of its two-head blocks, S around one 64-token chunk, P = N = 32, and
    # a long, slowly decaying sequence (the carried state through 128
    # chunks)
    (2, 300, 3, 64, 64, -0.5),
    (2, 300, 5, 64, 64, -0.5),
    (2, 63, 4, 64, 64, -0.5),
    (2, 64, 4, 64, 64, -0.5),
    (2, 65, 4, 64, 64, -0.5),
    (2, 500, 8, 32, 32, -0.5),
    (1, 8192, 8, 64, 64, -0.05),
]


def _ssd_inputs(case, dtype, dev, seed=0):
    """xdt, and B, C as column slices of one conv-output-like tensor, as
    the model hands them over."""
    B, S, H, P, N, lo = case
    g = torch.Generator(device=dev).manual_seed(seed)
    xdt = torch.randn(B, S, H, P, generator=g, device=dev).to(dtype)
    conv = torch.randn(B, S, H * P + 2 * N, generator=g, device=dev).to(dtype)
    Bc, Cc = conv[..., H * P:H * P + N], conv[..., H * P + N:]
    dA = lo + (-0.01 - lo) * torch.rand(B, S, H, generator=g, device=dev)
    return xdt, Bc, Cc, dA


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_scan_kernel_matches_plain(case, dtype):
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    dev = _cuda()
    xdt, Bc, Cc, dA = _ssd_inputs(case, dtype, dev)
    want = ssd_scan_plain(xdt, Bc, Cc, dA)
    before = ssd_scan.launches
    got = ssd_scan(xdt, Bc, Cc, dA)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    assert got.dtype == dtype and got.shape == xdt.shape
    _assert_close(got, want, dtype)


@pytest.mark.gpu
def test_ssd_scan_kernel_refuses_bad_inputs():
    from repro_torch.kernels.ssd_scan import ssd_scan
    dev = _cuda()
    xdt, Bc, Cc, dA = _ssd_inputs(SSD_CASES[3], torch.bfloat16, dev)
    with pytest.raises(ValueError, match="dtypes"):
        ssd_scan(xdt.half(), Bc.half(), Cc.half(), dA)
    with pytest.raises(ValueError, match="dtypes"):
        ssd_scan(xdt, Bc, Cc, dA.bfloat16())
    with pytest.raises(ValueError, match="is on cpu"):
        ssd_scan(xdt, Bc.cpu(), Cc, dA)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan(xdt.transpose(2, 3).contiguous().transpose(2, 3), Bc, Cc,
                 dA)
    with pytest.raises(ValueError, match="cp.async"):   # C at 2-byte offset
        ssd_scan(xdt, Bc, torch.zeros(*Cc.shape[:2], Cc.shape[2] + 1,
                                      dtype=Cc.dtype, device=dev)[..., 1:],
                 dA)
    x = xdt.float().requires_grad_()
    with pytest.raises(RuntimeError, match="no gradient either"):
        ssd_scan(x, Bc.float(), Cc.float(), dA)
    with torch.no_grad():
        ssd_scan(x, Bc.float(), Cc.float(), dA)


# --- RWKV-6 WKV ---------------------------------------------------------------

# B, S, H, D, initial state, r/k/v as views of one fused projection (else
# the model's contiguous tensors), slow decay: chip_smoke.py's rwkv6
# forward shape first
WKV_CASES = [
    (4, 2048, 64, 64, True, True, False),     # rwkv6-7b forward, nonzero s0
    (4, 2048, 64, 64, False, False, False),   # the model's own call
    (2, 1000, 8, 64, True, True, False),      # ragged: not a multiple of 32
    (3, 37, 4, 16, True, True, False),        # the CPU tests' widths
    (1, 1, 2, 32, False, False, False),       # one token
    (2, 31, 8, 64, True, True, False),        # around one 32-token block
    (2, 32, 8, 64, True, False, False),
    (2, 33, 8, 64, True, True, False),
    (2, 300, 8, 32, True, False, False),      # D = 32
    (2, 8192, 8, 64, True, False, True),      # slow decay: the largest state
]


def _wkv_inputs(case, dev, dtype=torch.float32, seed=0):
    """r, k, v in ``dtype`` as views of one fused projection output or as
    the model's contiguous tensors; decays drawn as the reference test
    does, down to exp(-e^4) ~ 1.9e-24, or slowly (exp(-exp(U(-8, -6))));
    w, u and s0 float32."""
    B, S, H, D, with_s0, fused, slow = case
    g = torch.Generator(device=dev).manual_seed(seed)
    if fused:
        rkv = torch.randn(B, S, H, 3 * D, generator=g, device=dev).to(dtype)
        r, k, v = rkv[..., :D], rkv[..., D:2 * D], rkv[..., 2 * D:]
    else:
        r, k, v = (torch.randn(B, S, H, D, generator=g, device=dev).to(dtype)
                   for _ in range(3))
    lo, hi = (-8.0, -6.0) if slow else (-8.0, 4.0)
    w = torch.exp(-torch.exp(lo + (hi - lo) * torch.rand(
        B, S, H, D, generator=g, device=dev)))
    u = torch.randn(H, D, generator=g, device=dev)
    s0 = torch.randn(B, H, D, D, generator=g, device=dev) if with_s0 \
        else None
    return r, k, v, w, u, s0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", WKV_CASES)
def test_rwkv6_kernel_matches_plain(case, dtype):
    from repro_torch.kernels.rwkv6 import rwkv6_plain, rwkv6_scan
    dev = _cuda()
    args = _wkv_inputs(case, dev, dtype)
    want_o, want_s = rwkv6_plain(*args)
    before = rwkv6_scan.launches
    got_o, got_s = rwkv6_scan(*args)
    torch.cuda.synchronize()
    assert rwkv6_scan.launches == before + 1
    assert got_o.shape == args[0].shape and got_s.shape == want_s.shape
    assert got_o.dtype == dtype and got_s.dtype == torch.float32
    _assert_close(got_o, want_o, dtype)
    _assert_close(got_s, want_s, torch.float32)      # the state: float32


@pytest.mark.gpu
def test_rwkv6_kernel_refuses_bad_inputs():
    from repro_torch.kernels.rwkv6 import rwkv6_scan
    dev = _cuda()
    r, k, v, w, u, s0 = _wkv_inputs(WKV_CASES[3], dev)
    with pytest.raises(ValueError, match="float32"):
        rwkv6_scan(r.bfloat16(), k, v, w, u, s0)
    with pytest.raises(ValueError, match="16-byte"):
        rwkv6_scan(*(t.bfloat16()[..., :12] for t in (r, k, v)), w[..., :12],
                   u[:, :12].contiguous(), None)
    with pytest.raises(ValueError, match="is on cpu"):
        rwkv6_scan(r, k, v, w, u.cpu(), s0)
    with pytest.raises(ValueError, match="head dim"):
        rwkv6_scan(*(torch.cat([t] * 5, -1) for t in (r, k, v, w)),
                   torch.cat([u] * 5, -1))
    with pytest.raises(RuntimeError, match="no gradient either"):
        rwkv6_scan(r, k, v, w, u.clone().requires_grad_(), s0)
    with torch.no_grad():
        rwkv6_scan(r, k, v, w, u.clone().requires_grad_(), s0)


# --- Mamba-2 glue -------------------------------------------------------------

# B, S, H, P, N, columns before the projection's z: zamba2-1.2b's forward
# shape (the benchmark cell's) first; ragged S (S < 4: the conv's window
# in the zero padding; 4097: one token past a tile); reduced zamba2; a
# reduced config whose slices are not 16-byte aligned (u at 72 bytes, an
# odd row stride) and zamba2's widths with every slice 4 bytes off: the
# wrappers take narrower loads there
GLUE_CASES = [
    (8, 4096, 64, 64, 64, 0),
    (1, 3, 64, 64, 64, 0),
    (1, 4097, 64, 64, 64, 0),
    (2, 37, 8, 16, 16, 0),
    (2, 37, 3, 12, 4, 0),
    (2, 100, 64, 64, 64, 2),
]


def _glue_inputs(case, dtype, dev, seed=0):
    """(z, u = [x, B, C], dt) as strided column slices of one (B, S,
    2 d_in + 2N + H) projection, the conv's and the norm's parameters
    (A_log, dt_bias and the norm's gamma float32), and y (B, S, H, P)."""
    B, S, H, P, N, lead = case
    d_in, C = H * P, H * P + 2 * N
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g, device=dev)
    proj = randn(B, S, lead + 2 * d_in + 2 * N + H).to(dtype)[..., lead:]
    z, u, dt = (proj[..., :d_in], proj[..., d_in:d_in + C],
                proj[..., d_in + C:])
    p = {"conv_w": randn(4, C, scale=0.5).to(dtype),
         "conv_b": randn(C, scale=0.1).to(dtype),
         "dt_bias": randn(H, scale=0.5), "A_log": randn(H, scale=0.5),
         "D": (1 + randn(H, scale=0.1)).to(dtype),
         "norm": randn(d_in, scale=0.1)}
    return z, u, dt, p, randn(B, S, H, P).to(dtype)


def _assert_ulps(got, want, dtype):
    """|got - want| within the kernels' tolerance, in units in the last
    place of ``want`` in ``dtype``: one bf16 ulp (where exp, log1p or the
    float32 sum of squares' order round differently, the outputs rounded
    to bf16 may land one ulp apart; elsewhere they are equal); float32
    outputs 16 ulps (the sum of squares' order moves the norm's scale by
    a few float32 ulps)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    w = want.float().abs()
    mant, n = (7, 1) if dtype == torch.bfloat16 else (23, 16)
    ulp = torch.exp2(torch.floor(torch.log2(
        w.clamp_min(torch.finfo(dtype).tiny))) - mant)
    err = (got.float() - want.float()).abs() / ulp
    assert torch.isfinite(got.float()).all()
    assert float(err.max()) <= n, (
        f"max {float(err.max()):.1f} ulps, {int((err > n).sum())} above "
        f"{n}, {int((err > 0).sum())} of {err.numel()} not equal")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", GLUE_CASES)
def test_conv_silu_dt_kernel_matches_plain(case, dtype):
    from repro_torch.kernels.mamba_glue import (conv_silu_dt,
                                                conv_silu_dt_plain)
    dev = _cuda()
    z, u, dt, p, _ = _glue_inputs(case, dtype, dev)
    args = (u, p["conv_w"], p["conv_b"], dt, p["dt_bias"], p["A_log"],
            case[3])
    want = conv_silu_dt_plain(*args)
    before = conv_silu_dt.launches
    got = conv_silu_dt(*args)
    torch.cuda.synchronize()
    assert conv_silu_dt.launches == before + 1
    for g_, w_ in zip(got, want):
        _assert_ulps(g_, w_.contiguous(),
                     torch.float32 if g_.dtype == torch.float32 else dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", GLUE_CASES)
def test_gated_rms_norm_kernel_matches_plain(case, dtype):
    from repro_torch.kernels.mamba_glue import (conv_silu_dt_plain,
                                                gated_rms_norm,
                                                gated_rms_norm_plain)
    dev = _cuda()
    H, P = case[2], case[3]
    z, u, dt, p, y = _glue_inputs(case, dtype, dev)
    conv_out = conv_silu_dt_plain(u, p["conv_w"], p["conv_b"], dt,
                                  p["dt_bias"], p["A_log"], P)[0]
    xh = conv_out[..., :H * P].unflatten(-1, (H, P))     # a view, as model
    args = (y, xh, z, p["D"], p["norm"], 1e-5)
    want = gated_rms_norm_plain(*args)
    before = gated_rms_norm.launches
    got = gated_rms_norm(*args)
    torch.cuda.synchronize()
    assert gated_rms_norm.launches == before + 1
    _assert_ulps(got, want, dtype)


@pytest.mark.gpu
def test_mamba_glue_kernels_refuse_bad_inputs():
    from repro_torch.kernels.mamba_glue import conv_silu_dt, gated_rms_norm
    dev = _cuda()
    H, P = 8, 16
    z, u, dt, p, y = _glue_inputs((2, 37, H, P, 16, 0), torch.bfloat16, dev)
    conv = (p["conv_w"], p["conv_b"], dt, p["dt_bias"], p["A_log"], P)
    xh = u[..., :H * P].unflatten(-1, (H, P))
    norm = (p["D"], p["norm"], 1e-5)
    with pytest.raises(ValueError, match="float32 or"):
        conv_silu_dt(u.half(), *conv)
    with pytest.raises(ValueError, match="expected"):
        conv_silu_dt(u, p["conv_w"], p["conv_b"], dt.float(), *conv[3:])
    with pytest.raises(ValueError, match="is on cpu"):
        conv_silu_dt(u, p["conv_w"].cpu(), *conv[1:])
    with pytest.raises(ValueError, match="contiguous"):
        conv_silu_dt(u.transpose(1, 2).contiguous().transpose(1, 2), *conv)
    with pytest.raises(ValueError, match="contiguous"):
        gated_rms_norm(y.transpose(2, 3).contiguous().transpose(2, 3), xh, z,
                       *norm)
    with pytest.raises(ValueError, match="for y"):
        gated_rms_norm(y, xh, z[..., :-1], *norm)
    w = p["conv_w"].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="has no backward"):
        conv_silu_dt(u, w, *conv[1:])
    with pytest.raises(RuntimeError, match="has no backward"):
        gated_rms_norm(y, xh, z, p["D"], p["norm"].clone().requires_grad_(),
                       1e-5)
    with torch.no_grad():
        conv_silu_dt(u, w, *conv[1:])

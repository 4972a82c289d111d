"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips itself where no CUDA device is present.
Imports no JAX, so it runs on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Tolerances: float32 1e-4 x (1 + |ref|) (another summation order and
``expf``); bfloat16 2^-6 x (|ref| + rms(ref)), two bf16 ulps: both
outputs are rounded to bf16 from float32 values that agree to ~1e-6.
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

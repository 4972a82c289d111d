"""The port's flash attention against the JAX package's, on the CPU.

The port's plain version (the CUDA kernel's oracle, in the model's
(B, S, H, D) layout) is held to the reference's Pallas kernel in
interpret mode and to its jnp oracle ``attention_ref`` (both head-major,
so the inputs are transposed for them), on GQA, MQA, a sliding window, a
ragged key length that is not a multiple of the kernel's key block, and
non-causal attention. Inputs are drawn with numpy and fed to both.

The port's plain q-chunked ``attend`` (the training path) is held to
the reference's ``attend`` and to the plain flash version.

Tolerance: float32, 1e-5 x (1 + |ref|) (summation order only; observed
differences are ~1e-7).

The kernel itself needs the card (``tests/test_torch_kernels_gpu.py``);
here the wrapper's CPU routing, its input checks and its refusal of
inputs that need a gradient are checked.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.config import get_config as jax_config  # noqa: E402
from repro.kernels.flash_attention import attention_ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import (attention,  # noqa: E402
                                                 flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.flash_attention import kernel as K  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402

# name: (B, Sq, Sk, H, KV, D, causal, window)
CASES = {
    "gqa": (2, 40, 40, 4, 2, 16, True, 0),
    "mqa": (2, 40, 40, 6, 1, 16, True, 0),
    "window": (1, 48, 48, 4, 2, 16, True, 8),
    "ragged": (2, 37, 37, 4, 2, 16, True, 0),
    "ragged_sk": (2, 24, 37, 4, 2, 16, False, 0),
    "noncausal": (2, 32, 32, 4, 2, 64, False, 0),
    "noncausal_window": (1, 32, 32, 4, 2, 16, False, 8),
}
BLK = 16          # the reference kernel's block sizes: several blocks a row


def _inputs(case, seed=0):
    B, Sq, Sk, H, KV, D, causal, window = case
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Sk, KV, D)).astype(np.float32)
    v = rng.normal(size=(B, Sk, KV, D)).astype(np.float32)
    return q, k, v, causal, window


def _head_major(x):
    return jnp.asarray(x.transpose(0, 2, 1, 3))


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= 1e-5 * (1 + np.abs(want))), \
        float(np.abs(got - want).max())


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_reference_kernel_and_oracle(name):
    q, k, v, causal, window = _inputs(CASES[name])
    got = flash_attention_plain(torch.tensor(q), torch.tensor(k),
                                torch.tensor(v), causal=causal,
                                window=window).numpy()
    jq, jk, jv = _head_major(q), _head_major(k), _head_major(v)
    kern = jax_flash(jq, jk, jv, causal=causal, window=window, blk_q=BLK,
                     blk_k=BLK, interpret=True)
    oracle = attention_ref(jq, jk, jv, causal=causal, window=window)
    _close(got, np.asarray(kern).transpose(0, 2, 1, 3))
    _close(got, np.asarray(oracle).transpose(0, 2, 1, 3))


def test_plain_sm_scale_and_bf16_output_dtype():
    q, k, v, causal, window = _inputs(CASES["gqa"])
    got = flash_attention_plain(torch.tensor(q), torch.tensor(k),
                                torch.tensor(v), sm_scale=0.3)
    want = attention_ref(_head_major(q), _head_major(k), _head_major(v),
                         sm_scale=0.3)
    _close(got.numpy(), np.asarray(want).transpose(0, 2, 1, 3))
    tb = [torch.tensor(x).bfloat16() for x in (q, k, v)]
    assert flash_attention_plain(*tb).dtype == torch.bfloat16


def test_row_with_no_visible_key_is_zero():
    """Non-causal with a window and Sq > Sk: the last queries see no key
    (``kernel.py:92-95, 103-106`` give 0 there), as in the reference."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(1, 20, 2, 16)).astype(np.float32)
    k = rng.normal(size=(1, 8, 1, 16)).astype(np.float32)
    v = rng.normal(size=(1, 8, 1, 16)).astype(np.float32)
    got = flash_attention_plain(torch.tensor(q), torch.tensor(k),
                                torch.tensor(v), causal=False, window=4)
    want = attention_ref(_head_major(q), _head_major(k), _head_major(v),
                         causal=False, window=4)
    _close(got.numpy(), np.asarray(want).transpose(0, 2, 1, 3))
    assert torch.all(got[:, 11:] == 0)


@pytest.mark.parametrize("name", ["gqa", "window", "ragged"])
def test_wrapper_routes_cpu_tensors_to_the_plain_version(name):
    q, k, v, causal, window = _inputs(CASES[name])
    tq, tk, tv = torch.tensor(q), torch.tensor(k), torch.tensor(v)
    before = flash_attention.launches
    want = flash_attention_plain(tq, tk, tv, causal=causal, window=window)
    for got in (flash_attention(tq, tk, tv, causal=causal, window=window),
                attention(tq, tk, tv, causal=causal, window=window,
                          impl="torch")):
        assert torch.equal(got, want)
    assert flash_attention.launches == before      # no kernel ran


@pytest.mark.parametrize("name", ["gqa", "mqa", "window", "ragged"])
def test_chunked_attend_matches_plain_flash(name):
    """The training path (q-chunked, -1e30 masking) against the plain
    flash version, with the chunk loop running several times."""
    q, k, v, causal, window = _inputs(CASES[name])
    S = q.shape[1]
    chunk = 8 if S % 8 == 0 else 1024
    cfg = get_config("starcoder2-3b", reduced=True).replace(
        dtype="float32", attn_impl="torch", attn_chunk=chunk)
    tq, tk, tv = torch.tensor(q), torch.tensor(k), torch.tensor(v)
    got = A.attend(tq, tk, tv, cfg, causal=causal, window=window)
    want = flash_attention_plain(tq, tk, tv, causal=causal, window=window)
    _close(got.numpy(), want.numpy())


@pytest.mark.parametrize("causal,window,kv_len,chunk", [
    (True, 0, None, 8), (True, 8, None, 16), (False, 8, None, 1024),
    (False, 0, 29, 8), (True, 0, 20, 1024)])
def test_attend_matches_reference_attend(causal, window, kv_len, chunk):
    """The plain path against the reference's ``attend`` (its q-chunked
    XLA path): the window only under the causal mask, the ``kv_len``
    mask, -1e30 masking, several chunks."""
    q, k, v, _, _ = _inputs((2, 32, 32, 4, 2, 16, causal, window))
    cfg = get_config("starcoder2-3b", reduced=True).replace(
        dtype="float32", attn_impl="torch", attn_chunk=chunk)
    jcfg = jax_config("starcoder2-3b", reduced=True).replace(
        dtype="float32", attn_impl="xla", attn_chunk=chunk)
    got = A.attend(torch.tensor(q), torch.tensor(k), torch.tensor(v), cfg,
                   causal=causal, window=window,
                   kv_len=None if kv_len is None else torch.tensor(kv_len))
    want = JA.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jcfg,
                     causal=causal, window=window,
                     kv_len=None if kv_len is None else jnp.asarray(kv_len))
    _close(got.numpy(), np.asarray(want))


def test_cuda_impl_refuses_inputs_that_require_a_gradient():
    q, k, v, causal, window = _inputs(CASES["gqa"])
    tq = torch.tensor(q, requires_grad=True)
    tk, tv = torch.tensor(k), torch.tensor(v)
    cfg = get_config("starcoder2-3b", reduced=True).replace(
        dtype="float32", attn_impl="cuda")
    for call in (lambda: A.attend(tq, tk, tv, cfg),
                 lambda: attention(tq, tk, tv, impl="cuda"),
                 lambda: flash_attention(tq, tk, tv)):
        with pytest.raises(RuntimeError, match="no gradient either"):
            call()
    with torch.no_grad():        # no gradient needed: the refusal lifts
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            A.attend(tq, tk, tv, cfg)
        flash_attention(tq, tk, tv)


def test_cuda_impl_refuses_cpu_tensors_and_kv_len():
    q, k, v, _, _ = _inputs(CASES["gqa"])
    tq, tk, tv = torch.tensor(q), torch.tensor(k), torch.tensor(v)
    cfg = get_config("starcoder2-3b", reduced=True).replace(
        dtype="float32", attn_impl="cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        A.attend(tq, tk, tv, cfg)
    with pytest.raises(ValueError, match="kv_len"):
        A.attend(tq, tk, tv, cfg, kv_len=torch.tensor(5))
    with pytest.raises(ValueError, match="unknown impl"):
        attention(tq, tk, tv, impl="pallas")


def test_kernel_input_checks():
    """The checks the wrapper makes before a launch (shape, head dim,
    dtype, contiguous last axis, 16-byte strides)."""
    q, k, v, _, _ = _inputs(CASES["gqa"])
    tq, tk, tv = torch.tensor(q), torch.tensor(k), torch.tensor(v)
    K._check(tq, tk, tv)
    K._check(tq.bfloat16(), tk.bfloat16(), tv.bfloat16())
    bad = [
        (tq[..., :8], tk[..., :8], tv[..., :8]),            # head dim 8
        (tq.half(), tk.half(), tv.half()),                   # float16
        (tq, tk.bfloat16(), tv),                             # mixed dtypes
        (tq, tk[:, :, :1], tv),                              # k/v shapes
        (tq[:, :, :3], tk, tv),                              # H % KV != 0
        (tq.transpose(1, 3).contiguous().transpose(1, 3), tk, tv),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            K._check(*args)


def test_kernel_input_checks_tma_alignment():
    """The bf16 kernels load tiles with TMA, which needs a 16-byte-aligned
    base and strides that are multiples of 16 bytes: the wrapper refuses
    other layouts (on any device) instead of handing them to the card."""
    B, S, H, KV, D = 2, 40, 4, 2, 64
    q = torch.zeros(B, S, H, D, dtype=torch.bfloat16)
    kv = torch.zeros(B, S, 2 * KV + 1, D + 8, dtype=torch.bfloat16)
    k, v = kv[:, :, :KV, :D], kv[:, :, KV:2 * KV, :D]
    K._check(q, k, v)                    # strided views of a fused output
    flat = torch.zeros(B * S * H * D + 8, dtype=torch.bfloat16)
    shifted = flat[1:1 + B * S * H * D].view(B, S, H, D)     # base + 2 bytes
    with pytest.raises(ValueError, match="TMA"):
        K._check(shifted, k, v)
    odd = torch.zeros(B, S, KV, D + 4, dtype=torch.bfloat16)[..., :D]
    with pytest.raises(ValueError, match="TMA"):   # row stride 136 bytes
        K._check(q, odd, v)
    with pytest.raises(ValueError, match="TMA"):
        K._check(q, k, odd)
    # float32: 16 bytes are 4 elements
    K._check(q.float(), torch.zeros(B, S, KV, D + 4)[..., :D],
             torch.zeros(B, S, KV, D + 4)[..., :D])


def test_no_kernel_is_built_on_the_cpu_path():
    from repro_torch.kernels import build
    q, k, v, _, _ = _inputs(CASES["gqa"])
    flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v))
    assert "flash_attention" not in build._LOADED

"""Decode attention in the PyTorch port: the plain version against the JAX
package's Pallas kernel (interpret mode on the CPU) and its jnp oracle,
plus the wrapper's dispatch and layout checks. The CUDA kernel itself is
held against the plain version on the card (test_torch_kernels_gpu.py
and chip_smoke.py).

Tolerances: float32 1e-5 (the same fp32 softmax in another summation
order); bfloat16 2e-2 (outputs rounded to bf16 in both packages).

The Pallas kernel reads its ragged last key block past the cache, so for
a row whose length exceeds S (with S not a multiple of ``blk_k``) it
returns NaN; it is compared on the other rows, the jnp oracle (which
masks at S) on all of them."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import (decode_attention as jax_kernel,  # noqa: E402
                                            decode_attention_ref)
from repro_torch.kernels.decode_attention import (decode_attend,  # noqa: E402
                                                  decode_attention,
                                                  decode_attention_plain)
from repro_torch.kernels.decode_attention import kernel as K  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}

# B, H, KV, S, D: G = H/KV in {1, 2, 12}, KV in {1, 2}; S is a multiple
# of no block size (the JAX kernel runs with blk_k=16)
CASES = [
    (3, 2, 2, 37, 16),      # G=1
    (3, 2, 1, 37, 16),      # G=2, MQA
    (2, 24, 2, 45, 64),     # G=12, starcoder2's head ratio
]


def _inputs(case, dtype, seed=0):
    B, H, KV, S, D = case
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    k = rng.normal(size=(B, KV, S, D)).astype(np.float32)
    v = rng.normal(size=(B, KV, S, D)).astype(np.float32)
    # ragged, including an empty row and a row past the cache
    lengths = np.array([0, S + 5, 13][:B] if B == 3 else [0, S + 3],
                       np.int32)
    tq = [torch.tensor(a).to(getattr(torch, dtype)) for a in (q, k, v)]
    jq = [jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v)]
    return tq, torch.tensor(lengths), jq, jnp.asarray(lengths)


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_kernel_and_ref(case, window, dtype):
    (q, k, v), lengths, (jq, jk, jv), jlen = _inputs(case, dtype)
    out = decode_attention_plain(q, k, v, lengths, window=window)
    assert out.dtype == q.dtype and out.shape == q.shape
    ref = decode_attention_ref(jq, jk, jv, jlen, window=window)
    pallas = jax_kernel(jq, jk, jv, jlen, window=window, blk_k=16,
                        interpret=True)
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(out), _f32(ref), atol=tol, rtol=tol)
    inside = lengths.numpy() <= case[3]
    np.testing.assert_allclose(_f32(out)[inside], _f32(pallas)[inside],
                               atol=tol, rtol=tol)
    assert np.all(_f32(out)[0] == 0.0)          # length-0 row gives 0


def test_wrapper_on_cpu_is_the_plain_version():
    (q, k, v), lengths, _, _ = _inputs(CASES[2], "float32")
    before = decode_attention.launches
    out = decode_attention(q, k, v, lengths, window=7)
    assert torch.equal(out, decode_attention_plain(q, k, v, lengths,
                                                   window=7))
    assert decode_attention.launches == before   # no kernel was launched


def test_model_layout_entry_and_impl_selection():
    """decode_attend reads the (B, S, KV, D) cache through a transposed
    view; impl='cuda' refuses CPU tensors instead of falling back."""
    (q, k, v), lengths, _, _ = _inputs(CASES[1], "float32")
    kc, vc = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    out = decode_attend(q[:, None], kc, vc, lengths, window=5, impl="torch")
    np.testing.assert_array_equal(
        out[:, 0].numpy(),
        decode_attention_plain(q, k, v, lengths, window=5).numpy())
    with pytest.raises(ValueError, match="CUDA"):
        decode_attend(q[:, None], kc, vc, lengths, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        decode_attend(q[:, None], kc, vc, lengths, impl="pallas")


def test_kernel_input_checks():
    """The launch-side validation runs on CPU tensors too: the model
    layout's transposed view is accepted, bad layouts are refused."""
    B, H, KV, S, D = 2, 4, 2, 40, 64
    q = torch.zeros(B, 1, H, D)[:, 0]
    cache = torch.zeros(B, S, KV, D)
    lengths = torch.zeros(B, dtype=torch.int32)
    K._check(q, cache.transpose(1, 2), cache.transpose(1, 2), lengths)
    with pytest.raises(ValueError, match="contiguous"):
        bad = torch.zeros(B, KV, D, S).transpose(2, 3)
        K._check(q, bad, bad, lengths)
    with pytest.raises(ValueError, match="head dim"):
        K._check(torch.zeros(B, H, 48), torch.zeros(B, KV, S, 48),
                 torch.zeros(B, KV, S, 48), lengths)
    with pytest.raises(ValueError, match="int32"):
        K._check(q, cache.transpose(1, 2), cache.transpose(1, 2),
                 lengths.long())


@pytest.mark.parametrize("B,KV,H,S", [(4, 2, 24, 512), (8, 2, 24, 4096),
                                      (4, 1, 24, 37), (1, 8, 40, 3)])
def test_split_plan_covers_the_cache(B, KV, H, S):
    for tc in (True, False):
        ns, split = K.split_plan(B, KV, H, S, tc=tc)
        assert 1 <= ns <= S and (ns - 1) * split < S <= ns * split
        assert K.split_plan(B, KV, H, S, num_splits=1, tc=tc) == (1, S)
        if tc and ns > 1:            # the tensor-core path splits by tiles
            assert split % K.TILE_KEYS == 0
    # about one tensor-core block per SM where the cache has the tiles
    ns, split = K.split_plan(B, KV, H, S)
    rows = B * KV * -(-(H // KV) // 16)
    tiles = -(-S // K.TILE_KEYS)
    assert ns <= tiles and 2 * ns * rows >= min(K.NUM_SMS, rows * tiles)


def test_kernel_input_checks_tensor_core_alignment():
    """The bf16 path at D = 64 and 128 copies 16-byte chunks: strides and
    data must be 16-byte aligned; the CUDA-core paths need 4 elements."""
    B, H, KV, S, D = 2, 4, 2, 40, 64
    q = torch.zeros(B, H, D, dtype=torch.bfloat16)
    cache = torch.zeros(B, S, KV, D, dtype=torch.bfloat16)
    lengths = torch.zeros(B, dtype=torch.int32)
    K._check(q, cache.transpose(1, 2), cache.transpose(1, 2), lengths)
    odd = torch.zeros(B, S, KV, D + 4, dtype=torch.bfloat16)[..., :D]
    with pytest.raises(ValueError, match="16-byte aligned"):
        K._check(q, odd.transpose(1, 2), cache.transpose(1, 2), lengths)
    # float32 at the same layout (strides of 68 elements) is accepted
    odd32 = torch.zeros(B, S, KV, D + 4)[..., :D]
    K._check(q.float(), odd32.transpose(1, 2), odd32.transpose(1, 2),
             lengths)
    assert K.tensor_cores(torch.bfloat16, 128)
    assert not K.tensor_cores(torch.bfloat16, 16)
    assert not K.tensor_cores(torch.float32, 128)

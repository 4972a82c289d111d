"""The port's RWKV-6 WKV recurrence against the JAX package's, on the CPU.

The port's plain version (the CUDA kernel's oracle, its CPU path and the
model's sequential scan, in the model's (B, S, H, D) layout) is held to
the reference's Pallas kernel in interpret mode and to its oracle
``rwkv6_ref`` (both head-major, so the inputs are transposed for them),
on the reference test's ``RWKV_CASES`` with its pathologically fast
decays (w = exp(-exp(U(-8, 4))), down to ~1.9e-24), with and without a
nonzero initial state, on a ragged S, and across a sequence split in two
with the state carried over (the reference's continuity test). r, k and
v are handed to the port as strided views of one tensor. Inputs are
drawn with numpy from a seed.

Tolerance: float32, 2e-5 x max(1, max|ref|) on outputs and final states,
the reference test's own (the chunked Pallas form sums in another
order); 1e-4 absolute across the split, as the reference's continuity
test.

The kernel itself needs the card (``tests/test_torch_kernels_gpu.py``);
here the wrapper's CPU routing (float32 and bf16 r, k, v), its input
checks and its refusal of inputs that need a gradient are checked, and
that the plain version computes on bf16 r, k, v exactly what it computes
on their float32 widening, rounding o once to bf16.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.rwkv6 import rwkv6_ref  # noqa: E402
from repro.kernels.rwkv6 import rwkv6_scan as jax_rwkv6  # noqa: E402
from repro_torch.kernels.rwkv6 import rwkv6_plain, rwkv6_scan  # noqa: E402
from repro_torch.kernels.rwkv6 import kernel as K  # noqa: E402

# B, H, S, D, reference chunk: the reference test's RWKV_CASES
RWKV_CASES = [
    (2, 4, 64, 16, 16),
    (1, 2, 128, 64, 32),
    (2, 1, 96, 32, 32),
    (1, 8, 64, 64, 64),
]


def _inputs(B, H, S, D, seed=0, s0=False, lo=-8.0, hi=4.0):
    rng = np.random.default_rng(seed)
    rkv = rng.normal(size=(B, S, H, 3 * D)).astype(np.float32)
    w = np.exp(-np.exp(rng.uniform(lo, hi, size=(B, S, H, D)))).astype(
        np.float32)
    u = rng.normal(size=(H, D)).astype(np.float32)
    state = rng.normal(size=(B, H, D, D)).astype(np.float32) if s0 else None
    return rkv, w, u, state


def _split(rkv, D):
    return rkv[..., :D], rkv[..., D:2 * D], rkv[..., 2 * D:]


def _bf16(rkv):
    """r, k, v as bf16 views of one fused bf16 projection."""
    return _split(torch.tensor(rkv).bfloat16(), rkv.shape[-1] // 3)


def _port(rkv, w, u, s0, fn=rwkv6_plain):
    t = torch.tensor(rkv)
    D = w.shape[-1]
    o, st = fn(*_split(t, D), torch.tensor(w), torch.tensor(u),
               None if s0 is None else torch.tensor(s0))
    return o.numpy(), st.numpy()


def _reference(rkv, w, u, s0, chunk=None):
    D = w.shape[-1]
    hm = [jnp.asarray(a.transpose(0, 2, 1, 3)) for a in (*_split(rkv, D), w)]
    s = None if s0 is None else jnp.asarray(s0)
    if chunk is None:
        o, st = rwkv6_ref(*hm, jnp.asarray(u), s)
    else:
        o, st = jax_rwkv6(*hm, jnp.asarray(u), s, chunk=chunk, interpret=True)
    return np.asarray(o).transpose(0, 2, 1, 3), np.asarray(st)


def _close(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=2e-5 * scale, rtol=0)


@pytest.mark.parametrize("s0", [False, True])
@pytest.mark.parametrize("case", RWKV_CASES)
def test_plain_matches_reference_kernel_and_oracle(case, s0):
    B, H, S, D, L = case
    rkv, w, u, state = _inputs(B, H, S, D, s0=s0)
    got_o, got_s = _port(rkv, w, u, state)
    for chunk in (L, None):
        want_o, want_s = _reference(rkv, w, u, state, chunk)
        _close(got_o, want_o)
        _close(got_s, want_s)


@pytest.mark.parametrize("S", [1, 37, 70])
def test_plain_matches_oracle_on_ragged_lengths(S):
    rkv, w, u, state = _inputs(2, 3, S, 16, seed=S, s0=True)
    got_o, got_s = _port(rkv, w, u, state)
    want_o, want_s = _reference(rkv, w, u, state)
    _close(got_o, want_o)
    _close(got_s, want_s)


def test_initial_state_continuity():
    """Running [0:S] in one call == running [0:S/2] then [S/2:S] from the
    carried state, and both agree with the reference kernel's split."""
    rkv, w, u, _ = _inputs(1, 2, 64, 16, seed=5, lo=-4.0, hi=1.0)
    o_full, s_full = _port(rkv, w, u, None)
    h = 32
    o1, s1 = _port(rkv[:, :h], w[:, :h], u, None)
    o2, s2 = _port(rkv[:, h:], w[:, h:], u, s1)
    np.testing.assert_allclose(np.concatenate([o1, o2], axis=1), o_full,
                               atol=1e-4)
    np.testing.assert_allclose(s2, s_full, atol=1e-4)
    j1, js1 = _reference(rkv[:, :h], w[:, :h], u, None, chunk=16)
    j2, js2 = _reference(rkv[:, h:], w[:, h:], u, js1, chunk=16)
    np.testing.assert_allclose(o2, j2, atol=1e-4)
    np.testing.assert_allclose(s2, js2, atol=1e-4)


def test_wrapper_routes_cpu_tensors_to_the_plain_version():
    from repro_torch.kernels import build
    rkv, w, u, state = _inputs(2, 3, 20, 16, s0=True)
    before = rwkv6_scan.launches
    got = _port(rkv, w, u, state, fn=rwkv6_scan)
    want = _port(rkv, w, u, state)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert rwkv6_scan.launches == before
    assert "rwkv6" not in build._LOADED


def test_wrapper_refuses_inputs_that_require_a_gradient():
    rkv, w, u, _ = _inputs(1, 2, 8, 16)
    r, k, v = _split(torch.tensor(rkv), 16)
    tu = torch.tensor(u, requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient either"):
        rwkv6_scan(r, k, v, torch.tensor(w), tu)
    with torch.no_grad():            # no gradient needed: the refusal lifts
        rwkv6_scan(r, k, v, torch.tensor(w), tu)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        rwkv6_scan(*(t.to("meta") for t in (r, k, v, torch.tensor(w),
                                            tu.detach())))


def test_kernel_input_checks():
    """The checks the wrapper makes before a launch (shapes, D up to 64,
    one dtype for r, k and v, float32 w, u and s0, contiguous last axis,
    contiguous u and s0)."""
    rkv, w, u, state = _inputs(2, 3, 10, 16, s0=True)
    r, k, v = _split(torch.tensor(rkv), 16)
    tw, tu, ts = torch.tensor(w), torch.tensor(u), torch.tensor(state)
    K._check(r, k, v, tw, tu, ts)
    K._check(r, k, v, tw, tu, None)
    wide = torch.zeros(2, 10, 3, 80)
    bad = [
        (r, k[:, :9], v, tw, tu, None),                 # shapes differ
        (wide, wide, wide, wide, torch.zeros(3, 80), None),   # D = 80
        (r, k, v, tw, tu[:2], None),                    # u shape
        (r, k, v, tw, tu, ts[:1]),                      # s0 shape
        (r.bfloat16(), k, v, tw, tu, None),             # mixed r/k/v
        (r, k, v, tw, tu, ts.double()),
        (r.transpose(2, 3).contiguous().transpose(2, 3), k, v, tw, tu, None),
        (r, k, v, tw, tu.t().contiguous().t(), None),   # u not contiguous
        (r, k, v, tw, tu, ts.transpose(0, 1).contiguous().transpose(0, 1)),
        (r[:, :0], k[:, :0], v[:, :0], tw[:, :0], tu, None),   # empty
    ]
    for args in bad:
        with pytest.raises(ValueError):
            K._check(*args)


def test_plain_widens_bf16_inputs_exactly():
    """bf16 r, k, v: the plain version computes exactly what it computes on
    their float32 widening, and returns o rounded once to bf16."""
    rkv, w, u, state = _inputs(2, 3, 20, 16, s0=True)
    r, k, v = _bf16(rkv)
    rest = (torch.tensor(w), torch.tensor(u), torch.tensor(state))
    o, st = rwkv6_plain(r, k, v, *rest)
    o32, st32 = rwkv6_plain(r.float(), k.float(), v.float(), *rest)
    assert o.dtype == torch.bfloat16 and st.dtype == torch.float32
    assert torch.equal(o, o32.bfloat16())
    assert torch.equal(st, st32)


def test_wrapper_routes_bf16_cpu_tensors_to_the_plain_version():
    from repro_torch.kernels import build
    rkv, w, u, state = _inputs(2, 3, 20, 16, s0=True)
    r, k, v = _bf16(rkv)
    rest = (torch.tensor(w), torch.tensor(u), torch.tensor(state))
    before = rwkv6_scan.launches
    got_o, got_s = rwkv6_scan(r, k, v, *rest)
    want_o, want_s = rwkv6_plain(r, k, v, *rest)
    assert got_o.dtype == torch.bfloat16 and got_s.dtype == torch.float32
    assert torch.equal(got_o, want_o) and torch.equal(got_s, want_s)
    assert rwkv6_scan.launches == before
    assert "rwkv6" not in build._LOADED


def test_kernel_input_checks_bf16():
    """bf16 r, k, v with float32 w, u and s0 pass, as fused views and as
    the model's contiguous tensors; mixed r/k/v dtypes, float16, a bf16
    w, u or s0, and layouts that the kernel's 16-byte copies cannot read
    are refused."""
    rkv, w, u, state = _inputs(2, 3, 10, 16, s0=True)
    r, k, v = _bf16(rkv)
    tw, tu, ts = torch.tensor(w), torch.tensor(u), torch.tensor(state)
    K._check(r, k, v, tw, tu, ts)
    K._check(r.contiguous(), k.contiguous(), v.contiguous(), tw, tu, None)
    bad_dtypes = [
        (r, k.float(), v, tw, tu, None),                # mixed r/k/v
        (r.float(), k, v.float(), tw, tu, None),
        (r.half(), k.half(), v.half(), tw, tu, None),   # float16
        (r, k, v, tw.bfloat16(), tu, None),             # bf16 w, u, s0
        (r, k, v, tw, tu.bfloat16(), None),
        (r, k, v, tw, tu, ts.bfloat16()),
    ]
    for args in bad_dtypes:
        with pytest.raises(ValueError, match="dtype|float32"):
            K._check(*args)
    odd = torch.zeros(2, 10, 3, 49, dtype=torch.bfloat16)   # 98-byte rows
    wide = torch.zeros(2, 10, 3, 52, dtype=torch.bfloat16)  # 104-byte rows
    d12 = torch.zeros(2, 10, 3, 12, dtype=torch.bfloat16)  # 24-byte rows
    bad_layouts = [
        (odd[..., 1:17], odd[..., 17:33], odd[..., 33:49], tw, tu, None),
        (wide[..., :16], wide[..., 16:32], wide[..., 32:48], tw, tu, None),
        (d12, d12, d12, tw[..., :12].contiguous(), tu[:, :12].contiguous(),
         None),
    ]
    for args in bad_layouts:
        with pytest.raises(ValueError, match="16-byte"):
            K._check(*args)

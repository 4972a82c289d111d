"""The port's SSD scan against the JAX package's, on the CPU.

The port's plain version (the CUDA kernel's oracle and its CPU path, the
per-token recurrence in the model's (B, S, H, P) layout) is held to the
reference's Pallas kernel in interpret mode and to its sequential oracle
``ssd_ref`` (both head-major, so the inputs are transposed for them), on
the reference test's ``SSD_CASES``, and to ``ssd_ref`` on a ragged S (the
Pallas kernel needs S % chunk == 0; the CUDA kernel pads its last chunk).
B and C are handed to the port as column slices of one tensor, as the
model does. The model's chunked ``"torch"`` form is held to the plain
version at several chunk lengths. Inputs are drawn with numpy from a
seed; decays as in the reference test, dA in [-0.5, -0.01].

Tolerance: float32, 2e-5 x max(1, max|ref|), the reference test's own
(the chunked and sequential forms sum in another order).

The kernel itself needs the card (``tests/test_torch_kernels_gpu.py``);
here the wrapper's CPU routing, its input checks (including the bf16
kernel's 16-byte cp.async rules) and its refusal of inputs that need a
gradient are checked.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_scan import ssd_ref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as jax_ssd  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain  # noqa: E402
from repro_torch.kernels.ssd_scan import kernel as K  # noqa: E402
from repro_torch.models import ssm as M  # noqa: E402

# B, H, S, P, N, reference chunk: the reference test's SSD_CASES
SSD_CASES = [
    (2, 4, 64, 16, 16, 16),
    (1, 8, 256, 64, 64, 64),
    (2, 2, 128, 32, 16, 128),
    (1, 1, 32, 8, 8, 8),
]


def _inputs(B, H, S, P, N, seed=0):
    rng = np.random.default_rng(seed)
    xdt = rng.normal(size=(B, S, H, P)).astype(np.float32)
    bc = rng.normal(size=(B, S, 2 * N + 3)).astype(np.float32)
    dA = -rng.uniform(0.01, 0.5, size=(B, S, H)).astype(np.float32)
    return xdt, bc, dA


def _port(xdt, bc, dA, N, fn=ssd_scan_plain):
    t = torch.tensor(bc)
    Bc, Cc = t[..., 1:1 + N], t[..., 1 + N:1 + 2 * N]   # strided columns
    return fn(torch.tensor(xdt), Bc, Cc, torch.tensor(dA)).numpy()


def _reference(xdt, bc, dA, N, chunk=None):
    xt = jnp.asarray(xdt.transpose(0, 2, 1, 3))
    Bc, Cc = jnp.asarray(bc[..., 1:1 + N]), jnp.asarray(bc[..., 1 + N:1 + 2 * N])
    dt = jnp.asarray(dA.transpose(0, 2, 1))
    out = ssd_ref(xt, Bc, Cc, dt) if chunk is None else \
        jax_ssd(xt, Bc, Cc, dt, chunk=chunk, interpret=True)
    return np.asarray(out).transpose(0, 2, 1, 3)


def _close(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=2e-5 * scale, rtol=0)


@pytest.mark.parametrize("case", SSD_CASES)
def test_plain_matches_reference_kernel_and_oracle(case):
    B, H, S, P, N, Q = case
    xdt, bc, dA = _inputs(B, H, S, P, N)
    got = _port(xdt, bc, dA, N)
    _close(got, _reference(xdt, bc, dA, N, chunk=Q))
    _close(got, _reference(xdt, bc, dA, N))


@pytest.mark.parametrize("S", [1, 37, 100])
def test_plain_matches_oracle_on_ragged_lengths(S):
    xdt, bc, dA = _inputs(2, 3, S, 16, 8, seed=S)
    _close(_port(xdt, bc, dA, 8), _reference(xdt, bc, dA, 8))


@pytest.mark.parametrize("Q", [8, 32, 96])
def test_chunked_torch_form_matches_plain(Q):
    """The model's ``ssm_impl="torch"`` scan (the reference's XLA form)
    is the same function as the recurrence, at any chunk that divides S."""
    xdt, bc, dA = _inputs(2, 4, 96, 16, 16, seed=Q)
    got = _port(xdt, bc, dA, 16,
                fn=lambda x, b, c, a: M._ssd_chunked(x, b, c, a, Q))
    _close(got, _port(xdt, bc, dA, 16))


def test_plain_keeps_bf16_dtype():
    xdt, bc, dA = _inputs(1, 2, 20, 16, 8)
    t = torch.tensor(bc).bfloat16()
    y = ssd_scan_plain(torch.tensor(xdt).bfloat16(), t[..., :8], t[..., 8:16],
                       torch.tensor(dA))
    assert y.dtype == torch.bfloat16 and y.shape == (1, 20, 2, 16)


def test_wrapper_routes_cpu_tensors_to_the_plain_version():
    from repro_torch.kernels import build
    xdt, bc, dA = _inputs(2, 4, 40, 16, 16)
    before = ssd_scan.launches
    np.testing.assert_array_equal(_port(xdt, bc, dA, 16, fn=ssd_scan),
                                  _port(xdt, bc, dA, 16))
    assert ssd_scan.launches == before
    assert "ssd_scan" not in build._LOADED


def test_wrapper_refuses_inputs_that_require_a_gradient():
    xdt, bc, dA = _inputs(1, 2, 8, 16, 8)
    x = torch.tensor(xdt, requires_grad=True)
    b = torch.tensor(bc)[..., :8]
    with pytest.raises(RuntimeError, match="no gradient either"):
        ssd_scan(x, b, b, torch.tensor(dA))
    with torch.no_grad():            # no gradient needed: the refusal lifts
        ssd_scan(x, b, b, torch.tensor(dA))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ssd_scan(*(t.to("meta") for t in (x.detach(), b, b,
                                          torch.tensor(dA))))


def test_kernel_input_checks():
    """The checks the wrapper makes before a launch (shapes, dims up to
    64, dtypes, contiguous last axis)."""
    xdt, bc, dA = _inputs(2, 3, 10, 16, 8)
    x, a = torch.tensor(xdt), torch.tensor(dA)
    t = torch.tensor(bc)
    b, c = t[..., :8], t[..., 8:16]
    K._check(x, b, c, a)
    K._check(x.bfloat16(), b.bfloat16(), c.bfloat16(), a)
    wide = torch.zeros(2, 10, 3, 80)
    bad = [
        (x, b, c[..., :4], a),                          # B/C shapes differ
        (x, b[:, :9], c[:, :9], a),                     # S mismatch
        (x, b, c, a[..., :2]),                          # dA heads
        (wide, b, c, a),                                # P = 80 > 64
        (x, torch.zeros(2, 10, 65), torch.zeros(2, 10, 65), a),   # N = 65
        (x.half(), b.half(), c.half(), a),              # float16
        (x, b.bfloat16(), c, a),                        # mixed dtypes
        (x, b, c, a.bfloat16()),                        # dA not float32
        (x.transpose(2, 3).contiguous().transpose(2, 3), b, c, a),
        (x, t.transpose(1, 2).contiguous().transpose(1, 2)[..., :8], c, a),
        (x[:, :0], b[:, :0], c[:, :0], a[:, :0]),       # empty
    ]
    for args in bad:
        with pytest.raises(ValueError):
            K._check(*args)


def test_kernel_input_checks_cp_async_alignment():
    """The bf16 kernel reads 16-byte chunks with cp.async: P and N multiples
    of 8, and bases and strides of xdt, B and C that are multiples of 16
    bytes. The model's column slices of the conv output meet the rules;
    the wrapper refuses other layouts (on any device) before a launch."""
    bf = torch.bfloat16
    B, S, H, P, N = 2, 10, 3, 16, 8
    x = torch.zeros(B, S, H, P, dtype=bf)
    conv = torch.zeros(B, S, H * P + 2 * N, dtype=bf)
    b, c = conv[..., H * P:H * P + N], conv[..., H * P + N:]
    K._check_aligned(x, b, c)              # the model's layout
    flat = torch.zeros(x.numel() + 8, dtype=bf)
    shifted = flat[1:1 + x.numel()].view(B, S, H, P)       # base + 2 bytes
    with pytest.raises(ValueError, match="cp.async"):
        K._check_aligned(shifted, b, c)
    odd = torch.zeros(B, S, 2 * N + 3, dtype=bf)    # row stride 38 bytes
    with pytest.raises(ValueError, match="cp.async"):
        K._check_aligned(x, odd[..., :N], c)
    with pytest.raises(ValueError, match="cp.async"):
        K._check_aligned(x, b, odd[..., 1:1 + N])
    with pytest.raises(ValueError, match="multiples of 8"):
        K._check_aligned(x[..., :12], b, c)
    with pytest.raises(ValueError, match="multiples of 8"):
        K._check_aligned(x, conv[..., :4], conv[..., 4:8])

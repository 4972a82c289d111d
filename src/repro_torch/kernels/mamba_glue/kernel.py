"""The Mamba-2 mixer's glue on Hopper: the wrappers around the two
hand-written CUDA kernels in ``csrc/mamba_glue.cu``.

Replace no TPU kernel: the reference leaves this glue to XLA, which fuses
it; the port's plain version ran it as a chain of PyTorch elementwise
passes that took 55% of zamba2-1.2b's forward on the card. Forward only.

- ``conv_silu_dt``: the causal depthwise conv of width 4 with its bias and
  SiLU, dt's softplus, ``dA`` and ``xdt = x * dt`` in one pass, reading
  the conv input and dt as column slices of the ``in_proj`` output.
- ``gated_rms_norm``: the D skip, the SiLU gate and the float32 RMS norm
  scaled by ``1 + gamma``, one block a row, the input of ``out_proj``.

Both are bound by bytes (each input read once, each output written once;
the design and the rounding are described at the top of the CUDA source):
they round where the plain versions (``ref.py``) do, so their outputs
equal the plain ones but where the float32 sum of squares' order differs.
Both take float32 or bfloat16 data, and any strides with a contiguous
last axis; the vector width is the widest of at most 16 bytes that the
sizes, strides and base addresses allow (``vector_width``), so an
unaligned slice takes narrower loads and is not refused.

Each wrapper takes the plain PyTorch version for a tensor on the CPU, and
for a CUDA tensor launches the kernel or raises: there is no fall-back.
Each refuses inputs that autograd would need a gradient through, on any
device. ``conv_silu_dt.launches`` and ``gated_rms_norm.launches`` count
the calls that launched a kernel (one device launch each).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import build, refuse_grad
from repro_torch.kernels.mamba_glue.ref import (CONV_W, conv_silu_dt_plain,
                                                gated_rms_norm_plain)

SOURCE = Path(__file__).resolve().parent / "csrc" / "mamba_glue.cu"
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 64                        # tokens a conv thread walks
NORM_SMEM = 48 * 1024 - 128      # the norm's row of gated values


@functools.cache
def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernels' shared library."""
    lib = build.load_library("mamba_glue", [SOURCE])
    P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    lib.conv_silu_dt_forward.argtypes = [P] * 9 + [I] * 9 + [LL] * 5 + [P]
    lib.conv_silu_dt_forward.restype = I
    lib.gated_rms_norm_forward.argtypes = ([P] * 6 + [I] * 4 + [F] * 2
                                           + [I] * 2 + [LL] * 6 + [P])
    lib.gated_rms_norm_forward.restype = I
    return lib


def vector_width(elem: int, sizes: Sequence[int],
                 tensors: Sequence[torch.Tensor]) -> int:
    """The widest vector, in elements of ``elem`` bytes and at most 16
    bytes, that divides every one of ``sizes`` and every stride but the
    last of each tensor, and to whose size every tensor's base address is
    aligned."""
    v = 16 // elem
    while v > 1 and not (
            all(n % v == 0 for n in sizes)
            and all(t.data_ptr() % (v * elem) == 0
                    and all(s % v == 0 for s in t.stride()[:-1])
                    for t in tensors)):
        v //= 2
    return v


def _same(name: str, tensors, dtype, device) -> None:
    for t in tensors:
        if t.dtype != dtype or t.device != device:
            raise ValueError(f"{name}: inputs of {t.dtype} on {t.device}, "
                             f"expected {dtype} on {device}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def conv_silu_dt(u: torch.Tensor, conv_w: torch.Tensor,
                 conv_b: torch.Tensor, dt: torch.Tensor,
                 dt_bias: torch.Tensor, A_log: torch.Tensor, head_dim: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The conv input u = [x, B, C] (B, S, C) and the raw dt (B, S, H), any
    strides with a contiguous last axis for u (column slices of one
    projection); conv_w (4, C), conv_b (C), dt_bias and A_log (H) ->
    (conv_out (B, S, C), dA (B, S, H) float32, xdt (B, S, H, head_dim)),
    as ``ref.conv_silu_dt_plain``."""
    refuse_grad("conv_silu_dt", "ssm_impl", u, conv_w, conv_b, dt, dt_bias,
                A_log)
    if u.device.type == "cpu":
        return conv_silu_dt_plain(u, conv_w, conv_b, dt, dt_bias, A_log,
                                  head_dim)
    if u.device.type != "cuda":
        raise ValueError(f"conv_silu_dt runs on CUDA or CPU tensors, got "
                         f"{u.device}")
    if u.dim() != 3 or dt.dim() != 3 or tuple(dt.shape[:2]) != \
            tuple(u.shape[:2]):
        raise ValueError(f"expected u (B,S,C), dt (B,S,H); got "
                         f"{tuple(u.shape)}, {tuple(dt.shape)}")
    Bsz, S, C = u.shape
    H = dt.shape[-1]
    d_in = H * head_dim
    if min(Bsz, S, H, head_dim) <= 0 or d_in > C:
        raise ValueError(f"u {tuple(u.shape)}, dt {tuple(dt.shape)}, head "
                         f"dim {head_dim}: empty, or H x head dim above C")
    if tuple(conv_w.shape) != (CONV_W, C) or tuple(conv_b.shape) != (C,) \
            or tuple(dt_bias.shape) != (H,) or tuple(A_log.shape) != (H,):
        raise ValueError(f"conv_w {tuple(conv_w.shape)}, conv_b "
                         f"{tuple(conv_b.shape)}, dt_bias "
                         f"{tuple(dt_bias.shape)}, A_log "
                         f"{tuple(A_log.shape)} for C {C}, H {H}")
    if u.dtype not in DTYPE_CODES:
        raise ValueError(f"dtypes {u.dtype}: the kernel takes float32 or "
                         f"bfloat16")
    _same("conv_silu_dt", (dt,), u.dtype, u.device)
    for t in (conv_w, conv_b, dt_bias, A_log):
        if t.device != u.device:
            raise ValueError(f"conv_silu_dt: a parameter is on {t.device}, "
                             f"u on {u.device}")
    if u.stride(-1) != 1:
        raise ValueError(f"u: last axis must be contiguous (strides "
                         f"{u.stride()})")
    w = conv_w.to(u.dtype).contiguous()
    b = conv_b.to(u.dtype).contiguous()
    dtb = dt_bias.to(torch.float32).contiguous()
    a_log = A_log.to(torch.float32).contiguous()
    out = torch.empty((Bsz, S, C), dtype=u.dtype, device=u.device)
    dA = torch.empty((Bsz, S, H), dtype=torch.float32, device=u.device)
    xdt = torch.empty((Bsz, S, H, head_dim), dtype=u.dtype, device=u.device)
    vec = vector_width(u.element_size(), (C, head_dim), (u, w, b, out, xdt))
    err = library().conv_silu_dt_forward(
        u.data_ptr(), w.data_ptr(), b.data_ptr(), dt.data_ptr(),
        dtb.data_ptr(), a_log.data_ptr(), out.data_ptr(), dA.data_ptr(),
        xdt.data_ptr(), Bsz, S, C, d_in, head_dim, H, TILE, vec,
        DTYPE_CODES[u.dtype], *u.stride()[:2], *dt.stride(), _stream(u))
    if err != 0:
        raise RuntimeError(f"conv_silu_dt kernel launch failed with CUDA "
                           f"error {err}")
    conv_silu_dt.launches += 1
    return out, dA, xdt


def gated_rms_norm(y: torch.Tensor, xh: torch.Tensor, z: torch.Tensor,
                   D: torch.Tensor, gamma: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """y, xh (B, S, H, P) with P-contiguous heads, z (B, S, H * P), any row
    strides; D (H), gamma (H * P) -> (B, S, H * P) in y's dtype, as
    ``ref.gated_rms_norm_plain`` over the whole of the channels."""
    refuse_grad("gated_rms_norm", "ssm_impl", y, xh, z, D, gamma)
    if y.device.type == "cpu":
        return gated_rms_norm_plain(y, xh, z, D, gamma, eps)
    if y.device.type != "cuda":
        raise ValueError(f"gated_rms_norm runs on CUDA or CPU tensors, got "
                         f"{y.device}")
    if y.dim() != 4 or xh.shape != y.shape or z.dim() != 3:
        raise ValueError(f"expected y, xh (B,S,H,P), z (B,S,H*P); got "
                         f"{tuple(y.shape)}, {tuple(xh.shape)}, "
                         f"{tuple(z.shape)}")
    Bsz, S, H, P = y.shape
    d_in = H * P
    if tuple(z.shape) != (Bsz, S, d_in) or tuple(D.shape) != (H,) \
            or tuple(gamma.shape) != (d_in,) or min(Bsz, S, H, P) <= 0:
        raise ValueError(f"z {tuple(z.shape)}, D {tuple(D.shape)}, gamma "
                         f"{tuple(gamma.shape)} for y {tuple(y.shape)}")
    if y.dtype not in DTYPE_CODES:
        raise ValueError(f"dtypes {y.dtype}: the kernel takes float32 or "
                         f"bfloat16")
    _same("gated_rms_norm", (xh, z), y.dtype, y.device)
    for t in (D, gamma):
        if t.device != y.device:
            raise ValueError(f"gated_rms_norm: a parameter is on {t.device},"
                             f" y on {y.device}")
    for name, t in (("y", y), ("xh", xh)):
        if t.stride(3) != 1 or t.stride(2) != P:
            raise ValueError(f"{name}: heads and channels must be "
                             f"contiguous (strides {t.stride()})")
    if z.stride(-1) != 1:
        raise ValueError(f"z: last axis must be contiguous (strides "
                         f"{z.stride()})")
    if d_in * y.element_size() > NORM_SMEM:
        raise ValueError(f"d_inner {d_in} in {y.dtype}: a row above the "
                         f"kernel's {NORM_SMEM} bytes of shared memory")
    d = D.to(y.dtype).contiguous()
    g = gamma.to(torch.float32).contiguous()
    if g.data_ptr() % 16:
        g = g.clone()
    out = torch.empty((Bsz, S, d_in), dtype=y.dtype, device=y.device)
    vec = vector_width(y.element_size(), (d_in, P), (y, xh, z, out))
    rows = Bsz * S
    # the plain mean's factor, float(rows) / float(rows x d_in) in float32
    inv_n = float(np.float32(rows) / np.float32(rows * d_in))
    err = library().gated_rms_norm_forward(
        y.data_ptr(), xh.data_ptr(), z.data_ptr(), d.data_ptr(),
        g.data_ptr(), out.data_ptr(), Bsz, S, d_in, P, eps, inv_n, vec,
        DTYPE_CODES[y.dtype], *y.stride()[:2], *xh.stride()[:2],
        *z.stride()[:2], _stream(y))
    if err != 0:
        raise RuntimeError(f"gated_rms_norm kernel launch failed with CUDA "
                           f"error {err}")
    gated_rms_norm.launches += 1
    return out


conv_silu_dt.launches = 0
gated_rms_norm.launches = 0

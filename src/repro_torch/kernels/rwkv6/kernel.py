"""RWKV-6 WKV recurrence on Hopper: the wrapper around the hand-written
CUDA kernel in ``csrc/rwkv6.cu``.

Replaces ``repro/kernels/rwkv6/kernel.py::rwkv6_scan`` (the Pallas TPU
kernel, body ``_rwkv6_kernel``), forward only: the reference has no
gradient for it either. r, k and v come in one dtype, float32 or
bfloat16 (the model hands over its projections as they come); w, u and
s0 are float32; o comes back in r's dtype and the final state in
float32. Bound: operations at rwkv6-7b's forward shape (5 flops per
state entry per token at the CUDA cores' float32 rate); the design (the
recurrence token by token, one block per (batch row, head) with the
float32 state in registers and updated with the plain version's
roundings, tokens staged with cp.async and converted to float32 tiles,
the bonus term once per token) is described at the top of the CUDA
source.

The wrapper takes the plain PyTorch version for a tensor on the CPU, and
for a CUDA tensor launches the kernel or raises: there is no fall-back.
It refuses inputs that autograd would need a gradient through, on any
device. ``rwkv6_scan.launches`` counts the calls that launched the kernel
(one device launch each).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, refuse_grad
from repro_torch.kernels.rwkv6.ref import rwkv6_plain

SOURCE = Path(__file__).resolve().parent / "csrc" / "rwkv6.cu"
MAX_DIM = 64                     # D is zero-padded to 64
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's shared library."""
    lib = build.load_library("rwkv6", [SOURCE])
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rwkv6_forward.argtypes = [P] * 8 + [I] * 5 + [LL] * 15 + [P]
    lib.rwkv6_forward.restype = I
    return lib


def _check(r, k, v, w, u, s0) -> None:
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"expected r/k/v/w (B,S,H,D) of one shape, got "
                         f"{[tuple(t.shape) for t in (r, k, v, w)]}")
    B, S, H, D = r.shape
    if min(B, S, H, D) == 0:
        raise ValueError("empty input")
    if D > MAX_DIM:
        raise ValueError(f"head dim {D} above {MAX_DIM}")
    if tuple(u.shape) != (H, D):
        raise ValueError(f"u {tuple(u.shape)}, expected {(H, D)}")
    if s0 is not None and tuple(s0.shape) != (B, H, D, D):
        raise ValueError(f"s0 {tuple(s0.shape)}, expected {(B, H, D, D)}")
    if r.dtype not in DTYPE_CODES or k.dtype != r.dtype \
            or v.dtype != r.dtype:
        raise ValueError(f"r, k and v must share one dtype, float32 or "
                         f"bfloat16; got {r.dtype}, {k.dtype}, {v.dtype}")
    named = [("r", r), ("k", k), ("v", v), ("w", w), ("u", u)]
    if s0 is not None:
        named.append(("s0", s0))
    for name, t in named:
        if name in ("w", "u", "s0") and t.dtype != torch.float32:
            raise ValueError(f"{name} is {t.dtype}: the kernel takes w, u "
                             f"and s0 in float32")
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r on {r.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: last axis must be contiguous "
                             f"(strides {t.stride()})")
    for name, t in (("u", u), ("s0", s0)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in named[:4]:
        size = t.element_size()
        if D * size % 16 or t.data_ptr() % 16 \
                or any(st * size % 16 for st in t.stride()[:3]):
            raise ValueError(
                f"{name}: the kernel reads rows in 16-byte cp.async copies, "
                f"so D x {size} bytes, the data's address and its batch, "
                f"sequence and head strides must be multiples of 16 bytes "
                f"(D {D}, strides {t.stride()})")


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor,
               s0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v (B, S, H, D) in one dtype, float32 or bfloat16; w (B, S, H,
    D) float32, the per-step decay in (0, 1); on CUDA, strides with a
    contiguous last axis that meet the 16-byte rules ``_check`` states.
    u (H, D) and s0 (B, H, D, D) float32, s0 None for a zero initial
    state. Returns (o (B, S, H, D) in r's dtype, final state (B, H, D, D)
    float32)."""
    tensors = [r, k, v, w, u] + ([s0] if s0 is not None else [])
    refuse_grad("rwkv6_scan", "rwkv_impl", *tensors)
    if r.device.type == "cpu":
        return rwkv6_plain(r, k, v, w, u, s0)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan runs on CUDA or CPU tensors, got "
                         f"{r.device}")
    _check(r, k, v, w, u, s0)
    B, S, H, D = r.shape
    o = torch.empty((B, S, H, D), dtype=r.dtype, device=r.device)
    state = torch.empty((B, H, D, D), dtype=torch.float32, device=r.device)
    err = library().rwkv6_forward(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), s0.data_ptr() if s0 is not None else None,
        o.data_ptr(), state.data_ptr(), B, S, H, D, DTYPE_CODES[r.dtype],
        *r.stride()[:3], *k.stride()[:3], *v.stride()[:3], *w.stride()[:3],
        *o.stride()[:3], torch.cuda.current_stream(r.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan kernel launch failed with CUDA "
                           f"error {err}")
    rwkv6_scan.launches += 1
    return o, state


rwkv6_scan.launches = 0

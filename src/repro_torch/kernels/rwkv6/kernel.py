"""RWKV-6 WKV recurrence on Hopper: the wrapper around the hand-written
CUDA kernel in ``csrc/rwkv6.cu``.

Replaces ``repro/kernels/rwkv6/kernel.py::rwkv6_scan`` (the Pallas TPU
kernel, body ``_rwkv6_kernel``), forward only: the reference has no
gradient for it either. Bound: bytes at rwkv6-7b's forward shape (r, k,
v, w read and o written once in float32, ~671 MB at 3.35 TB/s); the
design (the recurrence token by token, one block per (batch row, head)
with the float32 state in registers, no exponentials, so no decay can
overflow and no chunk length matters) is described at the top of the
CUDA source.

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


@functools.cache
def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's shared library."""
    lib = build.load_library("rwkv6", [SOURCE])
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rwkv6_forward.argtypes = [P] * 8 + [I] * 4 + [LL] * 15 + [P]
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
    named = [("r", r), ("k", k), ("v", v), ("w", w), ("u", u)]
    if s0 is not None:
        named.append(("s0", s0))
    for name, t in named:
        if t.dtype != torch.float32:
            raise ValueError(f"{name} is {t.dtype}: the kernel takes "
                             f"float32, as the model passes it")
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r on {r.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: last axis must be contiguous "
                             f"(strides {t.stride()})")
    for name, t in (("u", u), ("s0", s0)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor,
               s0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/w (B, S, H, D) float32 (w the per-step decay in (0, 1)), any
    strides with a contiguous last axis; u (H, D); s0 (B, H, D, D) or
    None for a zero initial state. Returns (o (B, S, H, D) float32,
    final state (B, H, D, D) float32)."""
    tensors = [r, k, v, w, u] + ([s0] if s0 is not None else [])
    refuse_grad("rwkv6_scan", "rwkv_impl", *tensors)
    if r.device.type == "cpu":
        return rwkv6_plain(r, k, v, w, u, s0)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan runs on CUDA or CPU tensors, got "
                         f"{r.device}")
    _check(r, k, v, w, u, s0)
    B, S, H, D = r.shape
    o = torch.empty((B, S, H, D), dtype=torch.float32, device=r.device)
    state = torch.empty((B, H, D, D), dtype=torch.float32, device=r.device)
    err = library().rwkv6_forward(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u.data_ptr(), s0.data_ptr() if s0 is not None else None,
        o.data_ptr(), state.data_ptr(), B, S, H, D,
        *r.stride()[:3], *k.stride()[:3], *v.stride()[:3], *w.stride()[:3],
        *o.stride()[:3], torch.cuda.current_stream(r.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rwkv6_scan kernel launch failed with CUDA "
                           f"error {err}")
    rwkv6_scan.launches += 1
    return o, state


rwkv6_scan.launches = 0

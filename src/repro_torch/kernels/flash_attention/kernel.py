"""Flash attention on Hopper: the wrapper around the hand-written CUDA
kernel in ``csrc/flash_attention.cu``.

Replaces ``repro/kernels/flash_attention/kernel.py::flash_attention``
(the Pallas TPU kernel, body ``_attn_kernel``), forward only: the
reference has no gradient for it either. Bound: operations, ``4 * D``
flops per visible (query, key) pair at 989 TFLOP/s in bf16 (67 TFLOP/s
in float32, which runs without TF32); the design (one block per query
tile, head and batch row, a loop over key tiles in shared memory; for
bf16 at D = 64 and 128 a warp-specialised kernel that loads tiles with
TMA and multiplies with ``wgmma``, P entering P @ V as two bf16 terms at
D = 128 and as fp16 at D = 64) is described at the top of the CUDA
source.

The wrapper takes the plain PyTorch version for a tensor on the CPU, and
for a CUDA tensor launches the kernel or raises: there is no fall-back.
It refuses inputs that autograd would need a gradient through, on any
device. ``flash_attention.launches`` counts the calls that launched the
kernel (one device launch each).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import build, refuse_grad
from repro_torch.kernels.flash_attention.ref import flash_attention_plain

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (16, 64, 128)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's shared library."""
    lib = build.load_library("flash_attention", [SOURCE])
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_forward.argtypes = (
        [P] * 4 + [I] * 7 + [LL] * 12 + [I, I, ctypes.c_float, P])
    lib.flash_attention_forward.restype = I
    return lib


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B,Sq,H,D) and k/v (B,Sk,KV,D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if Sq == 0 or k.shape[1] == 0 or B == 0:
        raise ValueError("empty sequence or batch")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: the kernel "
                         "takes float32 or bfloat16, the same for q, k, v")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: last axis must be contiguous "
                             f"(strides {t.stride()})")
        # TMA's rules (the bf16 kernels load tiles through tensor maps):
        # a 16-byte-aligned base and strides that are multiples of 16 bytes
        if any(s * t.element_size() % 16 for s in t.stride()[:-1]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: TMA needs 16-byte-aligned data and "
                             f"strides that are multiples of 16 bytes "
                             f"(strides {t.stride()}, "
                             f"address {t.data_ptr():#x})")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Sk, KV, D), the model's layout, any
    strides with a contiguous last axis. Returns (B, Sq, H, D) in q's
    dtype. ``window`` <= 0 means global."""
    refuse_grad("flash_attention", "attn_impl", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, "
                         f"got {q.device}")
    _check(q, k, v)
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = D ** -0.5
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    err = library().flash_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Sk, H, KV, D, DTYPE_CODES[q.dtype],
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], int(bool(causal)), int(window), float(sm_scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed with CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0

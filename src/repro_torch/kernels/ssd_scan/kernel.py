"""Mamba-2 SSD scan on Hopper: the wrapper around the hand-written CUDA
kernels in ``csrc/ssd_scan.cu``.

Replaces ``repro/kernels/ssd_scan/kernel.py::ssd_scan`` (the Pallas TPU
kernel, body ``_ssd_kernel``), forward only: the reference has no
gradient for it either. Bound: bytes at zamba2-1.2b's bf16 forward shape
(xdt and y dominate, ~138 MB at 3.35 TB/s, 41.3 us). The C entry picks
the kernel by dtype:

- bfloat16: ``ssd_scan_tc_kernel``. One block of 16 warps per (batch
  row, pair of heads) loops over 64-token chunks; the chunk products run
  on the tensor cores (``mma.sync``, float32 accumulation), the masked
  C B^T and the carried state as bf16 hi + lo, the decay-weighted B as
  one bf16 term; C B^T is formed once per chunk for both heads; chunk
  loads are ``cp.async``, double-buffered; the decay cumsum is a float64
  warp scan. It reads 16-byte chunks, so it takes P and N that are
  multiples of 8 and xdt, B and C whose bases and strides are multiples
  of 16 bytes (the model's column slices are); the wrapper refuses
  others.
- float32: ``ssd_scan_kernel``, one block per (batch row, head), the
  products in float32 on the CUDA cores.

The ragged last chunk is zero-padded; the design is described at the top
of the CUDA source.

The wrapper takes the plain PyTorch version for a tensor on the CPU, and
for a CUDA tensor launches the kernel or raises: there is no fall-back.
It refuses inputs that autograd would need a gradient through, on any
device. ``ssd_scan.launches`` counts the calls that launched a kernel
(one device launch each).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import build, refuse_grad
from repro_torch.kernels.ssd_scan.ref import ssd_scan_plain

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
MAX_DIM = 64                     # N and P are zero-padded to 64
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's shared library."""
    lib = build.load_library("ssd_scan", [SOURCE])
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_scan_forward.argtypes = [P] * 5 + [I] * 6 + [LL] * 13 + [P]
    lib.ssd_scan_forward.restype = I
    return lib


def _check(xdt, Bc, Cc, dA) -> None:
    if xdt.dim() != 4 or Bc.dim() != 3 or Cc.shape != Bc.shape \
            or dA.dim() != 3:
        raise ValueError(f"expected xdt (B,S,H,P), B/C (B,S,N), dA (B,S,H); "
                         f"got {tuple(xdt.shape)}, {tuple(Bc.shape)}, "
                         f"{tuple(Cc.shape)}, {tuple(dA.shape)}")
    Bsz, S, H, P = xdt.shape
    if tuple(Bc.shape[:2]) != (Bsz, S) or tuple(dA.shape) != (Bsz, S, H):
        raise ValueError(f"shape mismatch: xdt {tuple(xdt.shape)}, B/C "
                         f"{tuple(Bc.shape)}, dA {tuple(dA.shape)}")
    if min(Bsz, S, H, P) == 0 or Bc.shape[-1] == 0:
        raise ValueError("empty input")
    if P > MAX_DIM or Bc.shape[-1] > MAX_DIM:
        raise ValueError(f"head dim {P} or state dim {Bc.shape[-1]} above "
                         f"{MAX_DIM}")
    if xdt.dtype not in DTYPE_CODES or Bc.dtype != xdt.dtype \
            or Cc.dtype != xdt.dtype or dA.dtype != torch.float32:
        raise ValueError(f"dtypes {xdt.dtype}/{Bc.dtype}/{Cc.dtype}/"
                         f"{dA.dtype}: the kernel takes xdt, B and C in "
                         f"float32 or bfloat16 (the same) and dA in float32")
    for name, t in (("B", Bc), ("C", Cc), ("dA", dA)):
        if t.device != xdt.device:
            raise ValueError(f"{name} is on {t.device}, xdt on {xdt.device}")
    for name, t in (("xdt", xdt), ("B", Bc), ("C", Cc), ("dA", dA)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: last axis must be contiguous "
                             f"(strides {t.stride()})")


def _check_aligned(xdt, Bc, Cc) -> None:
    """The bf16 kernel reads rows in 16-byte chunks with cp.async: P and N
    multiples of 8, and 16-byte-aligned bases and strides of xdt, B and
    C."""
    P, N = xdt.shape[-1], Bc.shape[-1]
    if P % 8 or N % 8:
        raise ValueError(f"bfloat16: head dim {P} and state dim {N} must be "
                         f"multiples of 8 (16-byte cp.async chunks)")
    for name, t in (("xdt", xdt), ("B", Bc), ("C", Cc)):
        if any(s * t.element_size() % 16 for s in t.stride()[:-1]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: cp.async needs 16-byte-aligned data "
                             f"and strides that are multiples of 16 bytes "
                             f"(strides {t.stride()}, "
                             f"address {t.data_ptr():#x})")


def ssd_scan(xdt: torch.Tensor, Bc: torch.Tensor, Cc: torch.Tensor,
             dA: torch.Tensor) -> torch.Tensor:
    """xdt (B, S, H, P); single-group Bc/Cc (B, S, N); dA (B, S, H)
    float32 <= 0 -> y (B, S, H, P) in xdt's dtype. The model's layout,
    any strides with a contiguous last axis (B and C may be column slices
    of one tensor)."""
    refuse_grad("ssd_scan", "ssm_impl", xdt, Bc, Cc, dA)
    if xdt.device.type == "cpu":
        return ssd_scan_plain(xdt, Bc, Cc, dA)
    if xdt.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on CUDA or CPU tensors, got "
                         f"{xdt.device}")
    _check(xdt, Bc, Cc, dA)
    if xdt.dtype == torch.bfloat16:
        _check_aligned(xdt, Bc, Cc)
    Bsz, S, H, P = xdt.shape
    y = torch.empty((Bsz, S, H, P), dtype=xdt.dtype, device=xdt.device)
    err = library().ssd_scan_forward(
        xdt.data_ptr(), Bc.data_ptr(), Cc.data_ptr(), dA.data_ptr(),
        y.data_ptr(), Bsz, S, H, P, Bc.shape[-1], DTYPE_CODES[xdt.dtype],
        *xdt.stride()[:3], *Bc.stride()[:2], *Cc.stride()[:2],
        *dA.stride()[:3], *y.stride()[:3],
        torch.cuda.current_stream(xdt.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed with CUDA error "
                           f"{err}")
    ssd_scan.launches += 1
    return y


ssd_scan.launches = 0

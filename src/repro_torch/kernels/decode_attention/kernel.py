"""Decode attention on Hopper: the wrapper around the hand-written CUDA
kernel in ``csrc/decode_attention.cu``.

Replaces ``repro/kernels/decode_attention/kernel.py::decode_attention``
(the Pallas TPU kernel, body ``_decode_kernel``). Bound: memory, the valid
KV bytes ``B * KV * min(len, S) * D * 2 * sizeof(dtype)`` at 3.35 TB/s;
the design (split-K over the key axis plus a merge pass, instead of the
TPU's one sequential program per (row, kv-head); for bf16 at D = 64 and
128 a tensor-core pipeline of 64-key tiles) is described at the top of
the CUDA source.

The wrapper takes the plain PyTorch version for a tensor on the CPU, and
for a CUDA tensor launches the kernel or raises: there is no fall-back.
``decode_attention.launches`` counts the calls that launched the kernel;
each such call is one device launch when the plan has one split on the
tensor-core path, else two (the split pass and the merge).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention.ref import decode_attention_plain

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
HEAD_DIMS = (16, 64, 128)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
NUM_SMS = 132            # H100 SXM
TILE_KEYS = 64           # the tensor-core path's key tile
MIN_SPLIT = 32           # CUDA-core path: keys per split below which
                         # splitting stops paying


@functools.cache
def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel's shared library."""
    lib = build.load_library("decode_attention", [SOURCE])
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.decode_attention_forward.argtypes = (
        [P] * 8 + [I] * 6 + [LL] * 8 + [I, ctypes.c_float, I, I, I, P, P])
    lib.decode_attention_forward.restype = I
    return lib


def tensor_cores(dtype: torch.dtype, D: int) -> bool:
    """Whether the CUDA source runs (dtype, D) on its tensor-core path."""
    return dtype == torch.bfloat16 and D in (64, 128)


def heads_per_block(group: int, tc: bool = True) -> int:
    """Query heads one block serves, as the CUDA source picks them: 16 on
    the tensor-core path (mma.sync's M); on the CUDA-core path the GQA
    group size rounded up to a power of two, at most 16."""
    if tc:
        return 16
    gm = 1
    while gm < group and gm < 16:
        gm *= 2
    return gm


def split_plan(B: int, KV: int, H: int, S: int,
               num_splits: Optional[int] = None, *,
               tc: bool = True) -> Tuple[int, int]:
    """(num_splits, keys per split) for a cache of S positions. Chosen
    from shapes only (the lengths stay on the device). Tensor-core path:
    splits of whole 64-key tiles, about one block per SM (each keeps up
    to its ring's depth of tiles in flight; more, shorter blocks measured
    slower at the long shape) and never more splits than tiles; with one
    split the block writes the output and the merge launch is skipped.
    CUDA-core path: about two blocks per SM, each of at least
    ``MIN_SPLIT`` keys."""
    group = H // KV
    rows = B * KV * -(-group // heads_per_block(group, tc))
    if num_splits is None:
        if tc:
            tiles = -(-S // TILE_KEYS)
            num_splits = min(max(1, (NUM_SMS + rows // 2) // rows), tiles)
        else:
            num_splits = min(-(-2 * NUM_SMS // rows), -(-S // MIN_SPLIT))
    num_splits = max(1, min(num_splits, S))
    split = -(-S // num_splits)
    if tc and num_splits > 1:        # whole tiles
        split = min(S, -(-split // TILE_KEYS) * TILE_KEYS)
    return -(-S // split), split


def _check(q, k, v, lengths) -> None:
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B,H,D) and k/v (B,KV,S,D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[1]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: the kernel "
                         "takes float32 or bfloat16, the same for q, k, v")
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (B,):
        raise ValueError("lengths must be int32 of shape (B,)")
    for name, t in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    # the tensor-core path copies 16-byte chunks, the CUDA-core path
    # reads 4 elements at a time
    align = 16 if tensor_cores(q.dtype, D) else 4 * q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: last axis must be contiguous "
                             f"(strides {t.stride()})")
        if any(s * t.element_size() % align for s in t.stride()[:-1]) \
                or t.data_ptr() % align:
            raise ValueError(f"{name}: every stride and the data must be "
                             f"{align}-byte aligned (strides {t.stride()})")
    if not lengths.is_contiguous():
        raise ValueError("lengths must be contiguous")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *, window: int = 0,
                     num_splits: Optional[int] = None, offset: int = 0,
                     return_lse: bool = False):
    """q: (B, H, D) one token; k/v: (B, KV, S, D), any strides with a
    contiguous last axis (a ``transpose(1, 2)`` view of the model's
    (B, S, KV, D) cache is read in place); lengths: (B,) int32. Returns
    (B, H, D) in q's dtype. Key j holds position ``offset + j`` (a block
    of a cache split on its positions; the kernel takes the visible keys
    in block coordinates from it); lengths past the block count up to
    its end. ``return_lse`` also returns the (2, B, H) float32 (m, l)
    partial of ``decode_attention_plain``, which the kernel writes where
    it finishes a row (one more store per (row, head)).
    ``num_splits`` overrides the split plan (tests use it to reach the
    one-split path)."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, lengths, window=window,
                                      offset=offset, return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on CUDA or CPU tensors, "
                         f"got {q.device}")
    _check(q, k, v, lengths)
    B, H, D = q.shape
    KV, S = k.shape[1], k.shape[2]
    tc = tensor_cores(q.dtype, D)
    ns, split = split_plan(B, KV, H, S, num_splits, tc=tc)
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    # float32 partials (m, l, acc) for the merge pass; none when the
    # tensor-core path's single split writes the output itself
    np_ = ns if ns > 1 or not tc else 0
    part_ml = torch.empty((2, B, H, np_), dtype=torch.float32,
                          device=q.device)
    part_acc = torch.empty((B, H, np_, D), dtype=torch.float32,
                           device=q.device)
    lse = (torch.empty((2, B, H), dtype=torch.float32, device=q.device)
           if return_lse else None)
    err = library().decode_attention_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), part_ml[0].data_ptr(), part_ml[1].data_ptr(),
        part_acc.data_ptr(),
        B, H, KV, S, D, DTYPE_CODES[q.dtype],
        q.stride(0), q.stride(1),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        int(window), D ** -0.5, ns, split, int(offset),
        None if lse is None else lse[0].data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed with CUDA "
                           f"error {err}")
    decode_attention.launches += 1
    return (out, lse) if return_lse else out


decode_attention.launches = 0

"""The yardstick's arithmetic: the H100's published peaks, the closed-form
forward FLOPs of a model configuration, and each kernel's least time from
the operations and bytes its inputs need.

Copies, kept with the benchmark so that a change to the program cannot
move them:

- ``fwd_flops`` is ``repro_torch/analytic.py::fwd_flops`` (2 m n k per
  matrix product, the average causal context for attention), with one
  correction: under a sliding window the attention term counts the mean
  number of keys a query sees (3,584 at S = 16,384 with a window of
  4,096) where the original counts the whole window for every query;
- ``flash_bound``, ``ssd_bound``, ``wkv_bound`` and ``decode_bound`` are
  ``chip_smoke.py``'s ``flash_bound_ms``, ``ssd_bound_ms``,
  ``wkv_bound_ms`` and ``bound_ms``, in seconds: each input byte read
  once and each output byte written once against the memory rate, and
  the operations the inputs need against the peak for the dtype;
- the peaks are NVIDIA's data sheet for the H100 SXM at 700 W, dense
  rates, as ``repro_torch/roofline.py`` holds them.

A configuration is a mapping with the port's ``ModelConfig`` field names
(the ``model`` object of a file under ``configs/``). The forward FLOPs of
a family this file does not count come from ``flops/<family>.py``, found
by name: its ``fwd_flops(model, batch, seq, kv_len)`` gives the whole
forward, unembedding included, as ``fwd_flops`` here does.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Any, Callable, Mapping, Optional, Tuple

FLOPS = Path(__file__).resolve().parent / "flops"
FAMILIES = ("dense", "vlm", "moe", "hybrid", "ssm", "encdec")

PEAK_FLOPS_BF16 = 989e12          # tensor cores, bf16 / fp16
PEAK_FLOPS_FP32 = 67e12           # float32 outside the tensor cores
HBM_BW = 3.35e12                  # bytes/s

# ModelConfig's defaults for the fields the counts read
_DEFAULTS = {"sliding_window": 0, "global_every": 0, "gated_mlp": True,
             "num_experts": 0, "top_k": 0, "num_shared_experts": 0,
             "dense_ff": 0, "first_dense_layers": 0, "ssm_expand": 2,
             "ssm_chunk": 128, "shared_attn_every": 0, "rwkv_head_dim": 64,
             "enc_layers": 0, "dec_layers": 0}


class _Cfg:
    def __init__(self, model: Mapping[str, Any]):
        self._m = model

    def __getattr__(self, key: str):
        if key in self._m:
            return self._m[key]
        if key in _DEFAULTS:
            return _DEFAULTS[key]
        raise AttributeError(key)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def is_global_layer(self, i: int) -> bool:
        if self.sliding_window == 0 or self.global_every == 0:
            return True
        return (i + 1) % self.global_every == 0


def roof(flops: float, nbytes: float, dtype: str = "bfloat16") -> float:
    """Least time in seconds: the larger of the operations at the peak
    for ``dtype`` and the bytes at the memory rate."""
    peak = PEAK_FLOPS_FP32 if dtype == "float32" else PEAK_FLOPS_BF16
    return max(flops / peak, nbytes / HBM_BW)


def visible_pairs(s_q: int, s_k: int, causal: bool, window: int) -> int:
    """(query, key) pairs a query block sees: query i of ``s_q`` sees
    keys up to i when causal (queries and keys aligned at the start), and
    only the last ``window`` of them when ``window`` > 0 (the window
    applies to causal attention only, as in the program)."""
    if not causal:
        return s_q * s_k
    n = min(s_q, s_k)
    full = n * (n + 1) // 2
    if window <= 0 or window >= n:
        return full
    return window * (window + 1) // 2 + (n - window) * window


# ---------------------------------------------------------------------------
# Forward FLOPs (global) per family
# ---------------------------------------------------------------------------

def _attn_flops(c: _Cfg, T: float, kv_len: float, *, causal: bool,
                window: int, seq: Optional[int] = None) -> float:
    H, KV, Dh, d = c.num_heads, c.num_kv_heads, c.head_dim, c.d_model
    proj = 2 * T * d * (H * Dh + 2 * KV * Dh) + 2 * T * H * Dh * d
    if window and window > 0 and seq is not None:
        seff = visible_pairs(seq, seq, True, window) / seq
    elif window and window > 0:
        seff = min(window, kv_len)
    elif causal:
        seff = (kv_len + 1) / 2
    else:
        seff = kv_len
    return proj + 2 * T * seff * H * Dh * 2          # QK^T and PV


def _mlp_flops(c: _Cfg, T: float, d_ff: Optional[int] = None,
               gated: Optional[bool] = None) -> float:
    f = d_ff if d_ff is not None else c.d_ff
    g = c.gated_mlp if gated is None else gated
    return (6 if g else 4) * T * c.d_model * f


def _moe_flops(c: _Cfg, T: float) -> float:
    d, f = c.d_model, c.d_ff
    routed = 6 * T * d * f * c.top_k
    shared = 6 * T * d * f * c.num_shared_experts
    router = 2 * T * d * c.num_experts
    dense = (6 * T * d * c.dense_ff
             if c.dense_ff and not c.first_dense_layers else 0)
    return routed + shared + router + dense


def _mamba_flops(c: _Cfg, T: float) -> float:
    d, d_in = c.d_model, c.ssm_d_inner
    H, P, N, Q = c.ssm_heads, c.ssm_head_dim, c.ssm_state, c.ssm_chunk
    proj = 2 * T * d * (2 * d_in + 2 * N + H)
    conv = 2 * T * (d_in + 2 * N) * 4
    ssd = 2 * T * Q * N + 2 * T * Q * P * H + 4 * T * N * P * H
    out = 2 * T * d_in * d
    return proj + conv + ssd + out


def _rwkv_flops(c: _Cfg, T: float) -> float:
    d, f, Dh = c.d_model, c.d_ff, c.rwkv_head_dim
    tmix = 5 * 2 * T * d * d + 2 * 2 * T * d * 64
    wkv = 5 * T * d * Dh
    cmix = 2 * T * (2 * d * f + d * d)
    return tmix + wkv + cmix


def fwd_flops(model: Mapping[str, Any], batch: int, seq: int, *,
              kv_len: Optional[float] = None) -> float:
    """Global forward FLOPs for ``batch`` sequences of ``seq`` new tokens;
    ``kv_len`` overrides the attention context (decode: the cache)."""
    c = _Cfg(model)
    T = float(batch) * seq
    kv = float(kv_len if kv_len is not None else seq)
    full_seq = seq if kv_len is None else None
    fam = c.family
    if fam not in FAMILIES:
        return family_flops(fam)(model, batch, seq, kv_len)
    total = 2 * T * c.d_model * c.vocab_size             # unembed

    if fam in ("dense", "vlm"):
        for i in range(c.num_layers):
            w = 0 if c.is_global_layer(i) else c.sliding_window
            total += _attn_flops(c, T, kv, causal=True, window=w,
                                 seq=full_seq)
            total += _mlp_flops(c, T)
    elif fam == "moe":
        nd = c.first_dense_layers
        for _ in range(nd):
            total += _attn_flops(c, T, kv, causal=True, window=0)
            total += _mlp_flops(c, T, d_ff=c.dense_ff, gated=True)
        for _ in range(c.num_layers - nd):
            total += _attn_flops(c, T, kv, causal=True, window=0)
            total += _moe_flops(c, T)
    elif fam == "hybrid":
        n_shared = c.num_layers // c.shared_attn_every
        total += c.num_layers * _mamba_flops(c, T)
        total += n_shared * (_attn_flops(c, T, kv, causal=True, window=0)
                             + _mlp_flops(c, T))
    elif fam == "ssm":
        total += c.num_layers * _rwkv_flops(c, T)
    elif fam == "encdec":
        ne = seq // 2
        nd = seq - ne
        Tenc, Tdec = float(batch) * ne, float(batch) * nd
        for _ in range(c.enc_layers):
            total += _attn_flops(c, Tenc, ne, causal=False, window=0)
            total += _mlp_flops(c, Tenc)
        for _ in range(c.dec_layers):
            total += _attn_flops(c, Tdec, kv if kv_len else nd,
                                 causal=True, window=0)
            total += _attn_flops(c, Tdec, ne, causal=False, window=0)
            total += _mlp_flops(c, Tdec)
        total -= 2 * T * c.d_model * c.vocab_size
        total += 2 * Tdec * c.d_model * c.vocab_size
    return total


def family_flops(family: str) -> Callable[..., float]:
    """``fwd_flops`` of ``flops/<family>.py``, for a family this file
    does not count."""
    path = FLOPS / f"{family}.py"
    if not path.is_file():
        raise ValueError(f"no FLOP count for family {family!r}: add "
                         f"bench_port/flops/{family}.py with "
                         f"fwd_flops(model, batch, seq, kv_len)")
    spec = importlib.util.spec_from_file_location(
        f"bench_port_flops_{family}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.fwd_flops


# ---------------------------------------------------------------------------
# Kernel bounds: (least seconds, flops, bytes)
# ---------------------------------------------------------------------------

def _size(dtype: str) -> int:
    return 2 if dtype == "bfloat16" else 4


def flash_bound(B: int, Sq: int, Sk: int, H: int, KV: int, D: int,
                causal: bool, window: int, dtype: str = "bfloat16"
                ) -> Tuple[float, float, float]:
    """4 D flops per visible (query, key) pair and head (Q K^T and P V);
    q, k, v read once and the output written once."""
    flops = 4 * B * H * D * visible_pairs(Sq, Sk, causal, window)
    nbytes = (2 * B * Sq * H * D + 2 * B * Sk * KV * D) * _size(dtype)
    return roof(flops, nbytes, dtype), flops, nbytes


def ssd_bound(B: int, S: int, H: int, P: int, N: int,
              dtype: str = "bfloat16") -> Tuple[float, float, float]:
    """xdt, B, C and dA read once and y written once; the chunked
    algorithm's operations at 64-token chunks, C B^T formed once per
    chunk for all heads and only its lower triangle used."""
    Q, nc = 64, -(-S // 64)
    tri = Q * (Q + 1) // 2
    flops = B * nc * (2 * tri * N + H * (2 * tri * P + 4 * Q * N * P))
    nbytes = (2 * B * S * H * P + 2 * B * S * N) * _size(dtype) \
        + 4 * B * S * H
    return roof(flops, nbytes, dtype), flops, nbytes


def wkv_bound(B: int, S: int, H: int, D: int, with_s0: bool,
              dtype: str = "float32") -> Tuple[float, float, float]:
    """r, k, v (in ``dtype``), w, u and s0 (float32) read once, o and the
    final state written once; 5 flops per state entry, token and head,
    at the float32 peak."""
    flops = 5 * B * S * H * D * D
    nbytes = (4 * _size(dtype) + 4) * B * S * H * D + 4 * (
        H * D + (2 if with_s0 else 1) * B * H * D * D)
    return roof(flops, nbytes, "float32"), flops, nbytes


def decode_bound(B: int, H: int, KV: int, S: int, D: int, window: int,
                 lengths, dtype: str = "bfloat16"
                 ) -> Tuple[float, float, float]:
    """One decode step's attention: q read and the output written once,
    the visible K and V positions of each row read once; 4 D flops per
    visible (head, position)."""
    valid = []
    for n in lengths:
        lo = max(n - window, 0) if window > 0 else 0
        valid.append(max(min(n, S) - lo, 0))
    nbytes = (2 * B * H * D + 2 * KV * D * sum(valid)) * _size(dtype) + 4 * B
    flops = 4 * H * D * sum(valid)
    return roof(flops, nbytes, dtype), flops, nbytes

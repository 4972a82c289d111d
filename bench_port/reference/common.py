"""Plain float32 building blocks of the reference models: matrix products
at a stated precision, RMS norm, rotary embeddings, causal attention with
a sliding window, the MLPs, the cross-entropy, and AdamW with global-norm
clipping and a warm-up cosine schedule.

Plain PyTorch only; nothing of the program is imported. Every function
computes in float32 with TF32 off (callers run under :func:`strict_fp32`).
``prec="fp8"`` is the benchmark's control: every matrix product of a
linear layer (projections, MLP, unembedding) rounds its operands to
float8 e4m3 with a per-tensor scale, and in the backward the incoming
gradient to e5m2, as fp8 training does; the products accumulate in
float32. Attention scores, norms and recurrences stay float32.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Mapping

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

PRECISIONS = ("float32", "fp8")
E4M3_MAX = 448.0
E5M2_MAX = 57344.0


@contextlib.contextmanager
def strict_fp32() -> Iterator[None]:
    """TF32 off for matrix products and convolutions while inside."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _round(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).float() * scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa = _round(a, torch.float8_e4m3fn, E4M3_MAX)
        qb = _round(b, torch.float8_e4m3fn, E4M3_MAX)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _round(g, torch.float8_e5m2, E5M2_MAX)
        ga = qg @ qb.T
        gb = (qa.reshape(-1, qa.shape[-1]).T
              @ qg.reshape(-1, qg.shape[-1]))
        return ga, gb


def linear(x: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    """x (..., k) @ w (k, n) at ``prec``."""
    if prec == "float32":
        return x @ w
    if prec == "fp8":
        return _Fp8Matmul.apply(x, w)
    raise ValueError(f"unknown precision {prec!r}; one of {PRECISIONS}")


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """x / rms(x) x (1 + gamma): the gain is stored around zero."""
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + gamma)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (B, S, H, D) at positions 0 .. S-1, the two
    halves of the head rotated together (not interleaved); the angles in
    float64."""
    S, D = x.shape[1], x.shape[-1]
    half = D // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64,
                                  device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              window: int, block: int = 512) -> torch.Tensor:
    """Causal GQA attention. q (B, S, H, D), k/v (B, S, KV, D); query i
    sees keys j with i - window < j <= i (``window`` <= 0: every j <= i).
    Computed in blocks of ``block`` queries over the keys they can see."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, D)
    outs = []
    for q0 in range(0, S, block):
        q1 = min(S, q0 + block)
        k0 = max(0, q0 - window + 1) if window > 0 else 0
        s = torch.einsum("bqkgd,bskd->bkgqs", qg[:, q0:q1], k[:, k0:q1])
        s = s * (1.0 / math.sqrt(D))
        i = torch.arange(q0, q1, device=q.device)[:, None]
        j = torch.arange(k0, q1, device=q.device)[None, :]
        ok = j <= i
        if window > 0:
            ok = ok & (j > i - window)
        s = s.masked_fill(~ok, float("-inf"))
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bkgqs,bskd->bqkgd", p, v[:, k0:q1]))
    return torch.cat(outs, dim=1).reshape(B, S, H, D)


def attention_block(p: Mapping, x: torch.Tensor, m: Mapping, window: int,
                    prec: str) -> torch.Tensor:
    """x + the attention of rms(x): q/k/v projections (with their biases
    when the config has them), RoPE, causal attention, output projection."""
    B, S, d = x.shape
    H, KV, Dh = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    h = rms_norm(x, p["ln1"]["gamma"], m["norm_eps"])
    a = p["attn"]
    q = linear(h, a["wq"].reshape(d, H * Dh), prec).reshape(B, S, H, Dh)
    k = linear(h, a["wk"].reshape(d, KV * Dh), prec).reshape(B, S, KV, Dh)
    v = linear(h, a["wv"].reshape(d, KV * Dh), prec).reshape(B, S, KV, Dh)
    if m.get("qkv_bias", False):
        q, k, v = q + a["bq"], k + a["bk"], v + a["bv"]
    q, k = rope(q, m["rope_theta"]), rope(k, m["rope_theta"])
    o = attention(q, k, v, window)
    return x + linear(o.reshape(B, S, H * Dh), a["wo"].reshape(H * Dh, d),
                      prec)


def mlp_block(p: Mapping, x: torch.Tensor, m: Mapping, prec: str
              ) -> torch.Tensor:
    """x + the MLP of rms(x): SiLU-gated (``gated_mlp``) or tanh-GeLU."""
    h = rms_norm(x, p["ln2"]["gamma"], m["norm_eps"])
    f = p["mlp"]
    u = linear(h, f["wi"], prec)
    if m.get("gated_mlp", True):
        u = F.silu(linear(h, f["wg"], prec)) * u
    else:
        u = F.gelu(u, approximate="tanh")
    return x + linear(u, f["wo"], prec)


def logits(params: Mapping, x: torch.Tensor, m: Mapping, prec: str
           ) -> torch.Tensor:
    """Final norm, then the unembedding (the embedding's transpose when
    tied)."""
    h = rms_norm(x, params["final_norm"]["gamma"], m["norm_eps"])
    e = params["embed"]
    w = e["tok"].T if m.get("tie_embeddings", False) else e["out"]
    return linear(h, w, prec)


def nll(lg: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of logits (B, S, V) against labels (B, S)."""
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]), labels.reshape(-1))


def schedule(step: int, sched: Mapping) -> float:
    """Linear warm-up over ``warmup_steps``, then cosine from 1 down to
    ``min_ratio`` at ``total_steps`` (``kind`` "cosine"), or flat
    (``"constant"``): the multiplier of the base learning rate at
    ``step`` (0-based)."""
    warm = min(1.0, (step + 1.0) / max(1, sched["warmup_steps"]))
    if sched["kind"] == "constant":
        return warm
    if sched["kind"] != "cosine":
        raise ValueError(sched["kind"])
    w, total = sched["warmup_steps"], sched["total_steps"]
    frac = min(max((step - w) / max(1, total - w), 0.0), 1.0)
    lo = sched["min_ratio"]
    return warm * (lo + (1 - lo) * 0.5 * (1.0 + math.cos(math.pi * frac)))


class AdamW:
    """AdamW on a dict of float32 leaves: bias-corrected moments, the
    update divided by sqrt(v-hat) + eps, decoupled weight decay
    (``lr * wd * p``), after scaling the gradients so that their global
    norm is at most ``grad_clip``."""

    def __init__(self, params: Dict[str, torch.Tensor], opt: Mapping):
        self.params, self.h = params, opt
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], lr: float
             ) -> Dict[str, float]:
        """One update; returns each leaf's clipped gradient norm."""
        h = self.h
        norm = math.sqrt(sum(_sq(g) for g in grads.values()))
        scale = min(1.0, h["grad_clip"] / (norm + 1e-9)) \
            if h["grad_clip"] > 0 else 1.0
        self.t += 1
        c1 = 1.0 - h["beta1"] ** self.t
        c2 = 1.0 - h["beta2"] ** self.t
        norms = {}
        for k, p in self.params.items():
            sq = 0.0
            for sl in _slices(p.numel()):
                pp, m, v = (t.view(-1)[sl] for t in (p, self.m[k], self.v[k]))
                g = grads[k].reshape(-1)[sl] * scale
                sq += _sq(g)
                m.mul_(h["beta1"]).add_(g, alpha=1 - h["beta1"])
                v.mul_(h["beta2"]).addcmul_(g, g, value=1 - h["beta2"])
                upd = (m / c1) / ((v / c2).sqrt() + h["eps"])
                pp.sub_(lr * (upd + h["weight_decay"] * pp))
            norms[k] = math.sqrt(sq)
        return norms


def _sq(g: torch.Tensor) -> float:
    return sum(float(torch.linalg.vector_norm(g.reshape(-1)[sl])) ** 2
               for sl in _slices(g.numel()))


def _slices(n: int, size: int = 1 << 24):
    return [slice(i, min(n, i + size)) for i in range(0, n, size)]


def stacked(tree: Mapping, axes: int) -> List[Dict]:
    """The layers of a stacked subtree with ``axes`` leading stack axes,
    in order, as dicts of views: one ``unbind`` a leaf and stack axis,
    whose backward stacks the layers' gradients once (indexing a layer
    at a time would make each layer's backward a zero tensor of the
    whole stack). A leaf given as a list is already split on its first
    axis (the training steps' layers, each a leaf of its own)."""
    if axes == 0:
        return [tree]
    parts = _map(lambda v: v if isinstance(v, list) else v.unbind(0), tree)
    n = len(next(iter(_leaves(parts))))
    return [layer for i in range(n)
            for layer in stacked(_map(lambda p: p[i], parts), axes - 1)]


def _map(fn, tree: Mapping) -> Dict:
    return {k: _map(fn, v) if isinstance(v, Mapping) else fn(v)
            for k, v in tree.items()}


def _leaves(tree: Mapping):
    for v in tree.values():
        if isinstance(v, Mapping):
            yield from _leaves(v)
        else:
            yield v


def checkpointed(fn, *args, remat: bool):
    """``fn(*args)``, its activations recomputed in the backward when
    ``remat`` (plain ``torch.utils.checkpoint``), so that a layer's
    intermediates do not all stay alive at once."""
    if remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)

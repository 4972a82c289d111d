"""Mamba-2 (SSD) block, the zamba2 backbone layer (counterpart of
``repro.models.ssm``).

The full-sequence path runs the SSD scan: ``cfg.ssm_impl == "cuda"`` the
hand-written kernel (``repro_torch.kernels.ssd_scan``, which picks its own
chunk length and takes any S), ``"torch"`` the reference's chunked form
(intra-chunk quadratic term plus an inter-chunk state recurrence, in
chunks of ``cfg.ssm_chunk``, or one chunk when S is not a multiple of it).
Around the scan, ``"cuda"`` also runs the mixer's glue as two hand-written
kernels (``repro_torch.kernels.mamba_glue``): the causal conv with SiLU,
dt's softplus, ``dA`` and ``xdt`` in one pass, and the skip-gated RMS
norm in another; ``"torch"`` runs their plain versions (``mamba_glue.ref``,
the one copy of that arithmetic), equal to them but for the norm's sum
order. Decode is the O(1) single-step state update, on the plain glue.
Decay accumulations run in float32.

Single B/C group (G=1), conv width 4, Mamba-2 gated-RMSNorm output.
``A_log``, ``dt_bias`` and the gated norm's ``norm`` are stored in
float32 always: the reference reads them in float32.

Tensor parallelism: the leaves may come as ``sharding.Sharded`` leaves.
Where ``A_log``'s spec splits the heads over model ranks (the ``tp``
layout), each rank runs its H/M heads: of ``in_proj`` the columns of
its z, x and dt and the B and C columns whole (one B/C group, which
every head reads), of the conv its x channels and B and C. Those
leaves' contiguous blocks do not follow the heads (``in_proj``'s axis
concatenates z, x, B, C and dt), so ``sharding.take_ranges`` regroups
them per use. The conv kernel runs on the rank's [x_i, B, C] slice like
on any other (the conv is depthwise); the gated norm's mean of squares is
summed over the ranks between the sum of squares and the scale, so under
tp the norm takes its plain version. ``out_proj`` is row-parallel and
its output summed over the ranks.
The decode cache then holds the rank's block: its heads' ``state`` and
its conv channels [x, B, C]. Where the heads do not split, the layer
computes on whole leaves.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import sharding as SH
from repro_torch.config import ModelConfig
from repro_torch.kernels.mamba_glue import (conv_silu_dt, conv_silu_dt_plain,
                                            gated_rms_norm,
                                            gated_rms_norm_plain)
from repro_torch.kernels.mamba_glue.ref import CONV_W
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import layers as L
from repro_torch.obs.profiling import (SSM_MIXER, SSM_PROJ, SSM_SCAN,
                                       annotate_span)

Tree = Dict[str, torch.Tensor]


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    d_in = cfg.ssm_d_inner
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    assert H * P == d_in, (H, P, d_in)
    return d_in, H, P, N


def init_mamba2(gen, cfg: ModelConfig, *, dtype, device) -> Tree:
    d = cfg.d_model
    d_in, H, P, N = _dims(cfg)
    conv_dim = d_in + 2 * N
    kw = dict(dtype=dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": L.param(gen, (d, 2 * d_in + 2 * N + H), **kw),
        "conv_w": L.param(gen, (CONV_W, conv_dim), scale=0.5, **kw),
        "conv_b": L.param(gen, (conv_dim,), init="zeros", **kw),
        "A_log": L.param(gen, (H,), init="zeros", **f32),
        "D": L.param(gen, (H,), init="ones", **kw),
        "dt_bias": L.param(gen, (H,), init="zeros", **f32),
        "norm": L.param(gen, (d_in,), init="zeros", **f32),
        "out_proj": L.param(gen, (d_in, d), **kw),
    }


Split = Tuple[Optional[SH.Mesh], Tuple[str, ...]]


def _local(p: Tree, cfg: ModelConfig) -> Tuple[Tree, Split]:
    """(the leaves the rank computes with, the (mesh, axes) its heads are
    split over, ``(None, ())`` when they are not): module docstring."""
    mesh, axes = SH.split_group(p["A_log"])
    if not axes:
        return SH.whole_tree(p), (None, ())
    n = mesh.group_size(axes)
    d_in, H, _, N = _dims(cfg)
    dl, hl = d_in // n, H // n

    def block(size):
        return lambda i: [(i * size, (i + 1) * size)]

    def conv(i, base=0):                        # [x_i, B, C]
        return [(base + i * dl, base + (i + 1) * dl),
                (base + d_in, base + d_in + 2 * N)]

    def proj(i):                                # [z_i, x_i, B, C, dt_i]
        dt0 = 2 * d_in + 2 * N
        return ([(i * dl, (i + 1) * dl)] + conv(i, d_in)
                + [(dt0 + i * hl, dt0 + (i + 1) * hl)])

    def take(name, dim, wants):
        return SH.take_ranges(p[name], dim, wants, mesh, axes)
    return ({"in_proj": take("in_proj", 1, proj),
             "conv_w": take("conv_w", 1, conv),
             "conv_b": take("conv_b", 0, conv),
             **{k: take(k, 0, block(hl)) for k in ("A_log", "D", "dt_bias")},
             "norm": take("norm", 0, block(dl)),
             "out_proj": take("out_proj", 0, block(dl))}, (mesh, axes))


def _split_proj(p: Tree, x: torch.Tensor, N: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(z, the conv input [x, B, C], dt): the reference's five-way split,
    with x, B and C kept as the one column slice of the projection that
    the reference concatenates back for the convolution (of the rank's
    heads, with ``p`` from :func:`_local`)."""
    d_in = p["norm"].shape[0]
    with annotate_span(SSM_PROJ):
        zxbcdt = x @ p["in_proj"].to(x.dtype)
    return (zxbcdt[..., :d_in], zxbcdt[..., d_in:2 * d_in + 2 * N],
            zxbcdt[..., 2 * d_in + 2 * N:])


def _gated_out(p: Tree, y: torch.Tensor, xh: torch.Tensor, z: torch.Tensor,
               cfg: ModelConfig, split: Split, fused: bool = False
               ) -> torch.Tensor:
    """Skip term, gated RMS norm and the output projection; y, xh
    (..., H, P), z (..., d_in), of the rank's heads under ``split``.
    ``fused``: the norm through the ``gated_rms_norm`` kernel (whole
    channels only: module docstring)."""
    if fused:
        y = gated_rms_norm(y, xh, z, p["D"], p["norm"], cfg.norm_eps)
    else:
        y = gated_rms_norm_plain(y, xh, z, p["D"], p["norm"], cfg.norm_eps,
                                 split)
    with annotate_span(SSM_PROJ):
        y = y @ p["out_proj"].to(y.dtype)
    return SH.reduce_from(y, *split)


def _ssd_chunked(xdt: torch.Tensor, Bc: torch.Tensor, Cc: torch.Tensor,
                 dA: torch.Tensor, Q: int) -> torch.Tensor:
    """The reference's XLA form of the SSD scan in chunks of Q (S % Q ==
    0): float32 decays and states, the intra-chunk term cast to xdt's
    dtype before its product with xdt (as the reference does). The upper
    triangle of the decay is masked before the exponential rather than
    after it: the same values, and no inf (exp of a positive log-decay)
    whose gradient would be NaN."""
    B, S, H, P = xdt.shape
    N = Bc.shape[-1]
    nc = S // Q
    f32 = torch.float32
    xdt_c = xdt.reshape(B, nc, Q, H, P)
    Bc_c = Bc.reshape(B, nc, Q, N).to(f32)
    Cc_c = Cc.reshape(B, nc, Q, N).to(f32)
    cum = torch.cumsum(dA.reshape(B, nc, Q, H), dim=2)              # (B,nc,Q,H)

    # intra-chunk: att[b,c,i,j,h] = (C_i . B_j) exp(cum_i - cum_j), j<=i
    logdec = cum[:, :, :, None, :] - cum[:, :, None, :, :]          # (B,nc,Q,Q,H)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xdt.device))
    dec = torch.exp(logdec.masked_fill(~tri[:, :, None], float("-inf")))
    cb = torch.einsum("bcin,bcjn->bcij", Cc_c, Bc_c)
    att = cb[..., None] * dec
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", att.to(xdt.dtype), xdt_c)

    # chunk states: S_c = sum_j exp(cum_last - cum_j) B_j (x) xdt_j
    last = cum[:, :, -1:, :]                                        # (B,nc,1,H)
    sdec = torch.exp(last - cum)                                    # (B,nc,Q,H)
    states = torch.einsum("bcjn,bcjh,bcjhp->bchnp", Bc_c, sdec,
                          xdt_c.to(f32))

    # inter-chunk recurrence: the state *before* each chunk
    chunk_decay = torch.exp(last[:, :, 0, :])                       # (B,nc,H)
    s = torch.zeros((B, H, N, P), dtype=f32, device=xdt.device)
    prev = []
    for c in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                          # (B,nc,H,N,P)

    y_inter = torch.einsum("bcin,bcih,bchnp->bcihp", Cc_c, torch.exp(cum),
                           prev_states).to(xdt.dtype)
    return (y_intra + y_inter).reshape(B, S, H, P)


def apply_mamba2(p: Tree, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence SSD. x: (B, S, d_model) -> (B, S, d_model), on the
    rank's heads under tensor parallelism (module docstring). The whole
    runs in the span ``ssm.mixer``, the scan in ``ssm.scan`` and the two
    projections' matmuls in ``ssm.proj``."""
    with annotate_span(SSM_MIXER):
        p, split = _local(p, cfg)
        x = SH.copy_to(x, *split)
        B, S, _ = x.shape
        d_in, H = p["norm"].shape[0], p["A_log"].shape[0]
        P, N = cfg.ssm_head_dim, cfg.ssm_state

        if cfg.ssm_impl not in ("cuda", "torch"):
            raise ValueError(f"unknown ssm_impl {cfg.ssm_impl!r}")
        fused = cfg.ssm_impl == "cuda"

        z, xbc, dt = _split_proj(p, x, N)
        conv = conv_silu_dt if fused else conv_silu_dt_plain
        conv_out, dA, xdt = conv(xbc, p["conv_w"], p["conv_b"], dt,
                                 p["dt_bias"], p["A_log"], P)
        xin, Bc, Cc = conv_out.split([d_in, N, N], dim=-1)   # column views
        xh = xin.unflatten(-1, (H, P))

        with annotate_span(SSM_SCAN):
            if fused:
                y = ssd_scan(xdt, Bc, Cc, dA)
            else:
                Q = min(cfg.ssm_chunk, S)
                if S % Q != 0:
                    Q = S
                y = _ssd_chunked(xdt, Bc, Cc, dA, Q)
        return _gated_out(p, y, xh, z, cfg, split, fused and not split[1])


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_mamba2_cache(cfg: ModelConfig, batch: int, dtype, device,
                      split: int = 1) -> Tree:
    """The decode cache of one layer; ``split`` > 1: a rank's block when
    the heads split over that many ranks (its heads' ``state``, its conv
    channels [x, B, C])."""
    d_in, H, P, N = _dims(cfg)
    return {
        "state": torch.zeros((batch, H // split, N, P), dtype=torch.float32,
                             device=device),
        "conv": torch.zeros((batch, CONV_W - 1, d_in // split + 2 * N),
                            dtype=dtype, device=device),
    }


def decode_mamba2(p: Tree, x: torch.Tensor, cache: Tree, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, Tree]:
    """x: (B, 1, d_model); O(1) state update. Returns (out, new cache);
    the given cache is not modified. On the rank's heads and cache block
    under tensor parallelism."""
    p, split = _local(p, cfg)
    x = SH.copy_to(x, *split)
    B = x.shape[0]
    d_in, H = p["norm"].shape[0], p["A_log"].shape[0]
    P, N = cfg.ssm_head_dim, cfg.ssm_state
    f32 = torch.float32

    z, xbc, dt = _split_proj(p, x, N)
    cur = xbc[:, 0]                                                 # (B,conv_dim)
    w = p["conv_w"].to(cur.dtype)
    hist = cache["conv"]
    conv = sum(w[i] * hist[:, i] for i in range(CONV_W - 1)) + w[-1] * cur
    conv = F.silu(conv + p["conv_b"].to(cur.dtype))
    xin, Bc, Cc = conv.split([d_in, N, N], dim=-1)

    xh = xin.reshape(B, H, P)
    dt = F.softplus(dt[:, 0].to(f32) + p["dt_bias"].to(f32))        # (B,H)
    a = -torch.exp(p["A_log"].to(f32))
    dA = torch.exp(dt * a)                                          # (B,H)
    state = cache["state"] * dA[:, :, None, None] + torch.einsum(
        "bn,bh,bhp->bhnp", Bc.to(f32), dt, xh.to(f32))
    y = torch.einsum("bn,bhnp->bhp", Cc.to(f32), state).to(xh.dtype)
    out = _gated_out(p, y[:, None], xh[:, None], z, cfg, split)
    new_cache = {
        "state": state,
        "conv": torch.cat([hist[:, 1:], cur[:, None]], dim=1),
    }
    return out, new_cache

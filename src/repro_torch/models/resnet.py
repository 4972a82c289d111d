"""ResNet-(6n+2) for CIFAR (counterpart of ``repro.models.resnet``): the
paper's experimental model (Table II).

ResNet-32 = n=5: stem conv + 3 stages of n basic blocks at widths 16/32/64,
stride-2 downsample entering stages 2 and 3, global average pool, FC head;
GroupNorm(8) in place of BatchNorm, as in the reference.

The parameter tree has the reference's layout and paths (``stem``,
``stem_gn``, ``stages/<stage>/<block>/conv1``, ``fc_w``, ``fc_b``;
``stages`` is a list of lists), but conv weights are stored as PyTorch
takes them, OIHW, where the reference keeps HWIO (``bridge.py`` transposes
them). Images arrive NHWC, as the reference's batches are; the stem
permutes them once to NCHW.

Padding follows XLA's ``"SAME"`` rule, which pads (0, 1) for a 3x3 conv
at stride 2 on an even map, where ``Conv2d(padding=1)`` would pad (1, 1)
and compute another function.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L

Tree = Dict[str, Any]
STAGE_WIDTHS = (16, 32, 64)
GN_GROUPS = 8


def _conv_param(gen, k: int, cin: int, cout: int, *, dtype, device,
                scale: Optional[float] = None) -> torch.Tensor:
    """An OIHW conv weight drawn like the reference's HWIO one: He init
    by default; the 1x1 projection passes ``scale=1.0``, which is what the
    reference's fan-in rule gives a (1, 1, cin, cout) leaf."""
    if scale is None:
        scale = (2.0 / (k * k * cin)) ** 0.5
    w = L.param(gen, (k, k, cin, cout), dtype=dtype, device=device,
                scale=scale)
    return w.permute(3, 2, 0, 1).contiguous()


def _gn_params(c: int, device) -> Dict[str, torch.Tensor]:
    return {"gamma": torch.ones((c,), dtype=torch.float32, device=device),
            "beta": torch.zeros((c,), dtype=torch.float32, device=device)}


def init_params(cfg: ModelConfig, generator, device,
                dtype: Optional[torch.dtype] = None) -> Tree:
    """Seeded parameters on ``device`` (``None`` generator on ``meta``).
    Conv and FC weights in ``dtype`` (default ``cfg.dtype``), the
    GroupNorm scales and shifts in float32, as the reference reads them."""
    dt = dtype if dtype is not None else L.torch_dtype(cfg.dtype)
    kw = dict(dtype=dt, device=device)
    n = cfg.resnet_n
    p: Tree = {
        "stem": _conv_param(generator, 3, 3, STAGE_WIDTHS[0], **kw),
        "stem_gn": _gn_params(STAGE_WIDTHS[0], device),
        "stages": [],
    }
    prev = STAGE_WIDTHS[0]
    for width in STAGE_WIDTHS:
        stage = []
        for b in range(n):
            cin = prev if b == 0 else width
            blk = {
                "conv1": _conv_param(generator, 3, cin, width, **kw),
                "gn1": _gn_params(width, device),
                "conv2": _conv_param(generator, 3, width, width, **kw),
                "gn2": _gn_params(width, device),
            }
            if cin != width:
                blk["proj"] = _conv_param(generator, 1, cin, width,
                                          scale=1.0, **kw)
            stage.append(blk)
        p["stages"].append(stage)
        prev = width
    p["fc_w"] = L.param(generator, (STAGE_WIDTHS[-1], cfg.num_classes), **kw)
    p["fc_b"] = torch.zeros((cfg.num_classes,), dtype=dt, device=device)
    return p


def group_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               groups: int = GN_GROUPS, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm of an NCHW map in float32 with the population variance;
    channel c falls in group c // (C // g), as in the reference's
    reshape."""
    C = x.shape[1]
    g = min(groups, C)
    while C % g:
        g -= 1
    out = F.group_norm(x.float(), g, gamma.float(), beta.float(), eps)
    return out.to(x.dtype)


def _same_pad(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's "SAME" padding (low, high) of one spatial axis."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1
           ) -> torch.Tensor:
    """NCHW x, OIHW w, XLA "SAME" padding."""
    k = w.shape[-1]
    ph = _same_pad(x.shape[2], k, stride)
    pw = _same_pad(x.shape[3], k, stride)
    w = w.to(x.dtype)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w, stride=stride, padding=(ph[0], pw[0]))
    return F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w, stride=stride)


def forward(params: Tree, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """images (B, H, W, 3) -> (logits (B, num_classes), aux = 0).
    ``remat`` is accepted and unused, as in the reference."""
    x = batch["images"].to(L.torch_dtype(cfg.dtype)).permute(0, 3, 1, 2)
    x = conv2d(x, params["stem"])
    x = F.relu(group_norm(x, params["stem_gn"]["gamma"],
                          params["stem_gn"]["beta"]))
    for si, stage in enumerate(params["stages"]):
        for bi, blk in enumerate(stage):
            stride = 2 if (si > 0 and bi == 0) else 1
            h = conv2d(x, blk["conv1"], stride)
            h = F.relu(group_norm(h, blk["gn1"]["gamma"], blk["gn1"]["beta"]))
            h = conv2d(h, blk["conv2"])
            h = group_norm(h, blk["gn2"]["gamma"], blk["gn2"]["beta"])
            sc = x
            if "proj" in blk:
                sc = conv2d(x, blk["proj"], stride)
            elif stride != 1:
                # the reference's identity 1x1 conv at this stride
                sc = x[:, :, ::stride, ::stride]
            x = F.relu(h + sc)
    x = x.mean(dim=(2, 3))
    logits = x @ params["fc_w"].to(x.dtype) + params["fc_b"].to(x.dtype)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


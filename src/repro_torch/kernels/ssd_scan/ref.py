"""Plain PyTorch version of the SSD scan: the CUDA kernel's oracle and its
CPU path (counterpart of ``repro.kernels.ssd_scan.ref``, taking the
model's layout)."""
from __future__ import annotations

import torch


def ssd_scan_plain(xdt: torch.Tensor, Bc: torch.Tensor, Cc: torch.Tensor,
                   dA: torch.Tensor) -> torch.Tensor:
    """xdt (B, S, H, P); Bc/Cc (B, S, N); dA (B, S, H) -> y (B, S, H, P).

    The defining per-token recurrence, from a zero float32 state per head:
    ``state_t = exp(dA_t) state_{t-1} + B_t (x) xdt_t`` and
    ``y_t = C_t . state_t``. Output in xdt's dtype."""
    Bsz, S, H, P = xdt.shape
    N = Bc.shape[-1]
    x32, b32, c32 = xdt.float(), Bc.float(), Cc.float()
    decay = torch.exp(dA.float())                            # (B, S, H)
    state = torch.zeros((Bsz, H, N, P), dtype=torch.float32,
                        device=xdt.device)
    ys = []
    for t in range(S):
        state = state * decay[:, t, :, None, None] + \
            b32[:, t, None, :, None] * x32[:, t, :, None, :]
        ys.append(torch.einsum("bn,bhnp->bhp", c32[:, t], state))
    return torch.stack(ys, dim=1).to(xdt.dtype)

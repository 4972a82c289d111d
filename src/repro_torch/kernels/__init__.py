"""Hand-written Hopper kernels, each beside its plain PyTorch version.

All four of the reference's Pallas kernels are ported, as CUDA C++:
``decode_attention``, ``flash_attention``, ``ssd_scan`` and ``rwkv6``.
``mamba_glue`` replaces no Pallas kernel: its two kernels fuse the
Mamba-2 mixer's elementwise glue around the SSD scan (the causal conv
with SiLU, dt and xdt; the skip-gated RMS norm), which the reference
leaves to XLA; ``ssm_impl="cuda"`` runs them beside ``ssd_scan``.
None has a backward (the reference's have none either): each wrapper
refuses inputs that autograd would need a gradient through.
"""
import torch


def refuse_grad(kernel: str, impl_field: str, *tensors: torch.Tensor) -> None:
    """Raise if autograd would need a gradient through ``kernel``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel} has no backward: its inputs require a gradient. The "
            f"reference's Pallas kernel has no gradient either; "
            f"differentiate through {impl_field}='torch', or call under "
            f"torch.no_grad()")

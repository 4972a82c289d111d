"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Ported: ``decode_attention`` and ``flash_attention`` (CUDA C++). Still to
port, see ROADMAP.md Queue 2: ``ssd_scan``, ``rwkv6``.
"""

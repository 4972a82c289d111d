"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Ported: ``decode_attention`` (CUDA C++). Still to port, see ROADMAP.md
Queue 2: ``flash_attention``, ``ssd_scan``, ``rwkv6``.
"""

"""The architectures the port runs (one module per arch).

Importing this package registers every config with ``repro_torch.config``.
Module names are sanitized arch ids, as in ``repro.configs``.
"""
from repro_torch.configs import (  # noqa: F401
    arctic_480b,
    gemma3_27b,
    granite_20b,
    moonshot_v1_16b_a3b,
    qwen2_5_14b,
    qwen2_vl_7b,
    resnet32_cifar10,
    rwkv6_7b,
    seamless_m4t_large_v2,
    starcoder2_3b,
    zamba2_1p2b,
)

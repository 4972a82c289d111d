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
    resnet32_cifar10,
    rwkv6_7b,
    starcoder2_3b,
    zamba2_1p2b,
)

from repro_torch.kernels.rwkv6.kernel import rwkv6_scan  # noqa: F401
from repro_torch.kernels.rwkv6.ref import rwkv6_plain  # noqa: F401

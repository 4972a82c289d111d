from repro_torch.kernels.decode_attention.kernel import decode_attention  # noqa: F401
from repro_torch.kernels.decode_attention.ops import decode_attend  # noqa: F401
from repro_torch.kernels.decode_attention.ref import decode_attention_plain  # noqa: F401

from repro_torch.kernels.mamba_glue.kernel import (  # noqa: F401
    conv_silu_dt, gated_rms_norm)
from repro_torch.kernels.mamba_glue.ref import (  # noqa: F401
    conv_silu_dt_plain, gated_rms_norm_plain)

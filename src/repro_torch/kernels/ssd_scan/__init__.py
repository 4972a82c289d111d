from repro_torch.kernels.ssd_scan.kernel import ssd_scan  # noqa: F401
from repro_torch.kernels.ssd_scan.ref import ssd_scan_plain  # noqa: F401

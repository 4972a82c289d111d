from repro_torch.optim.optimizers import (Optimizer, adamw,  # noqa: F401
                                          clip_by_global_norm, global_norm,
                                          make_optimizer, sgd_momentum)
from repro_torch.optim.schedules import (adaptive_lr_scale,  # noqa: F401
                                         make_schedule)
from repro_torch.optim.compression import (CompressionState,  # noqa: F401
                                           ternary_compress,
                                           ternary_decompress,
                                           topk_compress, topk_decompress)

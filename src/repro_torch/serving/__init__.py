from repro_torch.serving.engine import (Request, RequestTiming,  # noqa: F401
                                        ServeEngine, with_impls)
from repro_torch.serving.queue import FIFOQueue, SLOQueue  # noqa: F401

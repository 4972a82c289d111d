from repro_torch.serving.engine import (Request, RequestTiming,  # noqa: F401
                                        ServeEngine, with_impls)
from repro_torch.serving.paging import (CachePack,  # noqa: F401
                                        PageAllocator, pages_needed)
from repro_torch.serving.queue import FIFOQueue, SLOQueue  # noqa: F401
from repro_torch.serving.cluster import ServeCluster  # noqa: F401
from repro_torch.serving.autoscale import (ReplicaAutoscaler,  # noqa: F401
                                           ServeLoad)

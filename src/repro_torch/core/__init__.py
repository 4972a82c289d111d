"""The paper's contribution, the transient-aware training runtime
(counterpart of ``repro.core``), as far as it is ported.

Modules
-------
transient   lifetime distributions + server state (Fig 3, §II-B)
pricing     Table II price book, per-second billing
cluster     sparse mapping: slots / active set / shard ownership (§III-F)
checkpoint  master-less replicated checkpointing + fast save (C2)
elastic     masked + hetero elastic execution, adaptive LR (C5/C6)

Not ported yet (ROADMAP.md Queue 1): ``staleness`` (item 2c, with the
gym's execute path) and the planning layer — ``cost``, ``scheduler``,
``simulator``, ``mc``, ``policy`` (item 2a).
"""
from repro_torch.core.cluster import SlotState, SparseCluster  # noqa: F401
from repro_torch.core.checkpoint import CheckpointManager  # noqa: F401
from repro_torch.core.elastic import (ElasticRuntime,  # noqa: F401
                                      RevocationEvent,
                                      make_hetero_train_step,
                                      make_masked_train_step, slot_batch)

"""The paper's contribution, the transient-aware training runtime
(counterpart of ``repro.core``), as far as it is ported.

Modules
-------
transient   lifetime distributions + server state (Fig 3, §II-B)
pricing     Table II price book, per-second billing
cluster     sparse mapping: slots / active set / shard ownership (§III-F)
checkpoint  master-less replicated checkpointing + fast save (C2)
elastic     masked + hetero elastic execution, adaptive LR (C5/C6)
staleness   AsyncPSSimulator: exact async-PS semantics in torch (C4)
simulator   event-driven Monte-Carlo of full training runs (Tables I-V)
mc          batched (vectorized trial-axis) Monte-Carlo engine
policy      online transient-aware provisioning policies + trace-replay
            evaluator (static / greedy / lookahead-MC / oracle)

Not ported yet (ROADMAP.md Queue 1 item 2a): ``scheduler`` (the
heterogeneous shard map and the MC provisioning optimizer) and ``cost``
(the analytic cost model and budget planner).
"""
from repro_torch.core.cluster import SlotState, SparseCluster  # noqa: F401
from repro_torch.core.checkpoint import CheckpointManager  # noqa: F401
from repro_torch.core.elastic import (ElasticRuntime,  # noqa: F401
                                      RevocationEvent,
                                      make_hetero_train_step,
                                      make_masked_train_step, slot_batch)
from repro_torch.core.staleness import (AsyncPSSimulator,  # noqa: F401
                                        AsyncWorker)
from repro_torch.core.simulator import (ClusterSpec, WorkerSpec,  # noqa: F401
                                        simulate_many, simulate_run)
from repro_torch.core.mc import MCBatch, simulate_batch  # noqa: F401
from repro_torch.core.policy import (GreedyCheapest,  # noqa: F401
                                     LookaheadMC, OraclePolicy,
                                     PolicyDecision, StaticPolicy,
                                     evaluate_policy)

"""Trace-driven elastic-training gym — the sim-to-training bridge
(counterpart of ``repro.gym``).

The batched Monte-Carlo/trace/policy layer *predicts* time, cost, and
progress (``core/mc.py``, ``core/policy.py``), while the elastic runtime
*trains* real torch models under membership churn (``core/elastic.py``,
``core/staleness.py``). This package closes the loop: ``TransientGym``
replays one ``Trace`` through a wall-clock fleet model with a live
``core/policy.py`` policy in the loop, converts the realized membership
timeline into warn/revoke/join events for the masked elastic runtime and
the async-PS simulator, and emits a ledger in the same ``Summary`` schema
as the engine — so ``gym/validate.py`` can pin simulator predictions
against actually-trained runs.
"""
from repro_torch.gym.gym import (EpochRecord, GymLedger,  # noqa: F401
                                 SlotEvent, TrainingSchedule, TransientGym,
                                 execute_async_ps, execute_masked,
                                 summarize_ledgers, training_schedule)
from repro_torch.gym.validate import (DiffReport, TOLERANCE,  # noqa: F401
                                      accuracy_intensity_sweep,
                                      check_monotone, differential_validate,
                                      intensity_sweep_traces)

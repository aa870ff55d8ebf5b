"""``repro_torch.resilience`` — typed errors, fault injection, recovery.

The part of :mod:`repro.resilience` that the in-memory trainer and the
serving path need: the error taxonomy (the server fails futures with
``QueueFullError``, ``DeadlineExceededError`` and ``DispatcherCrashError``;
the trainer raises ``NumericalDivergenceError`` and
``TrainingInterrupted``), the fault schedule the chaos tests inject
through, the :class:`RecoveryPolicy` that arms the trainer's divergence
sentinels, the preemption-safe :class:`GracefulShutdown` and the
process-wide counters (``metrics``).  Retrying and faulty data sources
belong to the out-of-core path and are not ported yet (ROADMAP Queue 1
item 5).
"""
from repro_torch.resilience import metrics
from repro_torch.resilience.errors import (ChunkTimeoutError,
                                           DeadlineExceededError,
                                           DeviceOOMError,
                                           DispatcherCrashError,
                                           NumericalDivergenceError,
                                           Preemption, QueueFullError,
                                           ResilienceError,
                                           ShardCorruptionError,
                                           TrainingInterrupted,
                                           TransientIOError, is_oom,
                                           is_transient)
from repro_torch.resilience.faults import Fault, FaultInjector, FaultSchedule
from repro_torch.resilience.recovery import RecoveryPolicy, classify
from repro_torch.resilience.shutdown import GracefulShutdown

__all__ = [
    "ResilienceError", "TransientIOError", "ChunkTimeoutError", "Preemption",
    "ShardCorruptionError", "DeviceOOMError", "NumericalDivergenceError",
    "TrainingInterrupted", "QueueFullError", "DeadlineExceededError",
    "DispatcherCrashError", "is_oom", "is_transient",
    "Fault", "FaultSchedule", "FaultInjector",
    "RecoveryPolicy", "classify", "GracefulShutdown", "metrics",
]

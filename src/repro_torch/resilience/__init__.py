"""``repro_torch.resilience`` — typed errors, fault injection, recovery.

The counterpart of :mod:`repro.resilience`: the error taxonomy (the server
fails futures with ``QueueFullError``, ``DeadlineExceededError`` and
``DispatcherCrashError``; the trainers raise ``NumericalDivergenceError``
and ``TrainingInterrupted``), the seeded fault schedule and the faulty
data source the chaos tests inject through, the self-healing
:class:`RetryingSource`, the :class:`RecoveryPolicy` that drives the
trainers' divergence sentinels, round replay and OOM degradation, the
preemption-safe :class:`GracefulShutdown` and the process-wide counters
(``metrics``).
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
from repro_torch.resilience.faults import (Fault, FaultInjector,
                                           FaultSchedule, FaultySource,
                                           corrupt_file, seeded_schedule)
from repro_torch.resilience.recovery import RecoveryPolicy, classify
from repro_torch.resilience.retry import RetryingSource, RetryPolicy
from repro_torch.resilience.shutdown import GracefulShutdown

__all__ = [
    "ResilienceError", "TransientIOError", "ChunkTimeoutError", "Preemption",
    "ShardCorruptionError", "DeviceOOMError", "NumericalDivergenceError",
    "TrainingInterrupted", "QueueFullError", "DeadlineExceededError",
    "DispatcherCrashError", "is_oom", "is_transient",
    "Fault", "FaultSchedule", "FaultInjector", "FaultySource",
    "seeded_schedule", "corrupt_file",
    "RecoveryPolicy", "classify",
    "RetryPolicy", "RetryingSource",
    "GracefulShutdown", "metrics",
]

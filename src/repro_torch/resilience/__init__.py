"""``repro_torch.resilience`` — typed errors and seeded fault injection.

The part of :mod:`repro.resilience` that the serving path needs: the
error taxonomy (the server fails futures with ``QueueFullError``,
``DeadlineExceededError`` and ``DispatcherCrashError``) and the fault
schedule its chaos tests inject through.  Retrying sources, recovery
policies and graceful shutdown are not ported yet (ROADMAP Queue 1 item
6).
"""
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

__all__ = [
    "ResilienceError", "TransientIOError", "ChunkTimeoutError", "Preemption",
    "ShardCorruptionError", "DeviceOOMError", "NumericalDivergenceError",
    "TrainingInterrupted", "QueueFullError", "DeadlineExceededError",
    "DispatcherCrashError", "is_oom", "is_transient",
    "Fault", "FaultSchedule", "FaultInjector",
]

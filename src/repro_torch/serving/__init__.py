"""``repro_torch.serving`` — the serving daemon over the port's engine.

The counterpart of :mod:`repro.serving` (re-exported through
``repro_torch.api``):

  * :class:`Server` — a worker thread draining a deadline-aware request
    queue; ragged ``submit()`` calls coalesce into power-of-two-bucketed
    flushes, each one CUDA-graph replay on the card, and scatter back
    through :class:`Request` futures.
  * :class:`ModelRegistry` — N named ensembles resident at once, each with
    its own graph cache; ``publish`` hot-swaps a version with no capture
    when the shape buckets match.
  * :func:`warmup_buckets` — the reachable flush-bucket set.
  * :class:`ServerHealth` — ``Server.health()``'s liveness/readiness
    snapshot; typed overload and crash failures are the exception types of
    :mod:`repro_torch.resilience`.
"""
from repro_torch.resilience.errors import (DeadlineExceededError,  # noqa: F401
                                           DispatcherCrashError,
                                           QueueFullError)
from repro_torch.serving.metrics import (ModelMetrics, ServerHealth,
                                         format_stats_line)
from repro_torch.serving.registry import ModelRegistry
from repro_torch.serving.server import Request, Server, warmup_buckets

__all__ = ["Server", "ModelRegistry", "Request", "ModelMetrics",
           "ServerHealth", "warmup_buckets", "format_stats_line",
           "QueueFullError", "DeadlineExceededError",
           "DispatcherCrashError"]

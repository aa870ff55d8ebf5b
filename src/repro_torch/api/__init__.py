"""``repro_torch.api`` — the estimator facade over the port.

  * :class:`ExecutionPlan` — where every GBDT step runs (the CUDA kernels
    or their plain versions); :func:`resolve_device` — the device an entry
    point runs on (CUDA unless the caller names another).
  * :class:`BoosterRegressor` / :class:`BoosterClassifier` — raw
    NaN-carrying matrices in, predictions out.
  * :func:`save` / :func:`load` (+ ``save_checkpoint`` /
    ``load_checkpoint``) — the ``repro-gbdt-bundle`` format that
    :mod:`repro.api` writes and reads too.
  * :class:`GBDTPipeline` — binner + model through the serving engine;
    :class:`Server` / :class:`ModelRegistry` — the deadline-batching
    server over it.
  * :class:`RecoveryPolicy` / :class:`GracefulShutdown` — the divergence
    sentinels, a streamed fit's replay and OOM degradation, and the
    preemption-safe exit that ``fit`` takes as ``recovery=`` and
    ``shutdown=``; :class:`RetryingSource` / :class:`RetryPolicy` — a
    data source that retries transient read failures.
  * :class:`DataSource`, :class:`ArraySource`, :class:`NpzShardSource`,
    :class:`SyntheticSource`, :func:`write_npz_shards` — the chunked
    sources that ``fit(data=...)`` streams.

Only :mod:`repro_torch.api.plan` is imported eagerly: the kernels depend on
it, so the modules that depend on the kernels load lazily, which keeps the
import graph acyclic.
"""
from repro_torch.api.plan import ExecutionPlan, resolve_device, resolve_plan

_LAZY = {
    "BoosterRegressor": ("repro_torch.api.estimator", "BoosterRegressor"),
    "BoosterClassifier": ("repro_torch.api.estimator", "BoosterClassifier"),
    "NotFittedError": ("repro_torch.api.estimator", "NotFittedError"),
    "save": ("repro_torch.api.serialize", "save"),
    "load": ("repro_torch.api.serialize", "load"),
    "save_checkpoint": ("repro_torch.api.serialize", "save_checkpoint"),
    "load_checkpoint": ("repro_torch.api.serialize", "load_checkpoint"),
    "pack": ("repro_torch.api.serialize", "pack"),
    "unpack": ("repro_torch.api.serialize", "unpack"),
    "GBDTPipeline": ("repro_torch.core.inference", "GBDTPipeline"),
    "make_tabular": ("repro_torch.data.synthetic", "make_tabular"),
    "paper_dataset": ("repro_torch.data.synthetic", "paper_dataset"),
    "DataSource": ("repro_torch.data.pipeline", "DataSource"),
    "ArraySource": ("repro_torch.data.pipeline", "ArraySource"),
    "NpzShardSource": ("repro_torch.data.pipeline", "NpzShardSource"),
    "SyntheticSource": ("repro_torch.data.synthetic", "SyntheticSource"),
    "write_npz_shards": ("repro_torch.data.pipeline", "write_npz_shards"),
    "Server": ("repro_torch.serving", "Server"),
    "ModelRegistry": ("repro_torch.serving", "ModelRegistry"),
    "Request": ("repro_torch.serving", "Request"),
    "warmup_buckets": ("repro_torch.serving", "warmup_buckets"),
    "ServerHealth": ("repro_torch.serving", "ServerHealth"),
    "FaultSchedule": ("repro_torch.resilience", "FaultSchedule"),
    "RecoveryPolicy": ("repro_torch.resilience", "RecoveryPolicy"),
    "RetryPolicy": ("repro_torch.resilience", "RetryPolicy"),
    "RetryingSource": ("repro_torch.resilience", "RetryingSource"),
    "GracefulShutdown": ("repro_torch.resilience", "GracefulShutdown"),
    "TrainingInterrupted": ("repro_torch.resilience", "TrainingInterrupted"),
    "NumericalDivergenceError": ("repro_torch.resilience",
                                 "NumericalDivergenceError"),
    "QueueFullError": ("repro_torch.resilience", "QueueFullError"),
    "DeadlineExceededError": ("repro_torch.resilience",
                              "DeadlineExceededError"),
    "DispatcherCrashError": ("repro_torch.resilience",
                             "DispatcherCrashError"),
    "ShardCorruptionError": ("repro_torch.resilience",
                             "ShardCorruptionError"),
}

__all__ = ["ExecutionPlan", "resolve_device", "resolve_plan"] + sorted(_LAZY)


def __getattr__(name):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    value = getattr(importlib.import_module(mod_name), attr)
    globals()[name] = value  # cache for subsequent lookups
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))

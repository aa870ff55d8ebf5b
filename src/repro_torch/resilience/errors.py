"""Typed error taxonomy for the resilience layer.

The counterpart of :mod:`repro.resilience.errors`.  Every failure the
training and serving stack can recover from (or must fail loudly on) has a
type of its own, so policy is written against types, with one exception:
:func:`is_oom` also classifies by message, for backends that report a
memory exhaustion only in their error text.

  * **transient** (:func:`is_transient`): worth retrying (flaky reads,
    chunk timeouts, preemptions).
  * **corruption**: :class:`ShardCorruptionError` is not transient; a
    checksum mismatch reproduces on every read.
  * **overload**: :class:`QueueFullError`, :class:`DeadlineExceededError`
    and :class:`DispatcherCrashError` fail serving futures with a reason a
    client can act on; the server never drops a request without resolving
    its future.
"""
from __future__ import annotations

import torch


class ResilienceError(Exception):
    """Base of the resilience taxonomy."""


# -- data-path errors --------------------------------------------------------
class TransientIOError(ResilienceError, OSError):
    """A retryable IO failure (flaky read, dropped connection, ...)."""


class ChunkTimeoutError(TransientIOError):
    """A chunk fetch exceeded the per-chunk timeout (transient)."""


class Preemption(TransientIOError):
    """A mid-run preemption.  Transient: training recovers by checkpoint
    restore and deterministic replay."""


class ShardCorruptionError(ResilienceError):
    """A shard's bytes do not match its manifest checksum.  Not
    transient: re-reading corrupt bytes yields corrupt bytes."""


class DeviceOOMError(ResilienceError):
    """Injected stand-in for a device memory exhaustion (real ones surface
    as ``torch.cuda.OutOfMemoryError``; both classify via
    :func:`is_oom`)."""


class NumericalDivergenceError(ResilienceError):
    """A non-finite value entered the training state (loss, margins or a
    histogram).  ``round_index`` is the boosting round whose sentinel
    tripped."""

    def __init__(self, message: str, *, round_index: int = -1,
                 what: str = "loss"):
        super().__init__(message)
        self.round_index = int(round_index)
        self.what = what


class TrainingInterrupted(ResilienceError):
    """A graceful-shutdown signal stopped the fit between rounds; carries
    ``rounds_done``, the ``checkpoint_dir`` holding the resumable state,
    the ``signal_name`` and the partial ``result``."""

    def __init__(self, message: str, *, rounds_done: int = 0,
                 checkpoint_dir=None, signal_name=None, result=None):
        super().__init__(message)
        self.rounds_done = int(rounds_done)
        self.checkpoint_dir = checkpoint_dir
        self.signal_name = signal_name
        self.result = result


# -- serving errors ----------------------------------------------------------
class QueueFullError(ResilienceError):
    """Load shed: the model's bounded queue cannot take this request.
    The request's future fails with this; it was never enqueued."""


class DeadlineExceededError(ResilienceError):
    """The request's hard deadline expired while it sat queued; it is
    failed typed instead of being served late or dropped silently."""


class DispatcherCrashError(ResilienceError):
    """The dispatcher thread died with this request in flight; the
    supervisor failed it cleanly while restarting the dispatcher."""


# -- classification ----------------------------------------------------------
_OOM_MARKERS = ("resource_exhausted", "resource exhausted", "out of memory")


def is_oom(exc: BaseException) -> bool:
    """Does ``exc`` look like a device-memory exhaustion?  Matches the
    typed :class:`DeviceOOMError`, ``torch.cuda.OutOfMemoryError`` and, by
    message, a backend's out-of-memory error."""
    if isinstance(exc, (DeviceOOMError, torch.cuda.OutOfMemoryError)):
        return True
    msg = str(exc).lower()
    return any(m in msg for m in _OOM_MARKERS)


def is_transient(exc: BaseException) -> bool:
    """Is ``exc`` worth retrying?  Corruption, OOM, divergence and a
    graceful interrupt are not."""
    if isinstance(exc, (ShardCorruptionError, DeviceOOMError,
                        NumericalDivergenceError, TrainingInterrupted)):
        return False
    if is_oom(exc):
        return False
    return isinstance(exc, (TransientIOError, OSError, TimeoutError,
                            ConnectionError))

"""The port's own records: process-wide counters and host spans.

**Counters.**  Every resilience event increments a named process-wide
counter, so a caller can tell "slow" from "spent the budget recovering":
take a :func:`snapshot` before a region and read :func:`delta` after it.

  * ``"recoveries"`` — a trainer recovery branch fired (a divergence
    rollback of the fused trainer).
  * ``"tree.splits"``, ``"tree.splits_categorical"``,
    ``"tree.splits_default_left"`` — the splits a fit of
    ``core/gbdt.train`` grew, those on a categorical field, and those
    that send the missing bin left; added once a fit, after its last
    round, from its tree tables (``core/tree.record_splits``).

Counters are cumulative per process.

**Spans.**  ``with obs.span("tree.split.3"): ...`` times a stretch of the
host's work.  Tracing is on while :func:`enable` holds it on, or while a
``torch.profiler`` session records.  Off, :func:`span` returns one shared
object that does nothing: no clock read, no allocation, no string made.
On, a span reads ``perf_counter_ns`` at enter and exit and adds into its
name's row of :func:`spans`: the count, the total and the self time (the
total less the time of the spans opened inside it, on the same thread).
While a profiler records, a span also opens a ``_RecordFunctionFast`` of
its name, which lands in the profiler's host timeline, on the clock of
the device's events, and adds nothing on the device (``record_function``
would add a ``gpu_user_annotation`` range there).  A span decides when it
is opened whether it records; its exit follows that decision, so a
profiler that starts or stops inside a span is harmless.

The spans of the training round (``core/gbdt.train``, ``core/tree``):

  ``gbdt.round``       one round, the draws through the loss read
  ``gbdt.draws``       the round's random stream and draws
  ``gbdt.grad``        the gradient statistics and the round's filters
  ``tree.grow``        the grower, and in it, a level L at a time,
  ``tree.hist.L``      step ①, ``tree.split.L`` step ②,
  ``tree.partition.L`` step ③, then ``tree.leaves``
  ``gbdt.traverse``    step ⑤
  ``gbdt.loss``        the loss, enqueued
  ``host.wait``        the host blocked on the device (a loss read)
  ``gbdt.predict``     ``GBDTModel.predict_margin``
  ``codes.unpack``     ``PackedCodes.unpack``: 4-bit codes expanded to
                       uint8, wherever it happens (none in a round of
                       the card's level-wise grower)

The count of ``host.wait`` spans is the host's syncs; their total is the
time the host waited on the device.  Both registries are thread-safe
(the serving threads may record concurrently).
"""
from __future__ import annotations

import threading
import time
from collections import Counter
from typing import Dict, Tuple

import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast

_lock = threading.Lock()
_counts: Counter = Counter()


def record(kind: str, n: int = 1) -> None:
    """Increment the ``kind`` counter by ``n``."""
    with _lock:
        _counts[kind] += int(n)


def counts() -> Dict[str, int]:
    """A copy of every counter (cumulative since process start/reset)."""
    with _lock:
        return dict(_counts)


def snapshot() -> Dict[str, int]:
    """Alias of :func:`counts` — pair two calls to diff a region."""
    return counts()


def delta(before: Dict[str, int]) -> Dict[str, int]:
    """Counters accumulated since ``before`` (a :func:`snapshot`)."""
    now = counts()
    keys = set(now) | set(before)
    return {k: now.get(k, 0) - before.get(k, 0) for k in keys
            if now.get(k, 0) - before.get(k, 0)}


def reset() -> Dict[str, int]:
    """Zero every counter; returns the pre-reset values."""
    with _lock:
        old = dict(_counts)
        _counts.clear()
        return old


# -- spans -------------------------------------------------------------------
_enabled = False
_rows: Dict[str, list] = {}        # name -> [count, total ns, self ns]
_local = threading.local()         # .stack: this thread's open spans
_clock = time.perf_counter_ns


def enable(on: bool = True) -> bool:
    """Hold tracing on (or let it follow the profiler again); returns the
    previous setting."""
    global _enabled
    old, _enabled = _enabled, bool(on)
    return old


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "stack", "fast", "t0", "inner")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self.fast = _RecordFunctionFast(self.name)
            self.fast.__enter__()
        else:
            self.fast = None
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(self)
        self.stack, self.inner = stack, 0
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        took = _clock() - self.t0
        stack = self.stack
        stack.pop()
        if stack:
            stack[-1].inner += took
        with _lock:
            row = _rows.get(self.name)
            if row is None:
                row = _rows[self.name] = [0, 0, 0]
            row[0] += 1
            row[1] += took
            row[2] += took - self.inner
        if self.fast is not None:
            self.fast.__exit__(*exc)
        return False


def span(name: str):
    """A context manager that times ``name`` while tracing is on (see the
    module's docstring); ``name`` is a fixed string, never formatted on
    the hot path."""
    if _enabled or _autograd_profiler._is_profiler_enabled:
        return _Span(name)
    return _OFF


def _table() -> Dict[str, Dict[str, int]]:
    return {name: {"count": c, "total_ns": t, "self_ns": s}
            for name, (c, t, s) in _rows.items()}


def spans() -> Dict[str, Dict[str, int]]:
    """Every span name recorded since the last :func:`reset_spans`:
    ``{"count", "total_ns", "self_ns"}``."""
    with _lock:
        return _table()


def reset_spans() -> Dict[str, Dict[str, int]]:
    """Clear the span rows; returns them as they were."""
    with _lock:
        old = _table()
        _rows.clear()
        return old


def open_spans() -> Tuple[str, ...]:
    """The names of this thread's open spans, outermost first."""
    return tuple(s.name for s in getattr(_local, "stack", ()))

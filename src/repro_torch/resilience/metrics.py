"""Process-wide resilience counters.

The port's own copy of :mod:`repro.resilience.metrics`.  Every resilience
event increments a named process-wide counter, so a caller can tell "slow"
from "spent the budget recovering": take a :func:`snapshot` before a region
and read :func:`delta` after it.

  * ``"recoveries"`` — a trainer recovery branch fired (a divergence
    rollback of the fused trainer).

Counters are cumulative per process.  Thread-safe (the serving threads may
record concurrently).
"""
from __future__ import annotations

import threading
from collections import Counter
from typing import Dict

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

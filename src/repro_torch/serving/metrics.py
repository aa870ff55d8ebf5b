"""Serving observability — per-model counters behind ``Server.stats()``.

The counterpart of :mod:`repro.serving.metrics`.

One :class:`ModelMetrics` per published model name tracks request
latency percentiles (over a sliding window of completed requests),
rolling QPS (completions inside the last ``qps_window_s`` seconds),
batch-fill ratio (real rows flushed / power-of-two bucket rows they
padded to — how much of each captured graph's capacity the
coalescer actually used), flush and drop counts.  All methods are
thread-safe: the dispatcher thread records while callers snapshot.

Failure accounting is EXPLICIT — zero silent drops by construction:
every request the daemon cannot serve lands in exactly one typed
counter (``shed`` = rejected at admission with
:class:`~repro_torch.resilience.QueueFullError`, ``deadline_failures`` =
expired in queue with :class:`~repro_torch.resilience.DeadlineExceededError`,
``dropped`` = flush/dispatcher failure) AND its future carries the same
typed exception.  :class:`ServerHealth` is the daemon-level
health/readiness snapshot behind ``Server.health()``.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Dict, Optional


class ModelMetrics:
    """Latency/QPS/fill counters for one served model."""

    def __init__(self, window: int = 2048, qps_window_s: float = 10.0):
        self._lock = threading.Lock()
        self._lat = deque(maxlen=window)     # completed-request latencies (s)
        self._done = deque()                 # completion stamps (rolling QPS)
        self._qps_window_s = float(qps_window_s)
        self._requests = 0
        self._rows = 0
        self._flushes = 0
        self._dropped = 0
        self._shed = 0                       # admission-rejected (queue full)
        self._deadline_failures = 0          # expired in queue
        self._fill_rows = 0                  # real rows across flushes
        self._bucket_rows = 0                # bucket capacity they padded to

    def record_flush(self, real_rows: int, bucket_rows: int) -> None:
        with self._lock:
            self._flushes += 1
            self._fill_rows += int(real_rows)
            self._bucket_rows += int(bucket_rows)

    def record_request(self, n_rows: int, latency_s: float,
                       now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._requests += 1
            self._rows += int(n_rows)
            self._lat.append(float(latency_s))
            self._done.append(now)
            cutoff = now - self._qps_window_s
            while self._done and self._done[0] < cutoff:
                self._done.popleft()

    def record_drop(self) -> None:
        with self._lock:
            self._dropped += 1

    def record_shed(self) -> None:
        """A request rejected at admission — the queue bound held."""
        with self._lock:
            self._shed += 1

    def record_deadline(self) -> None:
        """A queued segment that expired before any flush took it."""
        with self._lock:
            self._deadline_failures += 1

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            lat = sorted(self._lat)
            now = time.monotonic()
            cutoff = now - self._qps_window_s
            recent = sum(1 for t in self._done if t >= cutoff)

            def pct(p: float) -> float:
                if not lat:
                    return 0.0
                i = min(len(lat) - 1, int(round(p / 100.0 * (len(lat) - 1))))
                return lat[i] * 1e3

            fill = (self._fill_rows / self._bucket_rows
                    if self._bucket_rows else 0.0)
            return {"requests": self._requests, "rows": self._rows,
                    "flushes": self._flushes, "dropped": self._dropped,
                    "shed": self._shed,
                    "deadline_failures": self._deadline_failures,
                    "p50_ms": pct(50), "p99_ms": pct(99),
                    "batch_fill": fill,
                    "qps": recent / self._qps_window_s}


@dataclasses.dataclass
class ServerHealth:
    """Daemon-level health/readiness — what an orchestrator probes.

    ``alive`` (liveness): the dispatcher thread is running (possibly
    after supervised restarts).  ``ready`` (readiness): alive AND
    accepting submissions (not stopping, restart budget not exhausted).
    ``failed_requests`` totals every typed failure across models —
    dropped + shed + deadline_failures — so ``failed_requests`` +
    completed requests always accounts for every submission.
    """

    alive: bool
    ready: bool
    dispatcher_restarts: int
    queued_rows: int
    models: int
    failed_requests: int

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def format_stats_line(name: str, snap: Dict[str, float]) -> str:
    """The periodic one-line log the daemon emits per model."""
    return (f"[serving] {name}: {snap['requests']} req ({snap['rows']} rows,"
            f" {snap['qps']:.1f} qps) p50 {snap['p50_ms']:.1f} ms"
            f" p99 {snap['p99_ms']:.1f} ms fill {snap['batch_fill']:.2f}"
            f" flushes {snap['flushes']} dropped {snap['dropped']}"
            f" retraces {snap.get('traces', 0)}")

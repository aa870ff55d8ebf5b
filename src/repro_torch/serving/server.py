"""The serving daemon: deadline-aware dynamic batching over shape buckets.

The counterpart of :mod:`repro.serving.server`.

A :class:`Server` owns one dispatcher thread draining per-model request
queues.  ``submit(name, X)`` enqueues and returns a :class:`Request`
future immediately; the dispatcher coalesces queued requests for the same
model into one flush — the largest batch (up to ``max_batch`` rows) that
can be assembled before the OLDEST queued request's deadline slack
expires — runs it through the compile-once predict engine, and scatters
the result rows back per-request.  Because the engine pads each flush to
its power-of-two row bucket, coalescing k small requests into one flush
costs one graph replay instead of k, and padding never
changes results (padded rows are sliced off), so a coalesced batch is
served bit-equal to individual predicts.

Deadline semantics: each request carries ``slack_ms`` — how long it may
sit in the queue waiting for company.  A flush fires as soon as EITHER
the head request's slack expires OR ``max_batch`` rows are queued.
``slack_ms=0`` degenerates to immediate per-request dispatch; larger
slack trades head latency for batch fill.  Requests larger than
``max_batch`` are chopped into segments served across flushes and
reassembled before the future resolves.

Models come from a :class:`~repro_torch.serving.registry.ModelRegistry`; the
plan is threaded once through the registry, hot-swaps are picked up at
the next flush (in-flight work keeps the entry it started with), and
``warmup(name)`` captures EVERY power-of-two row bucket a flush can
produce — the full bucket set up to ``max_batch``, a strict superset of
any reachable flush size, so a no-capture assertion after warmup can
never pass vacuously.

Overload and failure posture: queues are bounded
(``max_queue_rows``) with EXPLICIT load shedding — an admission-rejected
request's future fails with :class:`~repro_torch.resilience.QueueFullError`
and is counted, never silently dropped; queued segments carry an
optional hard deadline (``timeout_ms``) and expire with
:class:`~repro_torch.resilience.DeadlineExceededError`; the dispatcher
thread runs under a supervisor that fails the crashed flush's in-flight
requests with :class:`~repro_torch.resilience.DispatcherCrashError`, restarts
the dispatcher (bounded by ``max_dispatcher_restarts``), and keeps
serving.  ``health()`` reports liveness/readiness.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.inference import ROW_BUCKET_FLOOR, bucket_pow2
from repro_torch.resilience.errors import (DeadlineExceededError,
                                           DispatcherCrashError,
                                           QueueFullError)
from repro_torch.serving.metrics import (ModelMetrics, ServerHealth,
                                         format_stats_line)
from repro_torch.serving.registry import ModelRegistry


def warmup_buckets(max_rows: int,
                   floor: int = ROW_BUCKET_FLOOR) -> List[int]:
    """Every power-of-two row bucket a flush of <= ``max_rows`` rows can
    land in.  This is the warmup set AND the coalescer's reachable-bucket
    set — deriving both from one helper is what makes "zero retraces
    after warmup" a meaningful check."""
    out, b = [], floor
    top = bucket_pow2(max_rows, floor)
    while b <= top:
        out.append(b)
        b *= 2
    return out


class Request:
    """Handle for one ``submit()`` call — a future over the result rows.

    ``result(timeout)`` blocks until every segment of the request has
    been served and returns the (n_rows,) / (n_rows, K) predictions in
    submission row order.
    """

    def __init__(self, name: str, n_rows: int, slack_s: float,
                 timeout_s: Optional[float] = None):
        self.name = name
        self.n_rows = n_rows
        self.submitted_at = time.monotonic()
        self.flush_by = self.submitted_at + slack_s
        # hard queue deadline: past this, un-flushed segments fail with
        # DeadlineExceededError instead of waiting out a storm
        self.deadline = (None if timeout_s is None
                         else self.submitted_at + timeout_s)
        self._future: Future = Future()
        self._parts: Dict[int, np.ndarray] = {}
        self._pending = 0        # segments not yet delivered

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        return self._future.result(timeout)

    def done(self) -> bool:
        return self._future.done()

    @property
    def latency_s(self) -> float:
        """Submission-to-completion wall time (completed requests only)."""
        return self._completed_at - self.submitted_at

    def _deliver(self, index: int, rows: np.ndarray) -> bool:
        """Store one served segment; True when the request completed."""
        self._parts[index] = rows
        self._pending -= 1
        if self._pending:
            return False
        parts = [self._parts[i] for i in sorted(self._parts)]
        self._completed_at = time.monotonic()
        self._future.set_result(
            parts[0] if len(parts) == 1 else np.concatenate(parts))
        return True

    def _fail(self, exc: BaseException) -> None:
        if not self._future.done():
            self._future.set_exception(exc)


class _Segment:
    """A <= max_batch slice of one request — the queue/flush unit."""

    __slots__ = ("request", "index", "X", "rows")

    def __init__(self, request: Request, index: int, X: np.ndarray):
        self.request = request
        self.index = index
        self.X = X
        self.rows = int(X.shape[0])


class Server:
    """Deadline-aware batching daemon over a :class:`ModelRegistry`.

    Parameters
    ----------
    registry:         the model tenancy (its plan is THE predict plan).
    max_batch:        flush capacity in rows; also the request chop size.
    default_slack_ms: queue-wait budget for ``submit()`` calls that don't
                      pass their own ``slack_ms``.
    log_every_s:      emit one stats log line per model at this cadence
                      (None = silent; the ``stats()`` snapshot always works).
    max_queue_rows:   per-model queue bound; a submit that would exceed it
                      is SHED — its future fails with ``QueueFullError``
                      (None = unbounded).
    timeout_ms:       default hard deadline for queued work; segments
                      still queued past it fail with
                      ``DeadlineExceededError`` (None = wait forever).
    max_dispatcher_restarts: supervisor restart budget; the crash that
                      exhausts it fails ALL queued work and marks the
                      server not ready.
    fault_injector:   a :class:`repro_torch.resilience.FaultSchedule`
                      applied at site ``"dispatch"`` once per flush (chaos
                      testing).
    """

    def __init__(self, registry: ModelRegistry, *, max_batch: int = 4096,
                 default_slack_ms: float = 20.0,
                 log_every_s: Optional[float] = None,
                 max_queue_rows: Optional[int] = None,
                 timeout_ms: Optional[float] = None,
                 max_dispatcher_restarts: int = 3,
                 fault_injector=None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if max_queue_rows is not None and max_queue_rows < max_batch:
            raise ValueError("max_queue_rows must be >= max_batch")
        self._registry = registry
        self._max_batch = int(max_batch)
        self._default_slack_s = float(default_slack_ms) / 1e3
        self._default_timeout_s = (None if timeout_ms is None
                                   else float(timeout_ms) / 1e3)
        self._max_queue_rows = (None if max_queue_rows is None
                                else int(max_queue_rows))
        self._max_restarts = int(max_dispatcher_restarts)
        self._faults = fault_injector
        self._log_every_s = log_every_s
        self._last_log = time.monotonic()
        self._cv = threading.Condition()
        self._queues: Dict[str, deque] = {}
        self._queued_rows: Dict[str, int] = {}
        self._metrics: Dict[str, ModelMetrics] = {}
        self._stopping = False
        self._dead = False               # restart budget exhausted
        self._restarts = 0
        self._flush_seq = 0              # fault-injection step counter
        self._inflight: List[_Segment] = []
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="repro-serving-dispatch")
        self._thread.start()

    # -- client surface ------------------------------------------------------
    def submit(self, name: str, X, *,
               slack_ms: Optional[float] = None,
               timeout_ms: Optional[float] = None) -> Request:
        """Enqueue one prediction request; returns immediately.

        The returned future fails typed when the daemon cannot serve it:
        ``QueueFullError`` (shed at admission — the request was never
        queued), ``DeadlineExceededError`` (expired in queue), or
        ``DispatcherCrashError`` (in flight when the dispatcher died).
        """
        self._registry.entry(name)            # fail fast on unknown tenants
        X = np.asarray(X, np.float32)
        if X.ndim != 2 or X.shape[0] < 1:
            raise ValueError(f"expected a (n_rows >= 1, n_fields) batch, "
                             f"got shape {X.shape}")
        slack_s = (self._default_slack_s if slack_ms is None
                   else float(slack_ms) / 1e3)
        timeout_s = (self._default_timeout_s if timeout_ms is None
                     else float(timeout_ms) / 1e3)
        req = Request(name, int(X.shape[0]), slack_s, timeout_s)
        segments = [_Segment(req, i, X[lo:lo + self._max_batch])
                    for i, lo in enumerate(range(0, X.shape[0],
                                                 self._max_batch))]
        req._pending = len(segments)
        with self._cv:
            if self._stopping:
                raise RuntimeError("server is stopped")
            metrics = self._metrics.setdefault(name, ModelMetrics())
            if self._dead:
                metrics.record_shed()
                req._fail(DispatcherCrashError(
                    "dispatcher restart budget exhausted; server is not "
                    "accepting work"))
                return req
            queued = self._queued_rows.get(name, 0)
            if (self._max_queue_rows is not None
                    and queued + req.n_rows > self._max_queue_rows):
                # explicit load shedding: typed failure + counter, and the
                # request never enters the queue
                metrics.record_shed()
                req._fail(QueueFullError(
                    f"queue for {name!r} holds {queued} rows; admitting "
                    f"{req.n_rows} more would exceed the "
                    f"{self._max_queue_rows}-row bound"))
                return req
            q = self._queues.setdefault(name, deque())
            q.extend(segments)
            self._queued_rows[name] = queued + req.n_rows
            self._cv.notify()
        return req

    def warmup(self, name: str, *, max_rows: Optional[int] = None) -> int:
        """Capture every row bucket reachable by a flush (plus the
        model's step); returns the number of captures it cost.  A warm
        server must then serve ANY traffic mix with no capture.
        """
        entry = self._registry.entry(name)
        before = entry.cache.stats()["traces"]
        self._registry.warm(name,
                            warmup_buckets(max_rows or self._max_batch))
        return entry.cache.stats()["traces"] - before

    def stats(self) -> Dict[str, Dict]:
        """Snapshot: per-model latency/QPS/fill/drop counters merged with
        queue depth and the registry's version + capture counters."""
        with self._cv:
            metrics = dict(self._metrics)
            depths = dict(self._queued_rows)
        registry = self._registry.stats()
        out: Dict[str, Dict] = {}
        for name in set(metrics) | set(registry):
            snap = (metrics[name].snapshot() if name in metrics
                    else ModelMetrics().snapshot())
            snap["queue_depth"] = depths.get(name, 0)
            reg = registry.get(name, {})
            snap["version"] = reg.get("version", 0)
            snap["traces"] = reg.get("cache", {}).get("traces", 0)
            out[name] = snap
        return out

    def health(self) -> ServerHealth:
        """Liveness/readiness snapshot (see :class:`ServerHealth`)."""
        with self._cv:
            alive = self._thread.is_alive() and not self._dead
            ready = alive and not self._stopping
            restarts = self._restarts
            queued = sum(self._queued_rows.values())
            metrics = dict(self._metrics)
        failed = 0
        for m in metrics.values():
            snap = m.snapshot()
            failed += (snap["dropped"] + snap["shed"]
                       + snap["deadline_failures"])
        return ServerHealth(alive=alive, ready=ready,
                            dispatcher_restarts=restarts,
                            queued_rows=queued, models=len(metrics),
                            failed_requests=int(failed))

    def stop(self, timeout: Optional[float] = None) -> None:
        """Drain every queue, then stop the dispatcher thread."""
        with self._cv:
            self._stopping = True
            self._cv.notify()
        self._thread.join(timeout)

    def __enter__(self) -> "Server":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- dispatcher ----------------------------------------------------------
    @staticmethod
    def _head_by(seg: _Segment) -> float:
        """When the queue head demands attention: its flush-by slack or
        its hard deadline, whichever lands first."""
        by = seg.request.flush_by
        dl = seg.request.deadline
        return by if dl is None else min(by, dl)

    def _pick(self, now: float):
        """(model to flush now, earliest future deadline) — lock held."""
        pick, pick_deadline, wake = None, None, None
        for name, q in self._queues.items():
            if not q:
                continue
            head_by = self._head_by(q[0])
            ready = (self._stopping or head_by <= now
                     or self._queued_rows[name] >= self._max_batch)
            if ready:
                if pick is None or head_by < pick_deadline:
                    pick, pick_deadline = name, head_by
            elif wake is None or head_by < wake:
                wake = head_by
        return pick, wake

    def _take(self, name: str,
              now: float) -> Tuple[List[_Segment], List[_Segment]]:
        """Pop the flush batch: FIFO segments up to max_batch rows — the
        largest bucket that fits before the head's deadline.  Segments
        whose hard deadline already passed are popped into the expired
        list instead (failed typed by the caller).  Lock held."""
        q = self._queues[name]
        batch, rows, expired = [], 0, []
        while q:
            seg = q[0]
            dl = seg.request.deadline
            if dl is not None and dl <= now:
                q.popleft()
                self._queued_rows[name] -= seg.rows
                expired.append(seg)
                continue
            if rows + seg.rows > self._max_batch:
                break
            q.popleft()
            self._queued_rows[name] -= seg.rows
            batch.append(seg)
            rows += seg.rows
        return batch, expired

    def _run(self) -> None:
        """Dispatcher supervisor: restart a crashed ``_loop`` (bounded),
        failing the crashed flush's in-flight requests typed.  The crash
        that exhausts the budget fails ALL queued work and marks the
        server dead (not ready) — submissions then fail fast."""
        while True:
            try:
                self._loop()
                return                     # clean stop()
            except BaseException as exc:   # noqa: BLE001 — supervised
                with self._cv:
                    batch, self._inflight = self._inflight, []
                    self._restarts += 1
                    dead = self._restarts > self._max_restarts
                    drained: List[_Segment] = []
                    if dead:
                        self._dead = True
                        for q in self._queues.values():
                            drained.extend(q)
                            q.clear()
                        for name in self._queued_rows:
                            self._queued_rows[name] = 0
                err = DispatcherCrashError(
                    f"dispatcher crashed ({type(exc).__name__}: {exc})"
                    + ("; restart budget exhausted" if dead
                       else "; restarting"))
                err.__cause__ = exc
                for seg in batch + drained:
                    seg.request._fail(err)
                    self._metrics[seg.request.name].record_drop()
                if dead:
                    return

    def _loop(self) -> None:
        while True:
            with self._cv:
                while True:
                    now = time.monotonic()
                    name, wake = self._pick(now)
                    if name is not None:
                        batch, expired = self._take(name, now)
                        self._inflight = batch
                        break
                    if self._stopping:
                        return
                    self._cv.wait(timeout=(None if wake is None
                                           else max(wake - now, 0.0)))
            for seg in expired:
                self._metrics[name].record_deadline()
                req = seg.request
                waited_ms = (time.monotonic() - req.submitted_at) * 1e3
                budget_ms = (req.deadline - req.submitted_at) * 1e3
                req._fail(DeadlineExceededError(
                    f"request for {name!r} expired after {waited_ms:.0f} ms "
                    f"in queue (deadline {budget_ms:.0f} ms)"))
            if batch:
                if self._faults is not None:
                    seq = self._flush_seq
                    self._flush_seq += 1
                    self._faults.apply("dispatch", seq)
                self._serve(name, batch)
            with self._cv:
                self._inflight = []

    def _serve(self, name: str, batch: List[_Segment]) -> None:
        metrics = self._metrics[name]
        try:
            entry = self._registry.entry(name)
            X = (batch[0].X if len(batch) == 1
                 else np.concatenate([s.X for s in batch]))
            preds = entry.pipeline.predict(
                X, plan=self._registry.plan, mode="cached",
                cache=entry.cache).cpu().numpy()
        except BaseException as exc:
            # a flush can only fail as a unit (e.g. the tenant was
            # unpublished mid-flight): fail the futures, count the drops
            for seg in batch:
                seg.request._fail(exc)
                metrics.record_drop()
            return
        rows = int(X.shape[0])
        entry.seen_buckets.add(bucket_pow2(rows, ROW_BUCKET_FLOOR))
        metrics.record_flush(rows, bucket_pow2(rows, ROW_BUCKET_FLOOR))
        lo = 0
        for seg in batch:
            if seg.request._deliver(seg.index, preds[lo:lo + seg.rows]):
                metrics.record_request(seg.request.n_rows,
                                       seg.request.latency_s)
            lo += seg.rows
        self._maybe_log()

    def _maybe_log(self) -> None:
        if self._log_every_s is None:
            return
        now = time.monotonic()
        if now - self._last_log < self._log_every_s:
            return
        self._last_log = now
        for model_name, snap in sorted(self.stats().items()):
            print(format_stats_line(model_name, snap))

"""RetryingSource — a self-healing ``DataSource`` wrapper.

The port's copy of :mod:`repro.resilience.retry`.

Long out-of-core fits stream the same shards hundreds of times (one pass
per tree level), so a transient read error minutes into a run must not
kill the fit.  ``RetryingSource`` wraps any ``DataSource`` and retries
*transient* failures (see :func:`repro_torch.resilience.errors.is_transient`)
with exponential backoff + seeded jitter; corruption
(:class:`ShardCorruptionError`) and other non-transient errors propagate
immediately — retrying them would loop forever or mask real damage.

Recovery mechanics: the ``DataSource`` contract guarantees restartable,
deterministic passes, so after a failed read the wrapper re-opens
``source.chunks(rows)`` and fast-forwards past the chunks already
delivered this pass — consumers observe an uninterrupted, identical
chunk stream (possibly delayed).  The fast-forward re-reads skipped
chunks, which is the price of not buffering them; the per-*chunk* retry
budget resets on every successful read so one flaky shard cannot starve
a long pass.

An optional per-chunk timeout (``chunk_timeout_s``) guards against hung
reads: the fetch runs on a worker thread and a timeout surfaces as
:class:`ChunkTimeoutError` (transient, so it retries).  The thread is
only spawned when a timeout is configured, so the fault-free path adds
no thread hops.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Optional

import numpy as np

from repro_torch.resilience.errors import ChunkTimeoutError, is_transient


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Backoff/timeout knobs for :class:`RetryingSource`.

    max_retries:      consecutive failed attempts allowed per chunk.
    base_delay_s:     backoff starts here and doubles per attempt...
    max_delay_s:      ...capped here.
    jitter:           +/- fraction of the delay randomized (seeded) so
                      parallel readers don't retry in lockstep.
    chunk_timeout_s:  per-chunk fetch deadline (None = no watchdog).
    seed:             jitter RNG seed (determinism for tests).
    """

    max_retries: int = 4
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    jitter: float = 0.5
    chunk_timeout_s: Optional[float] = None
    seed: int = 0

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError("jitter must be in [0, 1]")

    def delay_s(self, attempt: int, rng: np.random.Generator) -> float:
        """Backoff before retry ``attempt`` (1-based): exponential,
        capped, jittered."""
        base = min(self.base_delay_s * (2.0 ** (attempt - 1)),
                   self.max_delay_s)
        if self.jitter:
            base *= 1.0 + self.jitter * (2.0 * float(rng.random()) - 1.0)
        return max(base, 0.0)


class RetryingSource:
    """Wrap ``source`` so transient chunk-read failures self-heal.

    Presents the unchanged ``DataSource`` protocol; ``stats`` counts the
    recovery work (retries, timeouts, reopened passes) so chaos tests —
    and operators — can see the wrapper actually absorbed faults.
    """

    def __init__(self, source, policy: RetryPolicy = RetryPolicy()):
        self._source = source
        self.policy = policy
        self.stats = {"retries": 0, "timeouts": 0, "reopened_passes": 0}
        self._watchdog: Optional[threading.Thread] = None
        self._closed = False

    @property
    def n_fields(self) -> int:
        return self._source.n_fields

    def __getattr__(self, name):
        return getattr(self._source, name)

    # -- lifecycle -----------------------------------------------------------
    def close(self, timeout_s: float = 1.0) -> None:
        """Finalize the wrapper: join the last watchdog thread (bounded
        wait — a genuinely hung fetch stays abandoned, the thread is a
        daemon) and close the wrapped source when it supports closing.
        Idempotent, and parity with ``PrefetchIterator.close()``:
        ``train_streaming`` calls this on every exit path so a fit never
        leaks a fetch thread or an open shard handle."""
        if self._closed:
            return
        self._closed = True
        t = self._watchdog
        if t is not None and t.is_alive():
            t.join(timeout=timeout_s)
        self._watchdog = None
        inner_close = getattr(self._source, "close", None)
        if callable(inner_close):
            inner_close()

    def __enter__(self) -> "RetryingSource":
        self._closed = False
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()

    # -- the protected pass --------------------------------------------------
    def _open(self, rows: int, skip: int):
        """A fresh pass iterator fast-forwarded past ``skip`` delivered
        chunks (DataSource passes are deterministic, so chunk ``skip``
        of the new pass IS the chunk that failed)."""
        it = iter(self._source.chunks(rows))
        for _ in range(skip):
            next(it)
        return it

    def _fetch(self, it):
        """One ``next(it)``, under the watchdog when configured.  A
        timed-out fetch abandons the worker thread (daemonized) and
        raises ChunkTimeoutError; the caller re-opens the pass."""
        timeout = self.policy.chunk_timeout_s
        if timeout is None:
            return next(it)
        out: queue.Queue = queue.Queue(maxsize=1)

        def worker():
            try:
                out.put(("ok", next(it)))
            except BaseException as e:  # noqa: BLE001 — re-raised below
                out.put(("err", e))
        t = threading.Thread(target=worker, daemon=True)
        self._watchdog = t           # joined (bounded) by close()
        t.start()
        try:
            status, value = out.get(timeout=timeout)
        except queue.Empty:
            self.stats["timeouts"] += 1
            raise ChunkTimeoutError(
                f"chunk fetch exceeded {timeout:g}s") from None
        if status == "err":
            raise value
        return value

    def chunks(self, rows: int):
        rng = np.random.default_rng(self.policy.seed)
        it = iter(self._source.chunks(rows))
        delivered = 0          # chunks yielded this pass
        attempts = 0           # consecutive failures at the current chunk
        reopen = False
        while True:
            try:
                if reopen:
                    # the reopen + fast-forward reads the source too, so it
                    # must sit INSIDE the retry loop: a fault that fires
                    # while skipping already-delivered chunks is just
                    # another transient failure, not a fit-killer
                    it = self._open(rows, delivered)
                    reopen = False
                chunk = self._fetch(it)
            except StopIteration:
                return
            except BaseException as exc:  # noqa: BLE001 — classified below
                if not is_transient(exc) or attempts >= \
                        self.policy.max_retries:
                    raise
                attempts += 1
                self.stats["retries"] += 1
                time.sleep(self.policy.delay_s(attempts, rng))
                self.stats["reopened_passes"] += 1
                reopen = True
                continue
            attempts = 0
            delivered += 1
            yield chunk

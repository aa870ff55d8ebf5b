"""Seeded fault injection: the port's copy of
:mod:`repro.resilience.faults`.

  * a :class:`Fault` targets one ``(site, step)`` point; sites are free
    strings owned by the instrumented layer (``"step"`` for training
    rounds, ``"dispatch"`` for serving flushes);
  * a :class:`FaultSchedule` holds the pending faults and fires each at
    most once: ``kind="error"`` raises, ``kind="latency"`` sleeps
    ``delay_s`` and returns;
  * :class:`FaultInjector` raises at given steps of site ``"step"``;
  * :class:`FaultySource` injects a schedule into a ``DataSource``'s chunk
    reads (site ``"source"``), :func:`seeded_schedule` draws a random
    schedule from a seed and :func:`corrupt_file` flips a shard's bytes.

Everything is deterministic given the constructor arguments.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.resilience.errors import TransientIOError


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault at ``(site, step)``.

    kind:     ``"error"`` raises ``exc(message)``; ``"latency"`` sleeps
              ``delay_s`` then lets the step proceed.
    exc:      exception type for ``kind="error"``.
    """

    site: str
    step: int
    kind: str = "error"
    exc: type = RuntimeError
    message: Optional[str] = None
    delay_s: float = 0.0

    def raise_(self) -> None:
        raise self.exc(self.message
                       or f"injected fault at {self.site}[{self.step}]")


class FaultSchedule:
    """A set of pending faults, each fired at most once.

    ``apply(site, step)`` is the one instrumentation point a layer needs:
    latency faults sleep, error faults raise.  ``fired`` records
    ``(site, step, kind)`` triples in firing order.
    """

    def __init__(self, faults: Iterable[Fault] = ()):
        self._pending: Dict[Tuple[str, int], List[Fault]] = {}
        for f in faults:
            self._pending.setdefault((f.site, f.step), []).append(f)
        self.fired: List[Tuple[str, int, str]] = []

    def add(self, site: str, step: int, *, kind: str = "error",
            exc: type = RuntimeError, message: Optional[str] = None,
            delay_s: float = 0.0) -> "FaultSchedule":
        self._pending.setdefault((site, int(step)), []).append(
            Fault(site, int(step), kind, exc, message, delay_s))
        return self

    def pending(self) -> int:
        return sum(len(v) for v in self._pending.values())

    def apply(self, site: str, step: int) -> None:
        """Fire every fault scheduled at ``(site, step)``: sleep for
        latency kinds, then raise the first error kind (if any)."""
        faults = self._pending.pop((site, int(step)), None)
        if not faults:
            return
        to_raise = None
        for f in faults:
            self.fired.append((f.site, f.step, f.kind))
            if f.kind == "latency":
                time.sleep(f.delay_s)
            elif to_raise is None:
                to_raise = f
        if to_raise is not None:
            to_raise.raise_()


class FaultInjector(FaultSchedule):
    """Raise ``exc`` the first time each step in ``fail_at_steps`` is
    checked (site ``"step"``)."""

    def __init__(self, fail_at_steps: Iterable[int] = (),
                 exc: type = RuntimeError):
        super().__init__(Fault("step", int(s), exc=exc,
                               message=f"injected fault at step {int(s)}")
                         for s in fail_at_steps)
        self.fail_at = {int(s) for s in fail_at_steps}
        self.exc = exc

    def check(self, step: int) -> None:
        self.apply("step", step)


class FaultySource:
    """Inject scheduled faults into a ``DataSource``'s chunk stream.

    Each chunk read consumes one step of ``site`` (monotonic across
    passes AND across retries — a retried read gets a fresh index, so a
    one-shot fault does not re-fire on the retry).  The fault fires
    BEFORE the chunk is yielded: an ``"error"`` fault makes the read
    fail as a flaky filesystem would, a ``"latency"`` fault stalls it.
    """

    def __init__(self, source, schedule: FaultSchedule,
                 site: str = "source"):
        self._source = source
        self.schedule = schedule
        self.site = site
        self.reads = 0               # monotonic chunk-read counter

    @property
    def n_fields(self) -> int:
        return self._source.n_fields

    def chunks(self, rows: int):
        for chunk in self._source.chunks(rows):
            step = self.reads
            self.reads += 1
            self.schedule.apply(self.site, step)
            yield chunk

    def __getattr__(self, name):
        return getattr(self._source, name)


def seeded_schedule(seed: int, site: str, n_steps: int, *,
                    rate: float = 0.1, exc: type = TransientIOError,
                    latency_rate: float = 0.0,
                    max_delay_s: float = 0.01) -> FaultSchedule:
    """Draw a deterministic random schedule: each step in
    ``range(n_steps)`` independently gets an error fault with
    probability ``rate`` and a latency spike with ``latency_rate``.
    Same seed → same schedule, every run."""
    rng = np.random.default_rng(seed)
    sched = FaultSchedule()
    for step in range(int(n_steps)):
        if rng.random() < rate:
            sched.add(site, step, exc=exc,
                      message=f"injected {exc.__name__} at "
                              f"{site}[{step}] (seed {seed})")
        if latency_rate and rng.random() < latency_rate:
            sched.add(site, step, kind="latency",
                      delay_s=float(rng.random() * max_delay_s))
    return sched


def corrupt_file(path: str, *, seed: int = 0, n_bytes: int = 8) -> List[int]:
    """Deterministically flip ``n_bytes`` bytes of the file in place
    (bit-rot / torn-write stand-in); returns the flipped offsets.  The
    shard-manifest crc32 verification must turn this into a
    ``ShardCorruptionError`` instead of silently mis-training."""
    with open(path, "rb") as f:
        data = bytearray(f.read())
    if not data:
        raise ValueError(f"cannot corrupt empty file {path!r}")
    rng = np.random.default_rng(seed)
    offsets = sorted(int(o) for o in
                     rng.choice(len(data), size=min(n_bytes, len(data)),
                                replace=False))
    for o in offsets:
        data[o] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(data))
    return offsets

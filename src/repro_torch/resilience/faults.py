"""Seeded fault injection: the :mod:`repro.resilience.faults` primitives
that the serving path uses.

  * a :class:`Fault` targets one ``(site, step)`` point; sites are free
    strings owned by the instrumented layer (``"step"`` for training
    rounds, ``"dispatch"`` for serving flushes);
  * a :class:`FaultSchedule` holds the pending faults and fires each at
    most once: ``kind="error"`` raises, ``kind="latency"`` sleeps
    ``delay_s`` and returns;
  * :class:`FaultInjector` raises at given steps of site ``"step"``.

Everything is deterministic given the constructor arguments.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, List, Optional, Tuple


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

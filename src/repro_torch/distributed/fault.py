"""Fault tolerance: the step journal and the restart driver.

The counterpart of :mod:`repro.distributed.fault`.  Training is
synchronous over a fixed mesh; a worker failure surfaces as an exception.
Recovery rebuilds a mesh from the surviving devices
(:mod:`~repro_torch.distributed.elastic`), restores the newest valid
checkpoint and replays deterministically: a round's random stream is
keyed by ``(seed, round)``, so re-growing tree k after a restart
reproduces it.

The level-wise grower is fixed-shape: every data shard scans n/D records
a level, so data skew causes no compute imbalance; stragglers are
hardware outliers, which the journal's per-step wall time shows.

``Fault``, ``FaultInjector`` and ``FaultSchedule`` moved to
:mod:`repro_torch.resilience.faults`; importing them from here still
works, with a ``DeprecationWarning``.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

_MOVED = ("Fault", "FaultInjector", "FaultSchedule")


def __getattr__(name: str) -> Any:
    if name in _MOVED:
        import warnings

        warnings.warn(
            f"repro_torch.distributed.fault.{name} is deprecated; import it "
            f"from repro_torch.resilience.faults instead",
            DeprecationWarning, stacklevel=2)
        from repro_torch.resilience import faults as _faults
        return getattr(_faults, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class StepJournal:
    """Append-only jsonl journal of completed steps, fsync'd a line.

    Survives crashes: a torn last line (a write cut short) is ignored, so
    a restart resumes after the last whole entry."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def append(self, step: int, record: Dict[str, Any]) -> None:
        entry = dict(step=step, time=time.time(), **record)
        with open(self.path, "a") as f:
            f.write(json.dumps(entry) + "\n")
            f.flush()
            os.fsync(f.fileno())

    def entries(self) -> List[Dict[str, Any]]:
        if not os.path.exists(self.path):
            return []
        out = []
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    break          # a torn tail write: ignore the rest
        return out

    def last_step(self) -> Optional[int]:
        e = self.entries()
        return e[-1]["step"] if e else None


def run_with_restarts(make_trainer: Callable[[int], Iterator[int]],
                      *, max_restarts: int = 3,
                      on_restart: Optional[Callable[[int, Exception], None]]
                      = None) -> int:
    """Drive a restartable trainer through failures.

    ``make_trainer(start_step)`` returns an iterator of completed step
    indices (checkpointing inside) that may raise mid-flight; it is rebuilt
    from the step after the last completed one.  Returns the last completed
    step; raises after ``max_restarts`` restarts."""
    start, last, restarts = 0, -1, 0
    while True:
        try:
            for step in make_trainer(start):
                last = step
            return last
        except Exception as e:  # noqa: BLE001 — any worker fault restarts
            restarts += 1
            if restarts > max_restarts:
                raise
            if on_restart is not None:
                on_restart(restarts, e)
            start = last + 1

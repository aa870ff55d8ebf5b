"""GracefulShutdown — preemption-safe fits via a typed signal layer.

The port's own copy of :mod:`repro.resilience.shutdown`.  Long fits on
preemptible capacity receive SIGTERM with a grace window; this layer turns
the signal into an exit between rounds:

  1. ``with GracefulShutdown() as gs`` installs SIGTERM/SIGINT handlers
     that only set a flag (handlers must stay async-signal-safe);
  2. the trainer checks ``gs.requested`` after each round commits — the
     in-flight round always finishes;
  3. on a requested shutdown the trainer raises
     :class:`~repro_torch.resilience.errors.TrainingInterrupted`, carrying
     the committed round count and the partial ``TrainResult``; the
     estimator keeps the partial model and, given a checkpoint directory,
     writes a resume checkpoint first;
  4. re-running the same fit against the same ``checkpoint_dir`` restores
     the committed rounds and grows the rest — the per-round random stream
     is keyed by ``(seed, round)``, so the resumed ensemble reproduces the
     uninterrupted one.

The context manager restores the previous handlers on exit.  ``request()``
lets tests (and in-process supervisors) trigger the same path without
delivering a real signal.
"""
from __future__ import annotations

import signal
import threading
from typing import Optional, Tuple


class GracefulShutdown:
    """Flag-setting signal handler scope (see module doc).

    signals:  which signals request a graceful exit (default SIGTERM +
              SIGINT).  Installation requires the main thread; constructing
              on a worker thread is allowed but ``__enter__`` will raise
              (Python restricts ``signal.signal`` to the main thread).
    """

    def __init__(self, signals: Tuple[int, ...] = (signal.SIGTERM,
                                                   signal.SIGINT)):
        self.signals = tuple(signals)
        self._requested = threading.Event()
        self._signal_name: Optional[str] = None
        self._previous = {}

    # -- handler scope -------------------------------------------------------
    def __enter__(self) -> "GracefulShutdown":
        for sig in self.signals:
            self._previous[sig] = signal.signal(sig, self._handler)
        return self

    def __exit__(self, *exc_info) -> None:
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        self._previous.clear()

    def _handler(self, signum, frame) -> None:
        # async-signal-safe: set the flag, remember the name, return
        if self._signal_name is None:
            try:
                self._signal_name = signal.Signals(signum).name
            except ValueError:
                self._signal_name = str(signum)
        self._requested.set()

    # -- trainer surface -----------------------------------------------------
    @property
    def requested(self) -> bool:
        """Has a shutdown been requested?  Checked between rounds."""
        return self._requested.is_set()

    @property
    def signal_name(self) -> Optional[str]:
        """Name of the signal that requested the exit (None if none)."""
        return self._signal_name

    def request(self, name: str = "manual") -> None:
        """Programmatic shutdown request (tests, in-process supervisors)
        — same observable behavior as a delivered signal."""
        if self._signal_name is None:
            self._signal_name = name
        self._requested.set()

"""Reading the device's trace: busy time, kernels by name, idle gaps.

Frozen copies of the smoke's ``device_busy`` (the union of the device
events) and of its profile retake: ``torch.profiler`` now and then comes
back without device events, so an empty profile is taken again, up to
``PROFILE_ATTEMPTS`` stretches; where every one stays empty the run says
so and the profiled metrics are left out, never read as 0.
"""
from __future__ import annotations

import bisect
import sys
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

PROFILE_ATTEMPTS = 3
TOP = 10                   # entries of each breakdown list
NAME_CHARS = 100           # profiler names are cut to this length
HOST_SCAN = 4000           # host events searched back for a gap's owner


class Trace(NamedTuple):
    """A profiled stretch of ``units`` rounds, calls or seconds on
    ``chips`` cards."""
    device: List[Tuple[float, float, str, int]]  # (start us, end us, name,
    #                                              card)
    host: List[Tuple[float, float, str]]
    window_s: float                          # the stretch by the host clock
    units: float
    chips: int = 1

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on a card: the union of
        each card's events, averaged over the cards."""
        busy: Dict[int, float] = {}
        reach: Dict[int, float] = {}
        for a, b, _, card in sorted(self.device):
            r = reach.get(card, -float("inf"))
            busy[card] = busy.get(card, 0.0) + max(0.0, b - max(a, r))
            reach[card] = max(r, b)
        return sum(busy.values()) / 1e6 / max(self.chips, 1)

    def kernels(self) -> List[Tuple[float, float, str, int]]:
        """Device events that are kernel launches (no copies or fills)."""
        return [e for e in self.device
                if "memcpy" not in e[2].lower() and "memset" not in e[2].lower()]

    def device_s(self, names) -> float:
        """Summed device seconds of the kernels whose name holds one of
        ``names``, over the cards."""
        return sum(b - a for a, b, n, _ in self.device
                   if any(k in n for k in names)) / 1e6


def _is_device(event) -> bool:
    return "CUDA" in str(getattr(event, "device_type", ""))


class Profiler:
    """Stretches of the window under ``torch.profiler``, one at a time:
    ``begin()``, run the stretch, ``end(units)``.  The load plans them
    (``plan``): the first records the device alone, which costs the host
    little, and gives the metrics; the second records the host's
    operations too, which slows the host, and names the idle gaps.  An
    empty profile is counted and the stretch retaken, up to
    ``PROFILE_ATTEMPTS`` times each."""

    def __init__(self, chips: int = 1):
        self.chips = int(chips)
        self.units = [1.0, 1.0]
        self.traces: List[Optional[Trace]] = [None, None]
        self.attempts = [0, 0]
        self._prof = None
        self._t0 = 0.0

    def plan(self, metric_units: float, gap_units: float) -> None:
        self.units = [float(metric_units), float(gap_units)]

    @property
    def trace(self) -> Optional[Trace]:
        """The device-only stretch the metrics read."""
        return self.traces[0]

    @property
    def gap_trace(self) -> Optional[Trace]:
        return self.traces[1]

    @property
    def stage(self) -> Optional[int]:
        for i in (0, 1):
            if self.traces[i] is None and self.attempts[i] < PROFILE_ATTEMPTS:
                return i
        return None

    @property
    def wanted(self) -> bool:
        return self.stage is not None

    @property
    def due_units(self) -> float:
        """Units the stretch being taken should cover."""
        return self.units[self.stage]

    @property
    def active(self) -> bool:
        return self._prof is not None

    def begin(self) -> None:
        import torch
        acts = ([torch.profiler.ProfilerActivity.CUDA]
                if torch.cuda.is_available() else [])
        if self.stage == 1 or not acts:
            acts.append(torch.profiler.ProfilerActivity.CPU)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        self._t0 = time.perf_counter()

    def end(self, units: float) -> None:
        import torch
        if torch.cuda.is_available():
            for card in range(self.chips):
                torch.cuda.synchronize(card)
        window = time.perf_counter() - self._t0
        prof, self._prof = self._prof, None
        stage = self.stage
        prof.stop()
        self.attempts[stage] += 1
        device, host = [], []
        for e in prof.events():
            span = (float(e.time_range.start), float(e.time_range.end),
                    str(e.name))
            if _is_device(e):
                device.append(span + (int(e.device_index),))
            else:
                host.append(span)
        if not device or units <= 0:
            print(f"torch.profiler saw {len(device)} device events over "
                  f"{units} units (stretch {stage}, profile "
                  f"{self.attempts[stage]} of {PROFILE_ATTEMPTS})",
                  file=sys.stderr)
            return
        self.traces[stage] = Trace(device, host, window, float(units),
                                   self.chips)
        print(f"stretch {stage}: {len(device)} device events, {len(host)} "
              f"host events over {units} units, {window!r} s",
              file=sys.stderr)


def device_ops(trace: Trace) -> List[List]:
    """The device operations that took most time, summed by name."""
    by_name: Dict[str, float] = {}
    for a, b, n, _ in trace.device:
        key = n[:NAME_CHARS]
        by_name[key] = by_name.get(key, 0.0) + (b - a) / 1e6
    return [[n, s] for n, s in
            sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]]


def idle_gaps(trace: Trace) -> List[List]:
    """The device's idle time between its events, summed by the innermost
    host operation that spanned each gap's midpoint ("python" where none
    did: the host ran Python between operations)."""
    merged: List[List[float]] = []
    for a, b, *_ in sorted(trace.device):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    host = sorted(trace.host)
    starts = [h[0] for h in host]
    by_name: Dict[str, float] = {}
    for (_, end), (nxt, _) in zip(merged, merged[1:]):
        mid = 0.5 * (end + nxt)
        owner = "python"
        i = bisect.bisect_right(starts, mid) - 1
        stop = max(-1, i - HOST_SCAN)
        while i > stop:
            if host[i][1] >= mid:
                owner = host[i][2][:NAME_CHARS]
                break
            i -= 1
        by_name[owner] = by_name.get(owner, 0.0) + (nxt - end) / 1e6
    return [[n, s] for n, s in
            sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]]

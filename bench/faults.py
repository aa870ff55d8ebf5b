"""Faults planted under the timed path, to show that the check fails them.

Each kind of traffic (``bench/kinds/<kind>.py``) plants its own with
``plant(fault)``, which patches the program (``repro_torch``) and returns
the functions that undo the patches; :func:`planted` holds them for the
length of a run.  The benchmark's own runs never enter one.  They serve
the readings on the card (``bench/readings.py``) and the tests.

* ``unchanged``: a step returns its state unchanged;
* ``half``: half of the batch left out, the mean taken over the rest;
* ``altered``: an answer altered where it is produced.

The cells run on one card, so no exchange between cards can be left out.
"""
from __future__ import annotations

import contextlib

FAULTS = ("unchanged", "half", "altered")


def patch(owner, name, make):
    """Replace ``owner.name`` by ``make(real)``; returns the undo."""
    real = getattr(owner, name)
    setattr(owner, name, make(real))
    return lambda: setattr(owner, name, real)


@contextlib.contextmanager
def planted(fault: str, kind):
    """Patch the program with ``fault`` as the kind's module plants it."""
    undo = kind.plant(fault)
    try:
        yield
    finally:
        for u in reversed(undo):
            u()

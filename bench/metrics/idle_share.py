"""The device's idle share of a round or call, in percent: 1 − the
device's busy time a traced unit (the union of its events over the
device-only stretch, over the stretch's rounds or calls) over the mean
unit before the run's first profile (``unit_s``, host clock).  The
profiler's own cost to the host stays out: it slows the units it records
and every one after them, not those before.  One reader serves
``idle_share.train`` and ``idle_share.predict``."""


def read(ctx):
    unit_s = ctx.counters.get("unit_s")
    if ctx.trace is None or not unit_s:
        return None
    busy = ctx.trace.busy_s / ctx.trace.units
    return 100.0 * (1.0 - busy / unit_s)

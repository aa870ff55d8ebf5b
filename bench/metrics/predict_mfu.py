"""A scoring call's least time (``bench.measure.roofline.ensemble``) over
the mean call, the copy of its margins to the host included, in percent:
the whole call's share of the card's peak.  The mean call is timed by the
host clock over the traced run's calls before its first profile
(``unit_s``)."""
from bench.measure import roofline


def read(ctx):
    call_s = ctx.counters.get("unit_s")
    if not call_s:
        return None
    s = ctx.shapes
    work = roofline.ensemble(s["n"], s["F"], s["trees"], s["depth"], s["K"])
    return roofline.share(work, call_s)

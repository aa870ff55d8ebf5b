"""The round's least time over the mean round, in percent, with the codes
counted at their width: the whole step's share of the card's peak.

The least time is the larger of the bytes over the HBM peak and the
operations over the float32 peak, of steps ①–⑤ as
``bench.measure.packed.round_work`` counts them from the shapes (half a
byte a code at 16 bins or fewer).  The mean round is timed by the host
clock over the traced run's rounds before its first profile
(``unit_s``)."""
from bench.measure import packed, roofline


def read(ctx):
    round_s = ctx.counters.get("unit_s")
    if not round_s:
        return None
    s = ctx.shapes
    work = packed.round_work(s["n"], s["F"], s["K"], s["depth"],
                             s["n_bins"])
    return roofline.share(work, round_s)

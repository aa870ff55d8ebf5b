"""Step ①'s share of its roofline, in percent: its least time a round
(``bench.measure.roofline.histogram_round``) over the device time a
traced round spends in the kernels of ``csrc/histogram.cu`` that build
it (the grouped histogram and its counting sort)."""
from bench.measure import roofline

KERNELS = ("hist_grouped_kernel", "slot_sort_kernel", "slot_scan_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    per_round = ctx.trace.device_s(KERNELS) / ctx.trace.units
    if per_round <= 0:
        return None
    s = ctx.shapes
    work = roofline.histogram_round(s["n"], s["F"], s["K"], s["depth"],
                                    s["n_bins"])
    return roofline.share(work, per_round)

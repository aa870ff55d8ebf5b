"""Step ①'s share of its roofline with the codes counted at their width,
in percent: its least time a round (``bench.measure.packed.
histogram_round``, half a byte a code at 16 bins or fewer) over the device
time a traced round spends in the kernels of ``csrc/histogram.cu`` that
build it (the grouped histogram, its nibble instance on packed codes, and
its counting sort)."""
from bench.measure import packed, roofline

KERNELS = ("hist_grouped_kernel", "slot_sort_kernel", "slot_scan_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    per_round = ctx.trace.device_s(KERNELS) / ctx.trace.units
    if per_round <= 0:
        return None
    s = ctx.shapes
    work = packed.histogram_round(s["n"], s["F"], s["K"], s["depth"],
                                  s["n_bins"])
    return roofline.share(work, per_round)

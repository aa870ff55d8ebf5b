"""Step ②'s share of its roofline, in percent: its least time a round
(``bench.measure.splits.split_round``: each level's float32 histogram
read once and its decisions and tables written once, at the HBM peak)
over the device time a traced round spends in ``csrc/splits.cu``'s
split-search kernel.  None where the trace holds no such kernel."""
from bench.measure import roofline, splits

KERNELS = ("split_level_kernel",)


def read(ctx):
    if ctx.trace is None:
        return None
    per_round = ctx.trace.device_s(KERNELS) / ctx.trace.units
    if per_round <= 0:
        return None
    s = ctx.shapes
    work = splits.split_round(s["K"], s["F"], s["depth"], s["n_bins"])
    return roofline.share(work, per_round)

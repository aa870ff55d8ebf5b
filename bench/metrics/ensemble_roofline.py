"""The ensemble kernel's share of its roofline, in percent: the least
time of a scoring call (``bench.measure.roofline.ensemble``: records x
trees x depth hops, the codes, tables and margins once) over the device
time a traced call spends in ``csrc/traversal.cu``'s ensemble kernel."""
from bench.measure import roofline

KERNELS = ("ensemble_kernel",)


def read(ctx):
    if ctx.trace is None:
        return None
    per_call = ctx.trace.device_s(KERNELS) / ctx.trace.units
    if per_call <= 0:
        return None
    s = ctx.shapes
    work = roofline.ensemble(s["n"], s["F"], s["trees"], s["depth"], s["K"])
    return roofline.share(work, per_call)

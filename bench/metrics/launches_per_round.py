"""Device kernel launches in the traced rounds, over the rounds (copies
and fills are not launches)."""


def read(ctx):
    if ctx.trace is None:
        return None
    return len(ctx.trace.kernels()) / ctx.trace.units

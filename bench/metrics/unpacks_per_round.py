"""Unpacks of 4-bit codes a round: the count of the program's
``codes.unpack`` spans (``repro_torch.core.binning.PackedCodes.unpack``)
over the count of its ``gbdt.round`` spans (``repro_torch.obs``), as
recorded while the traced run's profiles record; 0.0 where rounds were
recorded and no unpack.  None where no round was recorded, or where the
program keeps no such span (it names it ``binning.UNPACK_SPAN``)."""


def read(ctx):
    try:
        from repro_torch import obs
        from repro_torch.core import binning
    except ImportError:
        return None
    name = getattr(binning, "UNPACK_SPAN", None)
    if name is None:
        return None
    rows = obs.spans()
    rounds = rows.get("gbdt.round", {}).get("count", 0)
    if not rounds:
        return None
    return rows.get(name, {}).get("count", 0) / rounds

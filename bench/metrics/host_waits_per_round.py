"""The round's waits on the device: the count of the program's
``host.wait`` spans over the count of its ``gbdt.round`` spans
(``repro_torch.obs``), as recorded while the traced run's profiles
record.  None where no round was recorded, or where the program keeps
no spans."""


def read(ctx):
    try:
        from repro_torch import obs
    except ImportError:
        return None
    rows = obs.spans()
    rounds = rows.get("gbdt.round", {}).get("count", 0)
    if not rounds:
        return None
    return rows.get("host.wait", {}).get("count", 0) / rounds

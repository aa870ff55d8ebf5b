"""The host's own time a round, in ms: the total of the program's
``gbdt.round`` spans less that of its ``host.wait`` spans (the host
blocked on the device), over the count of ``gbdt.round`` spans
(``repro_torch.obs``), as recorded while the traced run's profiles
record.  None where no round was recorded, or where the program keeps
no spans."""


def read(ctx):
    try:
        from repro_torch import obs
    except ImportError:
        return None
    rows = obs.spans()
    rounds = rows.get("gbdt.round", {})
    if not rounds.get("count"):
        return None
    waited = rows.get("host.wait", {}).get("total_ns", 0)
    return (rounds["total_ns"] - waited) / rounds["count"] / 1e6

"""``repro_torch.launch`` — the mesh, the H100 roofline, the train and
serve command-line drivers (``python -m repro_torch.launch.train|serve``),
and the dry runs and their report (``python -m
repro_torch.launch.dryrun|dryrun_gbdt|report``)."""

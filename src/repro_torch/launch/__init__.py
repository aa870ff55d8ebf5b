"""``repro_torch.launch`` — the mesh, the H100 roofline and the train and
serve command-line drivers (``python -m repro_torch.launch.train|serve``)."""

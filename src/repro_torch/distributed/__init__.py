"""``repro_torch.distributed`` — the data-parallel trainer and its parts:
the checkpoint layer (:mod:`~repro_torch.distributed.checkpoint`: named
and positional payloads), the mesh collectives and the explicit sharded
schedule (:mod:`~repro_torch.distributed.sharding`), elastic re-meshing
(:mod:`~repro_torch.distributed.elastic`), the step journal
(:mod:`~repro_torch.distributed.fault`) and
:func:`~repro_torch.distributed.trainer.train_distributed`."""

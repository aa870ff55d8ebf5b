"""``repro_torch.distributed`` — so far only the named-payload checkpoint
layer (:mod:`repro_torch.distributed.checkpoint`); the data-parallel
trainer waits for ROADMAP Queue 1 item 8."""

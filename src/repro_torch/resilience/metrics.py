"""Process-wide resilience counters.

The port's own copy of :mod:`repro.resilience.metrics`, kept as a name:
the counters live in :mod:`repro_torch.obs` beside the spans.
"""
from repro_torch.obs import counts, delta, record, reset, snapshot

__all__ = ["record", "counts", "snapshot", "delta", "reset"]

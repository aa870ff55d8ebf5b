"""Recovery policy for self-healing training.

The port's own copy of :mod:`repro.resilience.recovery`.  The in-memory
trainer (``core.gbdt.train``) reads the divergence fields: without a
policy a non-finite loss stays the caller's problem; with one the host
loop raises :class:`NumericalDivergenceError` naming the round, and the
fused trainer rolls back to the last finite round, backing the learning
rate off when the same round diverges twice.  The checkpoint, transient
and OOM fields drive the streaming trainer (``core.gbdt.train_streaming``:
a transient failure replays the round, from the newest checkpoint when
one exists, and a device OOM halves the streamed chunk); the distributed
trainer (``distributed.trainer.train_distributed``) reads them too: a
preemption re-meshes and restores, another transient failure retries the
round, and a device OOM doubles its histogram slices.

Action classification lives here (:func:`classify`) so the trainers'
except-clauses stay dispatch tables, not policy decisions.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.resilience.errors import (NumericalDivergenceError, is_oom,
                                           is_transient)


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """What a trainer may do when a round fails.

    checkpoint_dir:    where round checkpoints live (streaming and
                       distributed trainers).
    checkpoint_every:  round cadence of trainer-side checkpoints.
    max_recoveries:    transient-failure budget for the whole fit.
    max_oom_halvings:  how many times an OOM may degrade the round's
                       memory footprint before propagating.
    min_chunk_rows:    streaming degradation floor.
    retry_delay_s:     pause before a replay.
    max_divergence_rollbacks:
                       how many divergence-sentinel trips may roll the
                       fit back to the last finite round before the
                       :class:`NumericalDivergenceError` propagates.
    divergence_backoff:
                       learning-rate multiplier applied when the SAME
                       round diverges on its replay (a one-off divergence
                       replays at the original rate; persistent divergence
                       shrinks the steps).
    """

    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 5
    max_recoveries: int = 3
    max_oom_halvings: int = 3
    min_chunk_rows: int = 256
    retry_delay_s: float = 0.0
    max_divergence_rollbacks: int = 2
    divergence_backoff: float = 0.5

    def __post_init__(self):
        if self.checkpoint_every < 1:
            raise ValueError("checkpoint_every must be >= 1")
        if self.max_recoveries < 0 or self.max_oom_halvings < 0:
            raise ValueError("recovery budgets must be >= 0")
        if self.min_chunk_rows < 1:
            raise ValueError("min_chunk_rows must be >= 1")
        if self.max_divergence_rollbacks < 0:
            raise ValueError("max_divergence_rollbacks must be >= 0")
        if not 0.0 < self.divergence_backoff < 1.0:
            raise ValueError("divergence_backoff must be in (0, 1)")


def classify(exc: BaseException) -> str:
    """``"divergence"`` | ``"oom"`` | ``"transient"`` | ``"fatal"`` —
    the trainers' recovery branches (rollback, degrade, replay,
    propagate)."""
    if isinstance(exc, NumericalDivergenceError):
        return "divergence"
    if is_oom(exc):
        return "oom"
    if is_transient(exc):
        return "transient"
    return "fatal"

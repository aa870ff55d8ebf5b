"""Datasheet peaks of one NVIDIA H100 and the work of each measured step.

Frozen copies of the arithmetic of the port's ``launch/roofline.py``
(the peaks) and ``launch/dryrun_gbdt.py`` (per-level bytes), and of the
smoke's ensemble bound.  Each count is of what the algorithm needs for
the call, from shapes alone, whatever implements it: every input byte
read once and every output byte written once.

Peaks: NVIDIA H100 80GB HBM3 (SXM) datasheet at its full 700 W limit,
3.35 TB/s of HBM3 and 67 TOP/s of float32 (and 32-bit integer) work
outside the tensor cores, which is where GBDT's work runs.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
SPLIT_OPS_PER_BIN = 20      # prefix sums of G and H; the gain both ways
OPS_PER_HOP = 8             # integer operations of one tree-walk hop
GH_OPS = 10                 # operations of one record's g and h a class


class Work(NamedTuple):
    bytes: float
    ops: float

    def __add__(self, other: "Work") -> "Work":
        return Work(self.bytes + other.bytes, self.ops + other.ops)

    @property
    def least_s(self) -> float:
        """The least time the card could take: the larger of the two."""
        return max(self.bytes / HBM_BYTES_PER_S, self.ops / SCALAR_OPS_PER_S)

    @property
    def bound_by(self) -> str:
        return ("bytes" if self.bytes / HBM_BYTES_PER_S
                >= self.ops / SCALAR_OPS_PER_S else "operations")


def histogram_level(n: int, F: int, K: int, nodes: int, n_bins: int) -> Work:
    """Step ① at one level: the (n, F) uint8 codes read once, each class's
    g, h (float32) and node id (int32) read once, the (K, nodes, F, bins,
    2) float32 histogram written once; two adds a record, field and
    class."""
    return Work(n * F + 12 * n * K + 8 * K * nodes * F * n_bins,
                2 * n * F * K)


def split_level(K: int, nodes: int, F: int, n_bins: int) -> Work:
    """Step ② at one level: the histogram read, the decisions written."""
    return Work(8 * K * nodes * F * n_bins + 32 * K * nodes,
                SPLIT_OPS_PER_BIN * K * nodes * F * n_bins)


def partition_level(n: int, K: int) -> Work:
    """Step ③ at one level: each class's node id read and written and one
    split-column code read a record; one comparison."""
    return Work(9 * n * K, n * K)


def round_work(n: int, F: int, K: int, depth: int, n_bins: int) -> Work:
    """One boosting round, steps ①–⑤: g and h from the margins and labels,
    ``depth`` levels of steps ①–③, the leaf sums, and step ⑤ (each
    record's row read once, ``depth`` hops a class, the margin read and
    written)."""
    work = Work(4 * n * K + 4 * n + 8 * n * K, GH_OPS * n * K)
    for level in range(depth):
        nodes = 2 ** level
        work = (work + histogram_level(n, F, K, nodes, n_bins)
                + split_level(K, nodes, F, n_bins)
                + partition_level(n, K))
    work = work + Work(12 * n * K + 8 * K * 2 ** depth, 2 * n * K)
    return work + Work(n * F + 8 * n * K, OPS_PER_HOP * n * K * depth)


def histogram_round(n: int, F: int, K: int, depth: int,
                    n_bins: int) -> Work:
    """Step ① over a round's ``depth`` levels."""
    total = Work(0.0, 0.0)
    for level in range(depth):
        total = total + histogram_level(n, F, K, 2 ** level, n_bins)
    return total


def ensemble(n: int, F: int, T: int, depth: int, K: int = 1) -> Work:
    """Batch inference: the (n, F) codes read once, each tree's node table
    ((2^(D+1) - 1) words of 4 bytes: splits and leaves) once, the (n, K)
    float32 margins written once; ``depth`` hops a record and tree."""
    words = 2 ** (depth + 1) - 1
    return Work(n * F + 4 * n * K + 4 * T * words,
                OPS_PER_HOP * n * T * depth)


def share(work: Work, seconds: float) -> float:
    """``work``'s least time as a percentage of ``seconds``."""
    return 100.0 * work.least_s / seconds


def describe(work: Work) -> Dict[str, float]:
    return {"bytes": work.bytes, "ops": work.ops, "least_s": work.least_s}

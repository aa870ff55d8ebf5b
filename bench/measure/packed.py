"""The work of the measured steps where the codes are 4-bit packed.

``bench.measure.roofline`` counts every bin code as one byte.  Where the
bins fit a nibble (``n_bins <= PACK_MAX_BINS``) the program holds both
copies of the codes two to a byte, so each code that the algorithm reads
is half a byte: step ①'s (n, F) codes at every level, the split column's
code a record and class in step ③, and each record's row in step ⑤.
These functions count those codes at their width and everything else as
``roofline`` counts it, from shapes alone; above 16 bins they return
``roofline``'s counts exactly.
"""
from __future__ import annotations

from bench.measure import roofline
from bench.measure.roofline import Work

PACK_MAX_BINS = 16          # the largest bin count whose codes fit a nibble


def code_bytes(n_bins: int) -> float:
    """Bytes of one bin code: half a byte where ``n_bins`` fits a nibble."""
    return 0.5 if n_bins <= PACK_MAX_BINS else 1.0


def _less(work: Work, codes: float, n_bins: int) -> Work:
    """``work`` with ``codes`` codes that it counted as a byte each counted
    at their width."""
    return Work(work.bytes - codes * (1.0 - code_bytes(n_bins)), work.ops)


def histogram_round(n: int, F: int, K: int, depth: int,
                    n_bins: int) -> Work:
    """Step ① over a round's ``depth`` levels
    (``roofline.histogram_round``), each level's (n, F) codes at their
    width."""
    return _less(roofline.histogram_round(n, F, K, depth, n_bins),
                 depth * n * F, n_bins)


def round_work(n: int, F: int, K: int, depth: int, n_bins: int) -> Work:
    """One boosting round, steps ①–⑤ (``roofline.round_work``): the codes
    of step ① and step ③ at every level and step ⑤'s rows at their
    width."""
    codes = depth * (n * F + n * K) + n * F
    return _less(roofline.round_work(n, F, K, depth, n_bins), codes, n_bins)

"""The least work of step ②, the split search, from shapes alone.

``bench.measure.roofline.split_level`` counts step ② inside a round's
whole work; this count is the one ``split_roofline`` divides by: what
the search of a round's levels has to move, whatever implements it, at
the HBM peak (``roofline.HBM_BYTES_PER_S``).  At each level of a depth-D
tree of K classes: the (K, NN, F, NB, 2) float32 histogram read once;
the eight (K, NN) 4-byte decision arrays (gain, field, bin, categorical
flag, missing direction, the node's G and H, the hessian sent left)
written once; the fold's four (K, NN) 4-byte split-table entries and
its leaves below the level's nodes, (K, 2^D) 4-byte values and 1-byte
flags, written once.
"""
from __future__ import annotations

from bench.measure.roofline import Work

DECISION_BYTES = 8 * 4      # eight 4-byte decision arrays a node
TABLE_BYTES = 4 * 4         # four 4-byte split-table entries a node
BOTTOM_BYTES = 4 + 1        # a bottom slot's value and its flag


def split_level(K: int, nodes: int, F: int, n_bins: int,
                depth: int) -> Work:
    """Step ② at one level of ``nodes`` nodes: bytes only."""
    return Work(8.0 * K * nodes * F * n_bins
                + (DECISION_BYTES + TABLE_BYTES) * K * nodes
                + BOTTOM_BYTES * K * 2 ** depth, 0.0)


def split_round(K: int, F: int, depth: int, n_bins: int) -> Work:
    """Step ② over a round's ``depth`` levels."""
    total = Work(0.0, 0.0)
    for level in range(depth):
        total = total + split_level(K, 2 ** level, F, n_bins, depth)
    return total

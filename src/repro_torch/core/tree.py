"""Tree growing — steps ①–④ of the paper's training algorithm.

The counterpart of :func:`repro.core.tree.fit_tree`: the level-by-level
grower at K = 1 (the body of ``_fit_forest_jit`` for one class).  Every
record carries a level-local node id; one histogram pass per level covers
all of the level's vertices, step ② picks the splits, and the partition
kernel routes the records straight from the column-major copy.  The
result is a fixed-shape ``TreeArrays`` (complete binary tree with
pass-through nodes).

Histogram subtraction, the chunked grower and the lossguide grower are not
ported yet (ROADMAP Queue 1: training variants, out-of-core).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.api.plan import ExecutionPlan, resolve_plan
from repro_torch.core import splits as splits_mod
from repro_torch.kernels import ops
from repro_torch.kernels.ref import TreeArrays


def _gather_fields(codes_cm, idx):
    """Leading-axis (field) gather from the (F, n) column-major copy."""
    return codes_cm[idx.long()]


def fit_tree(codes, codes_cm, g, h, *, depth: int, n_bins: int,
             missing_bin: int, is_cat_field, field_mask,
             lambda_: float, gamma: float, min_child_weight: float,
             plan: Optional[ExecutionPlan] = None) -> TreeArrays:
    """Grow one depth-``depth`` tree level by level.

    codes: (n, F) uint8 row-major (step-① input);
    codes_cm: (F, n) uint8 column-major copy (step-③ input);
    g, h: (n,) float32 gradient statistics on the same device.
    """
    plan = resolve_plan(plan)
    n = codes.shape[0]
    device = codes.device
    n_int, n_leaf = 2 ** depth - 1, 2 ** depth
    i32 = dict(dtype=torch.int32, device=device)
    state = (torch.full((n_int,), -1, **i32),                  # feature
             torch.zeros((n_int,), **i32),                     # threshold
             torch.zeros((n_int,), **i32),                     # is_cat
             torch.zeros((n_int,), **i32),                     # default_left
             torch.zeros((n_leaf,), dtype=torch.float32, device=device),
             torch.zeros((n_leaf,), dtype=torch.bool, device=device))
    node_ids = torch.zeros((n,), **i32)
    for level in range(depth):
        # step ① — one pass bins every vertex of the level
        hist = ops.build_histogram(codes, g, h, node_ids, n_nodes=2 ** level,
                                   n_bins=n_bins, plan=plan)
        # step ② — split decisions + tree-table updates
        state, best, do_split = _decide_level(
            hist, level, depth, state, is_cat_field, field_mask, lambda_,
            gamma, min_child_weight)
        # step ③ — route records to children, reading the chosen fields
        # straight from the column-major copy
        node_ids = ops.partition_level_cm(
            node_ids, codes_cm,
            torch.where(do_split, best.feature, -1).to(torch.int32),
            best.threshold, best.is_cat, best.default_left,
            missing_bin=missing_bin, plan=plan)

    feature, threshold, is_cat, default_left, value_bottom, value_set = state
    value_bottom = _settle_bottom_leaves(g, h, node_ids, value_bottom,
                                         value_set, n_leaf, lambda_)
    return TreeArrays(feature=feature, threshold=threshold, is_cat=is_cat,
                      default_left=default_left, leaf_value=value_bottom)


def _decide_level(hist, level, depth, state, is_cat_field, field_mask,
                  lambda_, gamma, min_child_weight):
    """Step ② for one level: pick splits from the (nn, F, NB, 2) level
    histogram and fold them into the tree-table ``state``."""
    feature, threshold, is_cat, default_left, value_bottom, value_set = state
    nn = hist.shape[0]
    off = nn - 1
    reps = 2 ** (depth - level)

    best = splits_mod.find_best_splits(hist, is_cat_field, field_mask,
                                       lambda_, gamma, min_child_weight)
    resolved = value_set[torch.arange(nn, device=hist.device) * reps]
    do_split = (best.gain > 0.0) & ~resolved

    w = splits_mod.leaf_weight(best.node_g, best.node_h, lambda_)
    newly_leaf = ~do_split & ~resolved
    mask_b = newly_leaf.repeat_interleave(reps)                # (n_leaf,)
    value_bottom = torch.where(mask_b & ~value_set, w.repeat_interleave(reps),
                               value_bottom)
    value_set = value_set | mask_b

    # the node tables belong to the grower's loop: update them in place
    feature[off:off + nn] = torch.where(do_split, best.feature, -1)
    threshold[off:off + nn] = best.threshold
    is_cat[off:off + nn] = best.is_cat
    default_left[off:off + nn] = best.default_left
    state = (feature, threshold, is_cat, default_left, value_bottom,
             value_set)
    return state, best, do_split


def _settle_bottom_leaves(g, h, node_ids, value_bottom, value_set, n_leaf,
                          lambda_):
    """Leaf weights for every bottom slot not settled by an earlier level."""
    idx = node_ids.long()
    zeros = torch.zeros((n_leaf,), dtype=torch.float32, device=g.device)
    Gb = zeros.index_add(0, idx, g.to(torch.float32))
    Hb = zeros.index_add(0, idx, h.to(torch.float32))
    wb = splits_mod.leaf_weight(Gb, Hb, lambda_)
    return torch.where(value_set, value_bottom, wb)

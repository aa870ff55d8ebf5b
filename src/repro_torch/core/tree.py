"""Tree growing — steps ①–④ of the paper's training algorithm.

The counterpart of :func:`repro.core.tree.fit_forest` and ``fit_tree``:
the level-by-level grower, class-batched.  K trees (one per class of a
multi-class objective, K = 1 otherwise) grow level-synchronously over the
same records; every record carries one level-local node id per class.
One histogram launch per level covers every vertex of every class, step ②
picks the splits with the class axis folded into the node axis, and one
partition launch routes every class's records straight from the
column-major copy.  The result is a fixed-shape ``TreeArrays`` (complete
binary tree with pass-through nodes), with a leading (K, ...) axis from
:func:`fit_forest`; :func:`fit_tree` is its K = 1 slice.

Histogram subtraction, the chunked grower and the lossguide grower are not
ported yet (ROADMAP Queue 1: training variants, out-of-core).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.api.plan import ExecutionPlan, resolve_plan
from repro_torch.core import splits as splits_mod
from repro_torch.core.binning import PackedCodes
from repro_torch.kernels import ops
from repro_torch.kernels.ref import TreeArrays


def _gather_fields(codes_cm, idx):
    """Leading-axis (field) gather from the (F, n) column-major copy,
    unpacked.  Packed rows are selected WITHOUT unpacking the full matrix;
    only the gathered rows expand to uint8."""
    rows = codes_cm[idx.long()]
    return rows.unpack() if isinstance(rows, PackedCodes) else rows


def fit_tree(codes, codes_cm, g, h, *, depth: int, n_bins: int,
             missing_bin: int, is_cat_field, field_mask,
             lambda_: float, gamma: float, min_child_weight: float,
             plan: Optional[ExecutionPlan] = None) -> TreeArrays:
    """Grow one depth-``depth`` tree: the K = 1 slice of :func:`fit_forest`.

    codes: (n, F) uint8 row-major (step-① input);
    codes_cm: (F, n) uint8 column-major copy (step-③ input); both may be
    ``PackedCodes``, which steps ① and ③ read as they are;
    g, h: (n,) float32 gradient statistics on the same device.
    """
    forest = fit_forest(codes, codes_cm, g[None], h[None], depth=depth,
                        n_bins=n_bins, missing_bin=missing_bin,
                        is_cat_field=is_cat_field, field_mask=field_mask,
                        lambda_=lambda_, gamma=gamma,
                        min_child_weight=min_child_weight, plan=plan)
    return TreeArrays(*[a[0] for a in forest])


def fit_forest(codes, codes_cm, g, h, *, depth: int, n_bins: int,
               missing_bin: int, is_cat_field, field_mask,
               lambda_: float, gamma: float, min_child_weight: float,
               plan: Optional[ExecutionPlan] = None) -> TreeArrays:
    """Grow K depth-``depth`` trees level-synchronously, one per class,
    over a shared code stream.

    g, h: (K, n) float32 contiguous per-class statistics.  Returns
    TreeArrays with leading (K, ...) axes.
    """
    plan = resolve_plan(plan)
    K, n = g.shape
    device = codes.device
    n_int, n_leaf = 2 ** depth - 1, 2 ** depth
    i32 = dict(dtype=torch.int32, device=device)
    state = (torch.full((K, n_int), -1, **i32),                # feature
             torch.zeros((K, n_int), **i32),                   # threshold
             torch.zeros((K, n_int), **i32),                   # is_cat
             torch.zeros((K, n_int), **i32),                   # default_left
             torch.zeros((K, n_leaf), dtype=torch.float32, device=device),
             torch.zeros((K, n_leaf), dtype=torch.bool, device=device))
    node_ids = torch.zeros((K, n), **i32)          # per-class vertex ids
    for level in range(depth):
        # step ① — one pass bins every vertex of every class
        hist = ops.build_histogram(codes, g, h, node_ids, n_nodes=2 ** level,
                                   n_bins=n_bins, plan=plan)
        # step ② — split decisions + tree-table updates
        state, best, do_split = _decide_level(
            hist, level, depth, state, is_cat_field, field_mask, lambda_,
            gamma, min_child_weight)
        # step ③ — route every class's records to children, reading the
        # chosen fields straight from the column-major copy
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
    """Step ② for one level: pick splits from the (K, nn, F, NB, 2) level
    histogram and fold them into the (K, ...) tree-table ``state``."""
    feature, threshold, is_cat, default_left, value_bottom, value_set = state
    K, nn, F, n_bins, _ = hist.shape
    off = nn - 1
    reps = 2 ** (depth - level)

    # find_best_splits is vectorised over nodes: fold the class axis into
    # the node axis
    flat = splits_mod.find_best_splits(hist.reshape(K * nn, F, n_bins, 2),
                                       is_cat_field, field_mask, lambda_,
                                       gamma, min_child_weight)
    best = splits_mod.SplitDecision(*[a.reshape(K, nn) for a in flat])
    resolved = value_set[:, torch.arange(nn, device=hist.device) * reps]
    do_split = (best.gain > 0.0) & ~resolved

    w = splits_mod.leaf_weight(best.node_g, best.node_h, lambda_)
    newly_leaf = ~do_split & ~resolved
    mask_b = newly_leaf.repeat_interleave(reps, dim=1)         # (K, n_leaf)
    value_bottom = torch.where(mask_b & ~value_set,
                               w.repeat_interleave(reps, dim=1), value_bottom)
    value_set = value_set | mask_b

    # the node tables belong to the grower's loop: update them in place
    feature[:, off:off + nn] = torch.where(do_split, best.feature, -1)
    threshold[:, off:off + nn] = best.threshold
    is_cat[:, off:off + nn] = best.is_cat
    default_left[:, off:off + nn] = best.default_left
    state = (feature, threshold, is_cat, default_left, value_bottom,
             value_set)
    return state, best, do_split


def _settle_bottom_leaves(g, h, node_ids, value_bottom, value_set, n_leaf,
                          lambda_):
    """Leaf weights for every bottom slot not settled by an earlier level;
    g, h, node_ids (K, n), one segment sum per class."""
    K = g.shape[0]
    slot = (node_ids.long()
            + torch.arange(K, device=g.device)[:, None] * n_leaf).reshape(-1)
    zeros = torch.zeros((K * n_leaf,), dtype=torch.float32, device=g.device)
    Gb = zeros.index_add(0, slot, g.reshape(-1).to(torch.float32))
    Hb = zeros.index_add(0, slot, h.reshape(-1).to(torch.float32))
    wb = splits_mod.leaf_weight(Gb, Hb, lambda_).reshape(K, n_leaf)
    return torch.where(value_set, value_bottom, wb)

"""Tree growing — steps ①–④ of the paper's training algorithm.

The counterpart of :mod:`repro.core.tree`'s in-memory growers:

  * :func:`fit_forest` / :func:`fit_tree` — the level-by-level grower,
    class-batched.  K trees (one per class of a multi-class objective,
    K = 1 otherwise) grow level-synchronously over the same records; every
    record carries one level-local node id per class.  One histogram
    launch per level covers every vertex of every class, step ② picks the
    splits with the class axis folded into the node axis (on the card one
    launch of the split-search kernel, which also writes the level into
    the tree tables; on the host under ``plan.host_offload_split``), and
    one partition launch routes every class's records straight from the
    column-major copy.  With ``plan.hist_subtraction``, levels > 0 bin
    only the smaller child of every split parent and derive the sibling as
    ``parent − smaller`` (paper §II-A).  Nothing in the level loop reads
    the host (the host offload apart), so a CUDA graph can capture it.
  * :func:`fit_tree_lossguide` — the vertex-by-vertex (best-first)
    grower: a gain heap on the host, one histogram of the smaller child a
    split on the device, its sibling ``parent − child``.
  * :func:`fit_forest_chunked` — the out-of-core twin of
    :func:`fit_forest`: the same levels over a stream of chunks, one pass a
    level, each chunk's histogram accumulated into the level's and its node
    ids kept chunk by chunk.

Each returns a fixed-shape ``TreeArrays`` (complete binary tree with
pass-through nodes), with a leading (K, ...) axis from :func:`fit_forest`
and :func:`fit_forest_chunked`.
"""
from __future__ import annotations

import heapq
import warnings
from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.api.plan import ExecutionPlan, resolve_plan
from repro_torch.core import splits as splits_mod
from repro_torch.core.binning import PackedCodes
from repro_torch.kernels import histogram as hist_k
from repro_torch.kernels import ops
from repro_torch.kernels import splits as split_kernel
from repro_torch.kernels.ref import TreeArrays


# the level loop's span names (``repro_torch.obs``), made once: steps ①, ②
# and ③ of level L
_HIST_SPANS = tuple(f"tree.hist.{L}" for L in range(32))
_SPLIT_SPANS = tuple(f"tree.split.{L}" for L in range(32))
_PARTITION_SPANS = tuple(f"tree.partition.{L}" for L in range(32))


def _lift_loose_kwargs(plan: Optional[ExecutionPlan],
                       **loose) -> ExecutionPlan:
    """Resolve the growers' plan, lifting any legacy per-step keyword
    (``hist_strategy=`` etc., ``repro``'s Pallas names included) into it
    with a deprecation warning."""
    passed = sorted(k for k, v in loose.items()
                    if v is not None and v != "auto" and v is not False)
    if passed:
        warnings.warn(
            "legacy strategy-string kwargs are deprecated; pass "
            f"plan=ExecutionPlan({', '.join(f'{k}=...' for k in passed)}) "
            "instead", DeprecationWarning, stacklevel=3)
    return resolve_plan(plan, **loose)


def _gather_fields(codes_cm, idx):
    """Leading-axis (field) gather from the (F, n) column-major copy,
    unpacked: from ``PackedCodes`` only the gathered rows expand to
    uint8."""
    if isinstance(codes_cm, PackedCodes):
        return codes_cm[idx].unpack()
    return codes_cm[idx]


def _grid_scale(g, h, plan: ExecutionPlan):
    """The grouped histogram kernel's fixed-point grid of the tree's g and
    h (:func:`repro_torch.kernels.histogram.fixed_point_scale`), computed
    once a tree on the card; None where that kernel does not run."""
    if g.device.type != "cuda" or plan.hist_strategy != "cuda":
        return None
    return hist_k.fixed_point_scale(g, h)


def fit_tree(codes, codes_cm, g, h, *, depth: int, n_bins: int,
             missing_bin: int, is_cat_field, field_mask,
             lambda_: float, gamma: float, min_child_weight: float,
             plan: Optional[ExecutionPlan] = None,
             hist_strategy: Optional[str] = None,
             partition_strategy: Optional[str] = None,
             host_offload_split: Optional[bool] = None) -> TreeArrays:
    """Grow one depth-``depth`` tree: the K = 1 slice of :func:`fit_forest`.

    codes: (n, F) uint8 row-major (step-① input);
    codes_cm: (F, n) uint8 column-major copy (step-③ input); both may be
    ``PackedCodes``, which steps ① and ③ read as they are;
    g, h: (n,) float32 gradient statistics on the same device.  The legacy
    per-step keywords lift into ``plan`` with a ``DeprecationWarning``.
    """
    plan = _lift_loose_kwargs(plan, hist_strategy=hist_strategy,
                              partition_strategy=partition_strategy,
                              host_offload_split=host_offload_split)
    forest = fit_forest(codes, codes_cm, g[None], h[None], depth=depth,
                        n_bins=n_bins, missing_bin=missing_bin,
                        is_cat_field=is_cat_field, field_mask=field_mask,
                        lambda_=lambda_, gamma=gamma,
                        min_child_weight=min_child_weight, plan=plan)
    return TreeArrays(*[a[0] for a in forest])


def fit_forest(codes, codes_cm, g, h, *, depth: int, n_bins: int,
               missing_bin: int, is_cat_field, field_mask,
               lambda_: float, gamma: float, min_child_weight: float,
               plan: Optional[ExecutionPlan] = None,
               hist_strategy: Optional[str] = None,
               partition_strategy: Optional[str] = None,
               host_offload_split: Optional[bool] = None) -> TreeArrays:
    """Grow K depth-``depth`` trees level-synchronously, one per class,
    over a shared code stream.

    g, h: (K, n) float32 contiguous per-class statistics.  Returns
    TreeArrays with leading (K, ...) axes.  The legacy per-step keywords
    lift into ``plan`` with a ``DeprecationWarning``.
    """
    plan = _lift_loose_kwargs(plan, hist_strategy=hist_strategy,
                              partition_strategy=partition_strategy,
                              host_offload_split=host_offload_split)
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
    find = (splits_mod.find_best_splits_host if plan.host_offload_split
            else splits_mod.find_best_splits)
    node_ids = torch.zeros((K, n), **i32)          # per-class vertex ids
    scale = _grid_scale(g, h, plan)
    hist = None
    for level in range(depth):
        nn = 2 ** level
        # step ① — one pass bins every vertex of every class; with
        # plan.hist_subtraction, levels > 0 bin only the smaller child of
        # each parent and derive the sibling from the last level's hist
        with obs.span(_HIST_SPANS[level]):
            if plan.hist_subtraction and level > 0:
                hist = _subtract_level_hist(codes, g, h, node_ids, hist,
                                            n_nodes=nn, n_bins=n_bins,
                                            plan=plan, scale=scale)
            else:
                hist = ops.build_histogram(codes, g, h, node_ids, n_nodes=nn,
                                           n_bins=n_bins, plan=plan,
                                           scale=scale)
        # step ② — split decisions + tree-table updates
        with obs.span(_SPLIT_SPANS[level]):
            state, _, _ = _decide_level(
                hist, level, depth, state, is_cat_field, field_mask, lambda_,
                gamma, min_child_weight, find)
        # step ③ — route every class's records to children, reading the
        # chosen fields straight from the column-major copy; the level's
        # splits are handed over as views of the tree tables, where step ②
        # wrote them (feature -1 where a node does not split)
        off = nn - 1
        with obs.span(_PARTITION_SPANS[level]):
            node_ids = ops.partition_level_cm(
                node_ids, codes_cm,
                *[table[:, off:off + nn] for table in state[:4]],
                missing_bin=missing_bin, plan=plan)

    feature, threshold, is_cat, default_left, value_bottom, value_set = state
    with obs.span("tree.leaves"):
        value_bottom = _settle_bottom_leaves(g, h, node_ids, value_bottom,
                                             value_set, n_leaf, lambda_)
    return TreeArrays(feature=feature, threshold=threshold, is_cat=is_cat,
                      default_left=default_left, leaf_value=value_bottom)


def _decide_level(hist, level, depth, state, is_cat_field, field_mask,
                  lambda_, gamma, min_child_weight,
                  find=splits_mod.find_best_splits):
    """Step ② for one level: pick splits from the (K, nn, F, NB, 2) level
    histogram with ``find`` (on the device, or the host offload) and fold
    them into the (K, ...) tree-table ``state``.

    On the card, with the default ``find``, the search and the fold are
    one launch of the split-search kernel, which updates every table of
    ``state`` in place; elsewhere ``find`` runs and the fold below is plain
    PyTorch (the kernel's specification).  Returns ``(state, best,
    do_split)``: ``best`` the (K, nn) decisions, ``do_split`` (K, nn)."""
    if find is splits_mod.find_best_splits and hist.device.type == "cuda":
        decision, do_split = split_kernel.split_level_cuda(
            hist, is_cat_field, field_mask, lambda_, gamma, min_child_weight,
            tables=state, level=level, depth=depth)
        return state, splits_mod.SplitDecision(*decision), do_split
    feature, threshold, is_cat, default_left, value_bottom, value_set = state
    K, nn, F, n_bins, _ = hist.shape
    off = nn - 1
    reps = 2 ** (depth - level)

    # the split search is vectorised over nodes: fold the class axis into
    # the node axis
    flat = find(hist.reshape(K * nn, F, n_bins, 2), is_cat_field, field_mask,
                lambda_, gamma, min_child_weight)
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


LEAF_SUM_BLOCK = 4096      # records a block-private leaf accumulator sums


def _bottom_sums(g, h, node_ids, n_leaf: int) -> torch.Tensor:
    """(2, K·n_leaf) G and H sums of the bottom slots of (K, n) statistics
    and leaf slots.

    On the CPU one float32 segment sum a class, record by record, as
    ``repro``'s ``segment_sum`` adds on the host (the parity tests hold the
    two bit for bit).  On the card each block of ``LEAF_SUM_BLOCK`` records
    adds into float64 accumulators of its own and the blocks' rows are then
    summed, returned in float64: float32 atomics into one slot run
    record by record and lose about n·2^-24 of a sum whose terms share a
    sign (a round-0 leaf's), which is 1e-3 of a leaf at 10 M records,
    while this holds to float64 rounding in any order of the adds, and
    spreads them over many addresses.  Reads nothing back, so a CUDA graph
    can capture it."""
    K, n = g.shape
    S = K * n_leaf
    dev = g.device
    slot = node_ids.long() + torch.arange(K, device=dev)[:, None] * n_leaf
    stats = torch.stack([g, h]).reshape(2, -1)
    if dev.type == "cpu":
        zeros = torch.zeros((2, S), dtype=torch.float32)
        return zeros.index_add(1, slot.reshape(-1), stats.to(torch.float32))
    block = torch.arange(n, device=dev) // LEAF_SUM_BLOCK
    n_blocks = -(-n // LEAF_SUM_BLOCK)
    acc = torch.zeros((2, n_blocks * S), dtype=torch.float64, device=dev)
    acc.index_add_(1, (block * S + slot).reshape(-1),
                   stats.to(torch.float64))
    return acc.view(2, n_blocks, S).sum(1)


def _settle_bottom_leaves(g, h, node_ids, value_bottom, value_set, n_leaf,
                          lambda_):
    """Leaf weights for every bottom slot not settled by an earlier level;
    g, h, node_ids (K, n), the slots' sums by :func:`_bottom_sums`."""
    K = g.shape[0]
    Gb, Hb = _bottom_sums(g, h, node_ids, n_leaf).to(torch.float32)
    wb = splits_mod.leaf_weight(Gb, Hb, lambda_).reshape(K, n_leaf)
    return torch.where(value_set, value_bottom, wb)


# --------------------------------------------------------------------------
# histogram subtraction (paper §II-A) for the level-wise grower
# --------------------------------------------------------------------------
def _child_is_smaller(smaller_is_left):
    """(K, NN/2) per-parent 'left child is smaller' -> (K, NN) per-child
    'this node is the smaller sibling' (children of parent p sit at slots
    2p / 2p+1)."""
    sil2 = smaller_is_left.repeat_interleave(2, dim=1)          # (K, NN)
    left_slot = (torch.arange(sil2.shape[1], device=sil2.device) % 2) == 0
    return torch.where(left_slot[None, :], sil2, ~sil2)


def _combine_sibling_hist(parent_hist, small, is_small):
    """The level histogram from the smaller children's: ``hist[c] =
    small[c]`` where c is the smaller sibling, else ``parent[c // 2] −
    small[sibling(c)]`` (no explicit binning at the other child).  Exact in
    real arithmetic; in float32 the derived sibling reassociates the
    parent's sum."""
    K, nn, F, NB, S = small.shape
    sib = small.reshape(K, nn // 2, 2, F, NB, S).flip(2)
    derived = parent_hist.repeat_interleave(2, dim=1) - sib.reshape(
        small.shape)
    return torch.where(is_small[:, :, None, None, None], small, derived)


def _compact_selected(codes, g, h, nid, sel, n_half: int):
    """Pack the ``sel``-marked records into a fixed (n_half, ...) buffer.

    ``n_half = n // 2`` always fits: summed over parents, ``min(left,
    right) <= (left + right) / 2``, so the smaller children hold at most
    ``n // 2`` records (selection is by record count, which is what
    guarantees the bound).  Positions come from a cumulative sum and a
    binary search in it, so nothing reads the host.  Slots past the
    selected count are padding with zero statistics (adding exactly +0.0)
    and node 0.
    """
    n = codes.shape[0]
    # slot j takes the (j + 1)-th selected record: the first position where
    # the running count of selected records reaches j + 1 (n past the last)
    idx = torch.searchsorted(torch.cumsum(sel, 0),
                             torch.arange(1, n_half + 1, device=g.device))
    valid = idx < n
    take = torch.where(valid, idx, 0)
    return (codes[take],
            torch.where(valid, g[take], 0.0),
            torch.where(valid, h[take], 0.0),
            torch.where(valid, nid[take], 0))


def _node_counts(nid, n_nodes: int):
    """(K, n_nodes) records a node of (K, n) node ids, exact (float64): a
    histogram over the (class, node) slots, which sums a block's records
    in shared memory first, where a scatter-add of ones into so few slots
    would serialize on their addresses."""
    K = nid.shape[0]
    slot = nid + torch.arange(K, device=nid.device)[:, None] * n_nodes
    return torch.histc(slot.to(torch.float64), bins=K * n_nodes, min=0,
                       max=K * n_nodes).reshape(K, n_nodes)


def _subtract_level_hist(codes, g, h, node_ids, parent_hist, *,
                         n_nodes: int, n_bins: int, plan: ExecutionPlan,
                         scale=None):
    """Step ① for one level (> 0) by smaller-child subtraction.

    Bins only the records that landed in the smaller child of each split
    parent and derives every sibling as ``parent − smaller``.  Per-node
    record counts come from an on-device scatter-add of the freshly
    partitioned node ids (:func:`_node_counts`; no host read in the level
    loop).

    Class handling, as ``repro``'s: the class-batched CUDA kernels
    (``"cuda"``, ``"cuda_packed"``) read the codes once for all K classes,
    so at K > 1 they keep one class-batched launch with the bigger child's
    statistics masked to zero (the counterpart of ``repro``'s Pallas
    route); everywhere else each class's smaller-child records are
    compacted into an ``n // 2`` buffer and binned by one launch a class,
    half the record stream each.  ``scale``: the tree's (K, 2)
    fixed-point grid of g and h, which also holds their masked copies.
    """
    K, n = g.shape
    nid = node_ids.long()
    counts = _node_counts(nid, n_nodes)
    smaller_is_left = counts[:, 0::2] <= counts[:, 1::2]       # (K, NN/2)
    is_small = _child_is_smaller(smaller_is_left)              # (K, NN)
    sel = torch.gather(is_small, 1, nid)                       # (K, n)
    if K > 1 and plan.hist_strategy in ("cuda", "cuda_packed"):
        w = sel.to(torch.float32)
        small = ops.build_histogram(codes, g * w, h * w, node_ids,
                                    n_nodes=n_nodes, n_bins=n_bins, plan=plan,
                                    scale=scale)
        return _combine_sibling_hist(parent_hist, small, is_small)
    n_half = max(1, n // 2)
    smalls = []
    for k in range(K):
        ck, gk, hk, nk = _compact_selected(codes, g[k], h[k], node_ids[k],
                                           sel[k], n_half)
        smalls.append(ops.build_histogram(
            ck, gk, hk, nk, n_nodes=n_nodes, n_bins=n_bins, plan=plan,
            scale=None if scale is None else scale[k]))
    return _combine_sibling_hist(parent_hist, torch.stack(smalls), is_small)


# --------------------------------------------------------------------------
# out-of-core grower: chunk-accumulated histograms, chunk-local node ids
# --------------------------------------------------------------------------
def _column_major(codes):
    """A chunk's (F, rows) column-major copy, chunk-local: the paper's
    redundant representation kept to one chunk's footprint; a packed chunk
    gives a packed copy."""
    if isinstance(codes, PackedCodes):
        return PackedCodes.pack(codes.unpack().T)
    return codes.T.contiguous()


def _partition_chunk(codes, node_ids, feature, threshold, is_cat,
                     default_left, *, missing_bin: int,
                     plan: ExecutionPlan) -> torch.Tensor:
    """Step ③ for one chunk: route its (K, rows) node ids through one
    level's (K, NN) split tables, read from the chunk's column-major copy.
    ``feature`` holds -1 where a node does not split, which is ``repro``'s
    ``do_split`` mask."""
    return ops.partition_level_cm(node_ids, _column_major(codes), feature,
                                  threshold, is_cat, default_left,
                                  missing_bin=missing_bin, plan=plan)


def fit_forest_chunked(chunks, g, h, *, depth: int, n_bins: int,
                       missing_bin: int, is_cat_field, field_mask,
                       lambda_: float, gamma: float, min_child_weight: float,
                       plan: Optional[ExecutionPlan] = None):
    """Out-of-core twin of :func:`fit_forest`: the same math over chunked
    scans.

    ``chunks`` is a zero-argument callable returning a fresh iterator of
    ``(lo, hi, codes)``: ``codes`` a (rows, F) uint8 chunk, or
    ``PackedCodes`` of the same logical rows, on the grower's device, whose
    first ``hi - lo`` rows are records ``lo:hi``;
    the rest are padding, given zero statistics and node 0, so each adds
    exactly +0.0.  One pass a level (the histogram, with the previous
    level's partition applied to each chunk first) and one final partition
    pass: ``depth + 1`` passes a tree.

    g, h: (K, n) float32 per-class statistics on the host (numpy or CPU
    tensors).  The per-record state stays there, as in ``repro``: on the
    card g, h and the (K, n) int32 node ids live in pinned memory, each
    chunk's slice is uploaded, and its routed node ids are written back,
    by non-blocking copies on the current stream, so stream order keeps a
    level's write-back ahead of the next level's upload and the host never
    waits.  ``is_cat_field`` and ``field_mask`` lie on the grower's device.
    With ``plan.hist_subtraction``, levels > 0 give the bigger child's
    records zero statistics (the histogram stays class-batched) and derive
    each sibling as ``parent − smaller``, the smaller child picked by the
    hessian mass each decision routed left.

    Returns ``(TreeArrays with (K, ...) axes, node_ids)``: ``node_ids`` the
    (K, n) int32 final leaf slots on the device, from which the trainer
    updates the margins without another pass.  The leaves settle over all
    n records at once, as ``repro`` settles them.
    """
    plan = resolve_plan(plan).without_chunking()
    device = is_cat_field.device
    cuda = device.type == "cuda"
    g = torch.as_tensor(g, dtype=torch.float32)
    h = torch.as_tensor(h, dtype=torch.float32)
    if cuda:
        g = g if g.is_pinned() else g.pin_memory()
        h = h if h.is_pinned() else h.pin_memory()
    K, n = g.shape
    F = int(is_cat_field.shape[0])
    n_int, n_leaf = 2 ** depth - 1, 2 ** depth
    i32 = dict(dtype=torch.int32, device=device)
    state = (torch.full((K, n_int), -1, **i32),                # feature
             torch.zeros((K, n_int), **i32),                   # threshold
             torch.zeros((K, n_int), **i32),                   # is_cat
             torch.zeros((K, n_int), **i32),                   # default_left
             torch.zeros((K, n_leaf), dtype=torch.float32, device=device),
             torch.zeros((K, n_leaf), dtype=torch.bool, device=device))
    node_ids = torch.zeros((K, n), dtype=torch.int32, pin_memory=cuda)
    find = (splits_mod.find_best_splits_host if plan.host_offload_split
            else splits_mod.find_best_splits)
    pending = None                # the previous level's split tables

    def upload(a, lo, hi, rows):
        """(K, rows) slice of a host array on the device, zero-padded (pad
        rows carry zero statistics and node 0)."""
        out = torch.empty((K, rows), dtype=a.dtype, device=device)
        for k in range(K):      # contiguous rows: asynchronous copies
            out[k, :hi - lo].copy_(a[k, lo:hi], non_blocking=True)
        out[:, hi - lo:].zero_()
        return out

    def apply_pending(codes, lo, hi, rows):
        nid = upload(node_ids, lo, hi, rows)
        if pending is None:
            return nid
        nid = _partition_chunk(codes, nid, *pending, missing_bin=missing_bin,
                               plan=plan)
        for k in range(K):
            node_ids[k, lo:hi].copy_(nid[k, :hi - lo], non_blocking=True)
        return nid

    use_sub = bool(plan.hist_subtraction)
    prev_hist = None
    smaller_is_left = None            # (K, nn) hessian-based, per level
    for level in range(depth):
        nn = 2 ** level
        sub_level = use_sub and level > 0
        is_small = _child_is_smaller(smaller_is_left) if sub_level else None
        hist = torch.zeros((K, nn, F, n_bins, 2), dtype=torch.float32,
                           device=device)
        for lo, hi, codes in chunks():
            rows = codes.shape[0]
            nid = apply_pending(codes, lo, hi, rows)
            gc, hc = upload(g, lo, hi, rows), upload(h, lo, hi, rows)
            if sub_level:
                w = torch.gather(is_small, 1, nid.long()).to(torch.float32)
                gc, hc = gc * w, hc * w
            hist = ops.accumulate_histogram(hist, codes, gc, hc, nid,
                                            n_nodes=nn, n_bins=n_bins,
                                            plan=plan)
        if sub_level:
            hist = _combine_sibling_hist(prev_hist, hist, is_small)
        prev_hist = hist
        state, best, do_split = _decide_level(
            hist, level, depth, state, is_cat_field, field_mask, lambda_,
            gamma, min_child_weight, find)
        smaller_is_left = torch.where(do_split,
                                      2.0 * best.left_h <= best.node_h,
                                      False)
        off = nn - 1
        pending = tuple(table[:, off:off + nn] for table in state[:4])

    for lo, hi, codes in chunks():        # final pass: the last partition
        apply_pending(codes, lo, hi, codes.shape[0])

    feature, threshold, is_cat, default_left, value_bottom, value_set = state
    ids = node_ids.to(device, non_blocking=True)
    value_bottom = _settle_bottom_leaves(
        g.to(device, non_blocking=True), h.to(device, non_blocking=True),
        ids, value_bottom, value_set, n_leaf, lambda_)
    tree = TreeArrays(feature=feature, threshold=threshold, is_cat=is_cat,
                      default_left=default_left, leaf_value=value_bottom)
    return tree, ids


# --------------------------------------------------------------------------
# vertex-by-vertex (best-first) grower with the smaller-child subtraction
# --------------------------------------------------------------------------
def fit_tree_lossguide(codes, codes_cm, g, h, *, depth: int, n_bins: int,
                       missing_bin: int, is_cat_field, field_mask,
                       lambda_: float, gamma: float, min_child_weight: float,
                       max_leaves: Optional[int] = None,
                       plan: Optional[ExecutionPlan] = None,
                       hist_strategy: Optional[str] = None) -> TreeArrays:
    """Best-first growth to at most ``max_leaves`` leaves (all 2^depth slots
    when None); bins only the smaller child per split (§II-A).

    The gain heap runs on the host, ties broken by push order; each node's
    histogram is one launch at ``n_nodes=1`` over statistics masked to the
    node's records, and each split's search reads its decision back (one
    host read a node).  The split's predicate column is read from the
    column-major copy (one packed row unpacked for ``PackedCodes``).
    """
    plan = _lift_loose_kwargs(plan, hist_strategy=hist_strategy)
    n, F = codes.shape
    device = g.device
    n_int = 2 ** depth - 1
    n_leaf_slots = 2 ** depth
    max_leaves = max_leaves or n_leaf_slots
    g = g.to(torch.float32)
    h = h.to(torch.float32)

    feature = np.full((n_int,), -1, np.int32)
    threshold = np.zeros((n_int,), np.int32)
    is_cat_a = np.zeros((n_int,), np.int32)
    default_left = np.zeros((n_int,), np.int32)
    value_bottom = np.zeros((n_leaf_slots,), np.float32)
    root_nodes = torch.zeros((n,), dtype=torch.int32, device=device)
    scale = _grid_scale(g, h, plan)     # holds every mask of g, h

    def hist_of(mask):
        return ops.build_histogram(codes, g * mask, h * mask, root_nodes,
                                   n_nodes=1, n_bins=n_bins, plan=plan,
                                   scale=scale)[0]              # (F, NB, 2)

    def best_of(hist):
        d = splits_mod.find_best_splits(hist[None], is_cat_field, field_mask,
                                        lambda_, gamma, min_child_weight)
        # one host read of the decision; field ids and codes are exact in
        # float32
        gain, f, t, c, dl, G, H, HL = torch.stack(
            [a[0].to(torch.float32) for a in d]).cpu().tolist()
        return gain, int(f), int(t), int(c), int(dl), G, H, HL

    heap = []
    counter = 0  # tie-break: deterministic heap order

    def push(pos, level, hist, mask):
        nonlocal counter
        gain, f, t, c, dl, G, H, HL = best_of(hist)
        heapq.heappush(heap, (-gain, counter,
                              dict(pos=pos, level=level, hist=hist, mask=mask,
                                   f=f, t=t, c=c, dl=dl, G=G, H=H, HL=HL,
                                   gain=gain)))
        counter += 1

    def settle_leaf(e):
        reps = 2 ** (depth - e["level"])
        base = e["pos"] - (2 ** e["level"] - 1)
        w = -e["G"] / (e["H"] + lambda_)
        value_bottom[base * reps:(base + 1) * reps] = w

    root_mask = torch.ones((n,), dtype=torch.float32, device=device)
    push(0, 0, hist_of(root_mask), root_mask)
    n_leaves = 1
    while heap and n_leaves < max_leaves:
        _, _, e = heapq.heappop(heap)
        if e["gain"] <= 0.0 or e["level"] >= depth:
            settle_leaf(e)
            continue
        pos, lvl = e["pos"], e["level"]
        feature[pos], threshold[pos] = e["f"], e["t"]
        is_cat_a[pos], default_left[pos] = e["c"], e["dl"]

        # step ③ — one predicate, one column from the column-major copy
        col = _gather_fields(codes_cm, e["f"]).to(torch.int32)
        left = (col == e["t"]) if e["c"] == 1 else (col <= e["t"])
        miss = col == missing_bin
        left = (left | miss) if e["dl"] == 1 else (left & ~miss)
        mask_l = e["mask"] * left.to(torch.float32)
        mask_r = e["mask"] - mask_l

        # step ① for the children: bin only the smaller one (by the
        # hessian mass the decision routed left, already on the host); its
        # sibling is parent − child
        hl = e["HL"]
        hr = e["H"] - e["HL"]
        if hl <= hr:
            hist_small = hist_of(mask_l)
            hist_l, hist_r = hist_small, e["hist"] - hist_small
        else:
            hist_small = hist_of(mask_r)
            hist_l, hist_r = e["hist"] - hist_small, hist_small

        push(2 * pos + 1, lvl + 1, hist_l, mask_l)
        push(2 * pos + 2, lvl + 1, hist_r, mask_r)
        n_leaves += 1

    while heap:  # settle everything left on the heap as leaves
        _, _, e = heapq.heappop(heap)
        settle_leaf(e)

    return TreeArrays(*[torch.from_numpy(a).to(device) for a in (
        feature, threshold, is_cat_a, default_left, value_bottom)])

"""Tree growing — steps ①–④ of the paper's training algorithm.

The counterpart of :mod:`repro.core.tree`'s in-memory growers:

  * :func:`grow_levels` — the level-by-level grower, class-batched.  K
    trees (one per class of a multi-class objective, K = 1 otherwise) grow
    level-synchronously over the same records; every record carries one
    level-local node id per class.  One histogram of every vertex of
    every class a level (step ①), step ② picks the splits with the class
    axis folded into the node axis (on the card one launch of the
    split-search kernel, which also writes the level into the tree
    tables; on the host under ``plan.host_offload_split``), and step ③
    routes every class's records.  Levels > 0 may bin only the smaller
    child of every parent and derive the sibling as ``parent − smaller``
    (paper §II-A): on the card's grouped kernel the resident layout always
    does, exactly, in int64 (bit-equal to the direct pass); elsewhere, in
    float32, under ``plan.hist_subtraction``.  Where the records lie
    is the loop's one variable: :func:`fit_forest` / :func:`fit_tree` hold
    them on the device (:class:`ResidentRecords`: one histogram and one
    partition launch a level; nothing reads the host, the host offload
    apart, so a CUDA graph can capture the loop), :func:`fit_forest_chunked`
    streams them as chunks, one pass a level (:class:`ChunkedRecords`),
    and ``distributed.sharding.ShardedRecords`` spreads them over a mesh's
    data shards, one histogram sum a level.

  * :func:`fit_tree_lossguide` — the vertex-by-vertex (best-first)
    grower: a gain heap on the host, one histogram of the smaller child a
    split on the device, its sibling ``parent − child``.

Each returns a fixed-shape ``TreeArrays`` (complete binary tree with
pass-through nodes), with a leading (K, ...) axis from :func:`grow_levels`,
:func:`fit_forest` and :func:`fit_forest_chunked`.
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


def tree_tables(K: int, depth: int, device):
    """The (K, ...) tables a depth-``depth`` tree grows into, a level at a
    time (:func:`decide_level`): split feature (-1 where a node does not
    split), threshold, is_cat and default_left of the 2^depth − 1
    internal nodes, then the value of each of the 2^depth bottom slots and
    whether a level has settled it."""
    n_int, n_leaf = 2 ** depth - 1, 2 ** depth
    i32 = dict(dtype=torch.int32, device=device)
    return (torch.full((K, n_int), -1, **i32),                 # feature
            torch.zeros((K, n_int), **i32),                    # threshold
            torch.zeros((K, n_int), **i32),                    # is_cat
            torch.zeros((K, n_int), **i32),                    # default_left
            torch.zeros((K, n_leaf), dtype=torch.float32, device=device),
            torch.zeros((K, n_leaf), dtype=torch.bool, device=device))


def fixed_point_grid(parts, plan: ExecutionPlan):
    """The grouped histogram kernel's fixed-point grid of a tree's g and h
    (:func:`repro_torch.kernels.histogram.fixed_point_scale`), once a tree
    on the card: the finest that holds every (g, h) pair of ``parts`` (one
    in memory, one a shard), on the first's device; None off that kernel."""
    g0 = parts[0][0]
    if g0.device.type != "cuda" or plan.hist_strategy != "cuda":
        return None
    if len(parts) == 1:
        return hist_k.fixed_point_scale(*parts[0])
    return torch.stack([hist_k.fixed_point_scale(g, h).to(g0.device)
                        for g, h in parts]).amin(0)


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
    over a shared code stream held on the device
    (:class:`ResidentRecords`).

    g, h: (K, n) float32 contiguous per-class statistics.  Returns
    TreeArrays with leading (K, ...) axes.  The legacy per-step keywords
    lift into ``plan`` with a ``DeprecationWarning``.
    """
    plan = _lift_loose_kwargs(plan, hist_strategy=hist_strategy,
                              partition_strategy=partition_strategy,
                              host_offload_split=host_offload_split)
    records = ResidentRecords(codes, codes_cm, g, h, n_bins=n_bins,
                              missing_bin=missing_bin, plan=plan)
    return grow_levels(records, depth=depth, is_cat_field=is_cat_field,
                       field_mask=field_mask, lambda_=lambda_, gamma=gamma,
                       min_child_weight=min_child_weight)


def grow_levels(records, *, depth: int, is_cat_field, field_mask,
                lambda_: float, gamma: float,
                min_child_weight: float) -> TreeArrays:
    """The depthwise grower: K depth-``depth`` trees, a level at a time,
    over ``records``, a record layout (:class:`ResidentRecords`,
    :class:`ChunkedRecords`, ``distributed.sharding.ShardedRecords``).

    A layout holds the records, their (K, ·) statistics and node ids
    (``node_ids``, the final leaf slots after the last level) and gives
    ``K``, the kernels' ``plan``, the ``device`` of the tables and step ②,
    ``derives_siblings`` (its step ① derives every level > 0 from the last
    exactly itself, so ``plan.hist_subtraction`` changes nothing), and
    four steps: ``histogram(n_nodes, is_small=None)``, step ①, the
    (K, n_nodes, F, n_bins, 2) level histogram on ``device``, with
    ``is_small`` that of the marked children only; ``smaller_is_left
    (n_nodes)``, the (K, n_nodes / 2) choice of the child to bin
    (:func:`subtract_level_hist`); ``partition(tables, best, do_split)``,
    step ③ through the level's (K, n_nodes) split tables (views of the
    tree tables, feature -1 where a node does not split) and decision;
    ``bottom_sums(n_leaf)``, the (2, K·n_leaf) G and H sums of the bottom
    slots.  Returns TreeArrays with leading (K, ...) axes on ``device``.
    """
    plan = records.plan
    state = tree_tables(records.K, depth, records.device)
    find = (splits_mod.find_best_splits_host if plan.host_offload_split
            else splits_mod.find_best_splits)
    hist = None
    for level in range(depth):
        nn = 2 ** level
        # step ① — one pass bins every vertex of every class; with
        # plan.hist_subtraction, levels > 0 bin only the smaller child of
        # each parent and derive the sibling from the last level's hist
        # (which a layout that derives siblings itself always does)
        with obs.span(_HIST_SPANS[level]):
            if plan.hist_subtraction and level > 0:
                hist = subtract_level_hist(records, hist, nn)
            else:
                hist = records.histogram(nn)
        # step ② — split decisions + tree-table updates
        with obs.span(_SPLIT_SPANS[level]):
            state, best, do_split = decide_level(
                hist, level, depth, state, is_cat_field, field_mask, lambda_,
                gamma, min_child_weight, find)
        # step ③ — the level's splits handed over as views of the tree
        # tables, where step ② wrote them
        off = nn - 1
        with obs.span(_PARTITION_SPANS[level]):
            records.partition([table[:, off:off + nn] for table in state[:4]],
                              best, do_split)
    with obs.span("tree.leaves"):
        return settle_leaves(state, records.bottom_sums(2 ** depth), lambda_)


def decide_level(hist, level, depth, state, is_cat_field, field_mask,
                 lambda_, gamma, min_child_weight,
                 find=splits_mod.find_best_splits):
    """Step ② for one level: pick splits from the (K, nn, F, NB, 2) level
    histogram with ``find`` (on the device, or the host offload) and fold
    them into the (K, ...) tree-table ``state`` (:func:`tree_tables`).

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


def bottom_sums(g, h, node_ids, n_leaf: int) -> torch.Tensor:
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


def settle_leaves(state, sums, lambda_: float) -> TreeArrays:
    """The grown (K, ...) tree from its tables ``state``
    (:func:`tree_tables`): every bottom slot that no level settled takes
    its leaf weight from ``sums``, the (2, K·n_leaf) G and H sums of the
    bottom slots (:func:`bottom_sums`, or the shards' sum of theirs)."""
    feature, threshold, is_cat, default_left, value_bottom, value_set = state
    Gb, Hb = sums.to(torch.float32)
    wb = splits_mod.leaf_weight(Gb, Hb, lambda_).reshape(value_set.shape)
    return TreeArrays(feature=feature, threshold=threshold, is_cat=is_cat,
                      default_left=default_left,
                      leaf_value=torch.where(value_set, value_bottom, wb))


# the fit-end counters of the splits grown (``repro_torch.obs``): all of
# them, the categorical ones ("code == t"), and those that send the
# missing bin left
SPLIT_COUNTERS = ("tree.splits", "tree.splits_categorical",
                  "tree.splits_default_left")


def record_splits(trees: TreeArrays) -> None:
    """Add a fit's splits, from its stacked tree tables, to the
    ``SPLIT_COUNTERS``, once a fit, after its last round: the three
    tables are copied to the host and counted there, so the device runs
    no kernel for it."""
    feature, is_cat, default_left = (
        t.cpu() for t in (trees.feature, trees.is_cat, trees.default_left))
    split = feature >= 0
    for name, n in zip(SPLIT_COUNTERS, (split, split & (is_cat != 0),
                                        split & (default_left != 0))):
        obs.record(name, int(n.sum()))


# --------------------------------------------------------------------------
# histogram subtraction (paper §II-A) for the level-wise grower
# --------------------------------------------------------------------------
def subtract_level_hist(records, parent_hist, n_nodes: int):
    """Step ① for one level (> 0) by smaller-child subtraction: the layout
    ``records`` (:func:`grow_levels`) bins only the child of each split
    parent that its own rule calls the smaller, and every sibling is
    derived as ``parent − smaller`` from the last level's histogram
    ``parent_hist``.  A layout that ``derives_siblings`` (the resident one
    on the card) builds the level itself, from its last level's int64
    sums: exact, so ``parent_hist`` is not read."""
    if records.derives_siblings:
        return records.histogram(n_nodes)
    is_small = _child_is_smaller(records.smaller_is_left(n_nodes))
    return _combine_sibling_hist(
        parent_hist, records.histogram(n_nodes, is_small), is_small)


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


def node_counts(nid, n_nodes: int):
    """(K, n_nodes) records a node of (K, n) node ids (int32 or int64),
    exact (float64): a histogram over the (class, node) slots, which sums
    a block's records in shared memory first, where a scatter-add of ones
    into so few slots would serialize on their addresses."""
    K = nid.shape[0]
    slot = nid + torch.arange(K, device=nid.device)[:, None] * n_nodes
    return torch.histc(slot.to(torch.float64), bins=K * n_nodes, min=0,
                       max=K * n_nodes).reshape(K, n_nodes)


# --------------------------------------------------------------------------
# the record layouts of this module
# --------------------------------------------------------------------------
class ResidentRecords:
    """Every record on the grower's device: the layout of
    :func:`fit_forest` (see :func:`grow_levels`), its arguments as it
    takes them.

    On the card's grouped kernel (``hist_strategy="cuda"``) step ① bins on
    the tree's fixed-point grid (:func:`fixed_point_grid`) and keeps the
    int64 sums of the level it built; once step ③ has routed that level's
    records, the next level comes by exact subtraction
    (``kernels/histogram.histogram_level_cuda`` given those sums as the
    parent's: only each parent's smaller child binned, its sibling derived
    in int64), bit-equal to the direct pass, so ``derives_siblings`` holds
    and ``plan.hist_subtraction`` changes nothing there.  Each such level
    adds one to the ``hist.levels_subtracted`` counter (``repro_torch.obs``)
    as the host enqueues it.

    Elsewhere subtraction is ``plan.hist_subtraction``'s, in float32, and
    the smaller child has fewer records (:func:`node_counts`).  As in
    ``repro``, the class-batched routes ``"cuda"`` (the CPU's plain
    version) and ``"cuda_packed"`` read the codes once for all K classes,
    so at K > 1 they keep one call with the bigger child's statistics
    masked to zero (``repro``'s Pallas route); everywhere else each class's
    smaller-child records are compacted into an ``n // 2`` buffer and
    binned by one call a class.
    """

    def __init__(self, codes, codes_cm, g, h, *, n_bins: int,
                 missing_bin: int, plan: ExecutionPlan):
        self.codes, self.codes_cm, self.g, self.h = codes, codes_cm, g, h
        self.n_bins, self.missing_bin, self.plan = n_bins, missing_bin, plan
        self.K = g.shape[0]
        self.device = codes.device
        self.node_ids = torch.zeros(g.shape, dtype=torch.int32,
                                    device=self.device)
        self.scale = fixed_point_grid([(g, h)], plan)
        self.derives_siblings = self.scale is not None
        # the int64 sums of the last level built, the node ids they were
        # built over, and the ids step ③ routed from those: the next
        # level's, whose parent sums they are
        self._sums = self._sums_of = self._routed = None

    def histogram(self, n_nodes: int, is_small=None):
        if self.derives_siblings:
            return self._level(n_nodes)
        kw = dict(n_nodes=n_nodes, n_bins=self.n_bins, plan=self.plan)
        if is_small is None:
            return ops.build_histogram(self.codes, self.g, self.h,
                                       self.node_ids, **kw)
        sel = torch.gather(is_small, 1, self.node_ids.long())      # (K, n)
        if self.K > 1 and self.plan.hist_strategy in ("cuda", "cuda_packed"):
            w = sel.to(torch.float32)
            return ops.build_histogram(self.codes, self.g * w, self.h * w,
                                       self.node_ids, **kw)
        n_half = max(1, self.g.shape[1] // 2)
        return torch.stack([ops.build_histogram(
            *_compact_selected(self.codes, self.g[k], self.h[k],
                               self.node_ids[k], sel[k], n_half), **kw)
            for k in range(self.K)])

    def _level(self, n_nodes: int):
        """Step ① on the card: by exact subtraction from the parent sums
        where the node ids are their level's after step ③, else (level 0,
        or node ids set from outside) directly; the level's sums kept."""
        parent = self._sums if self._routed is self.node_ids else None
        hist, self._sums = hist_k.histogram_level_cuda(
            self.codes, self.g, self.h, self.node_ids, n_nodes=n_nodes,
            n_bins=self.n_bins, scale=self.scale, parent=parent)
        self._sums_of, self._routed = self.node_ids, None
        if parent is not None:
            obs.record("hist.levels_subtracted")
        return hist

    def smaller_is_left(self, n_nodes: int):
        counts = node_counts(self.node_ids, n_nodes)
        return counts[:, 0::2] <= counts[:, 1::2]

    def partition(self, tables, best, do_split):
        routed = self._sums_of is self.node_ids
        self.node_ids = ops.partition_level_cm(
            self.node_ids, self.codes_cm, *tables,
            missing_bin=self.missing_bin, plan=self.plan)
        self._sums_of, self._routed = None, self.node_ids if routed else None

    def bottom_sums(self, n_leaf: int):
        self._sums = self._routed = None       # no level follows the last
        return bottom_sums(self.g, self.h, self.node_ids, n_leaf)


def _column_major(codes):
    """A chunk's (F, rows) column-major copy, chunk-local: the paper's
    redundant representation kept to one chunk's footprint; a packed chunk
    gives a packed copy."""
    if isinstance(codes, PackedCodes):
        return PackedCodes.pack(codes.unpack().T)
    return codes.T.contiguous()


class ChunkedRecords:
    """Records streamed as chunks, their state on the host: the layout of
    :func:`fit_forest_chunked`, whose passes it makes (see
    :func:`grow_levels`).

    ``chunks``, g, h: as :func:`fit_forest_chunked` takes them;
    ``n_fields`` the chunks' F, ``device`` the grower's.  Step ③ only
    records the level's tables as pending, for the next pass to apply to
    each chunk first; ``node_ids`` ends as the (K, n) final leaf slots on
    the device.
    """
    derives_siblings = False

    def __init__(self, chunks, g, h, *, n_fields: int, n_bins: int,
                 missing_bin: int, plan: ExecutionPlan, device):
        cuda = device.type == "cuda"
        g = torch.as_tensor(g, dtype=torch.float32)
        h = torch.as_tensor(h, dtype=torch.float32)
        if cuda:
            g = g if g.is_pinned() else g.pin_memory()
            h = h if h.is_pinned() else h.pin_memory()
        self.chunks, self.g, self.h = chunks, g, h
        self.n_fields, self.n_bins, self.missing_bin = (n_fields, n_bins,
                                                        missing_bin)
        self.plan, self.device = plan, device
        self.K = g.shape[0]
        self.node_ids = torch.zeros(g.shape, dtype=torch.int32,
                                    pin_memory=cuda)
        self._pending = None          # the last level's split tables
        self._decision = None         # and its (best, do_split)

    def _upload(self, a, lo, hi, rows):
        """(K, rows) slice of a host array on the device, zero-padded (pad
        rows carry zero statistics and node 0)."""
        out = torch.empty((self.K, rows), dtype=a.dtype, device=self.device)
        for k in range(self.K):      # contiguous rows: asynchronous copies
            out[k, :hi - lo].copy_(a[k, lo:hi], non_blocking=True)
        out[:, hi - lo:].zero_()
        return out

    def route(self, codes, node_ids):
        """Step ③ for one chunk: its (K, rows) node ids through the pending
        level's (K, NN) split tables, read from the chunk's column-major
        copy."""
        return ops.partition_level_cm(node_ids, _column_major(codes),
                                      *self._pending,
                                      missing_bin=self.missing_bin,
                                      plan=self.plan)

    def _apply_pending(self, codes, lo, hi):
        nid = self._upload(self.node_ids, lo, hi, codes.shape[0])
        if self._pending is None:
            return nid
        nid = self.route(codes, nid)
        for k in range(self.K):
            self.node_ids[k, lo:hi].copy_(nid[k, :hi - lo], non_blocking=True)
        return nid

    def histogram(self, n_nodes: int, is_small=None):
        hist = torch.zeros((self.K, n_nodes, self.n_fields, self.n_bins, 2),
                           dtype=torch.float32, device=self.device)
        for lo, hi, codes in self.chunks():
            rows = codes.shape[0]
            nid = self._apply_pending(codes, lo, hi)
            gc = self._upload(self.g, lo, hi, rows)
            hc = self._upload(self.h, lo, hi, rows)
            if is_small is not None:
                w = torch.gather(is_small, 1, nid.long()).to(torch.float32)
                gc, hc = gc * w, hc * w
            hist = ops.accumulate_histogram(hist, codes, gc, hc, nid,
                                            n_nodes=n_nodes,
                                            n_bins=self.n_bins,
                                            plan=self.plan)
        self._pending = None
        return hist

    def smaller_is_left(self, n_nodes: int):
        best, do_split = self._decision
        return torch.where(do_split, 2.0 * best.left_h <= best.node_h, False)

    def partition(self, tables, best, do_split):
        self._pending, self._decision = tables, (best, do_split)

    def bottom_sums(self, n_leaf: int):
        for lo, hi, codes in self.chunks():   # the last level's partition
            self._apply_pending(codes, lo, hi)
        self.node_ids = self.node_ids.to(self.device, non_blocking=True)
        return bottom_sums(self.g.to(self.device, non_blocking=True),
                           self.h.to(self.device, non_blocking=True),
                           self.node_ids, n_leaf)


def fit_forest_chunked(chunks, g, h, *, depth: int, n_bins: int,
                       missing_bin: int, is_cat_field, field_mask,
                       lambda_: float, gamma: float, min_child_weight: float,
                       plan: Optional[ExecutionPlan] = None):
    """Out-of-core twin of :func:`fit_forest`: the same math over chunked
    scans (:class:`ChunkedRecords`).

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
    records = ChunkedRecords(chunks, g, h, n_fields=int(is_cat_field.shape[0]),
                             n_bins=n_bins, missing_bin=missing_bin,
                             plan=plan, device=is_cat_field.device)
    tree = grow_levels(records, depth=depth, is_cat_field=is_cat_field,
                       field_mask=field_mask, lambda_=lambda_, gamma=gamma,
                       min_child_weight=min_child_weight)
    return tree, records.node_ids


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
    scale = fixed_point_grid([(g, h)], plan)  # holds every mask of g, h

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

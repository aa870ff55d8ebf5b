"""Plain PyTorch versions of every kernel in this package.

The counterparts of :mod:`repro.kernels.ref`.  They are the ground truth
the CUDA kernels are held against, and the code that runs for tensors on
the CPU:

  * ``histogram_ref``            — step ① histogram binning (one class
                                   or class-batched)
  * ``partition_ref``            — step ③ single-predicate evaluation
  * ``partition_cm_ref``         — step ③ read from the column-major copy
                                   (one class or class-batched)
  * ``traverse_ref``             — step ⑤ one-tree traversal
  * ``traverse_forest_ref``      — step ⑤ for one round's K class trees
  * ``predict_ensemble_batched`` — batch inference over a stacked ensemble

The class-batched versions compute what ``jax.vmap`` over the class axis
computes in the JAX package, one class after another.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


class TreeArrays(NamedTuple):
    """Fixed-shape complete-binary-tree table (depth ``D``).

    ``feature`` is -1 for pass-through nodes (a leaf decided above them);
    children are implicit: 2i+1 / 2i+2.
    """

    feature: Tensor       # (2**D - 1,) int32; -1 == pass-through
    threshold: Tensor     # (2**D - 1,) int32 bin code
    is_cat: Tensor        # (2**D - 1,) int32 {0,1}; ==1: go left iff code == thr
    default_left: Tensor  # (2**D - 1,) int32 {0,1}; missing-value direction
    leaf_value: Tensor    # (2**D,) float32 values at the bottom level

    @property
    def depth(self) -> int:
        return int(self.leaf_value.shape[-1]).bit_length() - 1


# --------------------------------------------------------------------------
# step ① — histogram binning
# --------------------------------------------------------------------------
def histogram_ref(codes: Tensor, g: Tensor, h: Tensor, node_ids: Tensor,
                  n_nodes: int, n_bins: int) -> Tensor:
    """Scatter-add: hist[node, f, bin] += (g, h).

    codes: (n, F) uint; g, h: (n,); node_ids: (n,) int32 in [0, n_nodes).
    Returns (n_nodes, F, n_bins, 2) float32.  Class-batched: g, h and
    node_ids (K, n), every class with its own node partition over the
    shared codes; returns (K, n_nodes, F, n_bins, 2).
    """
    if g.ndim == 2:
        return torch.stack([histogram_ref(codes, g[k], h[k], node_ids[k],
                                          n_nodes, n_bins)
                            for k in range(g.shape[0])])
    n, F = codes.shape
    stats = torch.stack([g, h], dim=-1).to(torch.float32)          # (n, 2)
    comb = node_ids.long()[:, None] * n_bins + codes.long()         # (n, F)
    slot = torch.arange(F, device=codes.device) * (n_nodes * n_bins) + comb
    hist = torch.zeros((F * n_nodes * n_bins, 2), dtype=torch.float32,
                       device=codes.device)
    hist.index_add_(0, slot.reshape(-1),
                    stats[:, None, :].expand(n, F, 2).reshape(-1, 2))
    return hist.reshape(F, n_nodes, n_bins, 2).permute(1, 0, 2, 3).contiguous()


def _decide_go_left(code: Tensor, feature: Tensor, threshold: Tensor,
                    is_cat: Tensor, default_left: Tensor,
                    missing_bin: int) -> Tensor:
    """Shared predicate semantics (paper Fig 2/3 + missing-bin handling)."""
    go_left = torch.where(is_cat == 1, code == threshold, code <= threshold)
    go_left = torch.where(code == missing_bin, default_left == 1, go_left)
    return torch.where(feature < 0, True, go_left)


# --------------------------------------------------------------------------
# step ③ — single-predicate evaluation (one level of partitioning)
# --------------------------------------------------------------------------
def partition_ref(node_ids: Tensor, codes_lvl: Tensor, split_feature: Tensor,
                  split_threshold: Tensor, split_is_cat: Tensor,
                  split_default_left: Tensor, missing_bin: int) -> Tensor:
    """Route each record to its child given the level's chosen splits.

    node_ids: (n,) level-local node index in [0, NN).
    codes_lvl: (n, C) per-level field columns; split_feature indexes
        [0, C), or is -1 for non-splitting nodes (records go left).
    Returns new (n,) int32 node ids in [0, 2*NN).
    """
    idx = node_ids.long()
    f = split_feature[idx]
    code = torch.gather(codes_lvl, 1,
                        f.clamp(min=0).long()[:, None])[:, 0].to(torch.int32)
    go_left = _decide_go_left(code, f, split_threshold[idx],
                              split_is_cat[idx], split_default_left[idx],
                              missing_bin)
    return (2 * node_ids + (1 - go_left.to(torch.int32))).to(torch.int32)


def partition_cm_ref(node_ids: Tensor, codes_cm: Tensor, split_feature: Tensor,
                     split_threshold: Tensor, split_is_cat: Tensor,
                     split_default_left: Tensor, missing_bin: int) -> Tensor:
    """Step ③ as the grower runs it: gather the level's split columns from
    the (F, n) column-major copy (``split_feature`` holds global field
    ids, -1 = pass-through), renumber the splits onto them and route with
    :func:`partition_ref`.

    Class-batched: node_ids (K, n) and split tables (K, NN) give (K, n).
    """
    if node_ids.ndim == 2:
        return torch.stack([partition_cm_ref(
            node_ids[k], codes_cm, split_feature[k], split_threshold[k],
            split_is_cat[k], split_default_left[k], missing_bin)
            for k in range(node_ids.shape[0])])
    nn = split_feature.shape[0]
    codes_lvl = codes_cm[split_feature.clamp(min=0).long()].T      # (n, NN)
    renum = torch.where(split_feature >= 0,
                        torch.arange(nn, dtype=torch.int32,
                                     device=split_feature.device), -1)
    return partition_ref(node_ids, codes_lvl, renum, split_threshold,
                         split_is_cat, split_default_left, missing_bin)


# --------------------------------------------------------------------------
# step ⑤ — one-tree traversal and batch inference
# --------------------------------------------------------------------------
def traverse_ref(tree: TreeArrays, codes: Tensor, missing_bin: int) -> Tensor:
    """Walk every record through one tree; returns (n,) leaf values.

    codes: (n, C) — columns indexed by ``tree.feature``.
    """
    n = codes.shape[0]
    depth = tree.depth
    codes = codes.to(torch.int32)
    node = torch.zeros((n,), dtype=torch.long, device=codes.device)
    for _ in range(depth):
        f = tree.feature[node]
        code = torch.gather(codes, 1, f.clamp(min=0).long()[:, None])[:, 0]
        go_left = _decide_go_left(code, f, tree.threshold[node],
                                  tree.is_cat[node], tree.default_left[node],
                                  missing_bin)
        node = 2 * node + 2 - go_left.long()
    return tree.leaf_value[node - (2 ** depth - 1)]


def traverse_forest_ref(forest: TreeArrays, codes: Tensor,
                        missing_bin: int) -> Tensor:
    """One round's K class trees (stacked (K, ...)) over the same records;
    returns (n, K) leaf values.

    codes: (n, C) shared by every class, or (K, n, C) with class k's
    columns (the renumbered-column fetch gathers per class).
    """
    return torch.stack([traverse_ref(TreeArrays(*[a[k] for a in forest]),
                                     codes[k] if codes.ndim == 3 else codes,
                                     missing_bin)
                        for k in range(forest.feature.shape[0])], dim=1)


def predict_ensemble_batched(trees: TreeArrays, codes: Tensor,
                             missing_bin: int, n_classes: int = 1) -> Tensor:
    """Tree-batched batch inference: all trees advance one level per pass
    over an (n, T) node matrix; returns the (n,) sum over the T trees, or
    (n, K) class margins when ``n_classes`` = K > 1 (trees round-major:
    tree t feeds column t % K through a (T, K) one-hot fold).

    ``trees`` holds stacked arrays with a leading tree dimension (T, ...).
    Node paths and leaf choices are those of ``traverse_ref`` tree by tree;
    only the float order of the final sum differs.
    """
    T = trees.feature.shape[0]
    depth = int(trees.leaf_value.shape[-1]).bit_length() - 1
    codes = codes.to(torch.int32)
    feat_t, thr_t = trees.feature.T, trees.threshold.T          # (N_int, T)
    cat_t, dl_t = trees.is_cat.T, trees.default_left.T
    node = torch.zeros((codes.shape[0], T), dtype=torch.long,
                       device=codes.device)
    for _ in range(depth):
        f = torch.gather(feat_t, 0, node)                           # (n, T)
        code = torch.gather(codes, 1, f.clamp(min=0).long())
        go_left = _decide_go_left(code, f, torch.gather(thr_t, 0, node),
                                  torch.gather(cat_t, 0, node),
                                  torch.gather(dl_t, 0, node), missing_bin)
        node = 2 * node + 2 - go_left.long()
    vals = torch.gather(trees.leaf_value.T, 0, node - (2 ** depth - 1))
    if n_classes == 1:
        return vals.sum(dim=1)
    cls_oh = torch.nn.functional.one_hot(
        torch.arange(T, device=codes.device) % n_classes, n_classes)
    return vals @ cls_oh.to(torch.float32)

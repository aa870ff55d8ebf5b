"""Dispatch over the CUDA kernels and their plain PyTorch versions.

The counterparts of :mod:`repro.kernels.ops`.  Each entry reads its step's
strategy from an :class:`~repro_torch.api.plan.ExecutionPlan`:
``"reference"`` calls the plain version, ``"cuda"`` (what ``"auto"``
resolves to) calls the kernel's wrapper, which launches the kernel for CUDA
tensors — or raises — and takes the plain version for CPU tensors.  There
is no fallback from a kernel that fails.

4-bit :class:`~repro_torch.core.binning.PackedCodes` go straight to the
kernels that read them (the nibble histogram and the nibble column-major
partition); every other consumer unpacks first, as ``repro.kernels.ops``
does outside its Pallas kernels.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.api.plan import ExecutionPlan, resolve_plan
from repro_torch.core.binning import PackedCodes, as_unpacked
from repro_torch.kernels import histogram as _hist_k
from repro_torch.kernels import partition as _part_k
from repro_torch.kernels import traversal as _trav_k
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.ref import TreeArrays

__all__ = ["pack_codes", "unpack_codes", "build_histogram",
           "partition_level", "partition_level_cm", "traverse_tree",
           "traverse_forest", "predict_ensemble"]


def pack_codes(codes) -> PackedCodes:
    """(..., n) codes <= 15 -> 4-bit ``PackedCodes``, on their device;
    wider codes lose bits, so callers gate on the bin count."""
    return PackedCodes.pack(codes)


def unpack_codes(codes) -> torch.Tensor:
    """``PackedCodes`` -> plain uint8; a plain tensor passes through."""
    return as_unpacked(codes)


def build_histogram(codes, g, h, node_ids, *, n_nodes: int, n_bins: int,
                    plan: Optional[ExecutionPlan] = None) -> torch.Tensor:
    """(n, F) codes -> (n_nodes, F, n_bins, 2) float32 histogram.

    Class-batched form: g, h and node_ids (K, n) — every class has its own
    node partition over the shared codes — give (K, n_nodes, F, n_bins, 2)
    from one launch.  ``PackedCodes`` feed the nibble kernel under
    ``"cuda"``; ``"cuda_packed"`` (the naive-packing ablation) and
    ``"reference"`` unpack them first.
    """
    strategy = resolve_plan(plan).hist_strategy
    if strategy == "reference":
        return _ref.histogram_ref(unpack_codes(codes), g, h, node_ids,
                                  n_nodes, n_bins)
    if strategy == "cuda_packed":
        return _hist_k.histogram_naive_cuda(unpack_codes(codes), g, h,
                                            node_ids, n_nodes=n_nodes,
                                            n_bins=n_bins)
    return _hist_k.histogram_cuda(codes, g, h, node_ids, n_nodes=n_nodes,
                                  n_bins=n_bins)


def partition_level(node_ids, codes_lvl, split_feature, split_threshold,
                    split_is_cat, split_default_left, *, missing_bin: int,
                    plan: Optional[ExecutionPlan] = None) -> torch.Tensor:
    """Step ③ over the level's gathered columns ``codes_lvl`` (n, C)."""
    codes_lvl = unpack_codes(codes_lvl)
    if resolve_plan(plan).partition_strategy == "reference":
        return _ref.partition_ref(node_ids, codes_lvl, split_feature,
                                  split_threshold, split_is_cat,
                                  split_default_left, missing_bin)
    return _part_k.partition_cuda(node_ids, codes_lvl, split_feature,
                                  split_threshold, split_is_cat,
                                  split_default_left, missing_bin=missing_bin)


def partition_level_cm(node_ids, codes_cm, split_feature, split_threshold,
                       split_is_cat, split_default_left, *, missing_bin: int,
                       plan: Optional[ExecutionPlan] = None) -> torch.Tensor:
    """Step ③ reading the (F, n) column-major copy directly — a packed copy
    through the nibble entry; split_feature holds global field ids (-1 =
    pass-through).  Class-batched: node_ids (K, n) and split tables (K, NN)
    give (K, n) in one launch."""
    if resolve_plan(plan).partition_strategy == "reference":
        return _part_k.partition_cm_plain(node_ids, codes_cm, split_feature,
                                          split_threshold, split_is_cat,
                                          split_default_left, missing_bin)
    return _part_k.partition_cm_cuda(node_ids, codes_cm, split_feature,
                                     split_threshold, split_is_cat,
                                     split_default_left,
                                     missing_bin=missing_bin)


def traverse_tree(tree: TreeArrays, codes, *, missing_bin: int,
                  plan: Optional[ExecutionPlan] = None) -> torch.Tensor:
    codes = unpack_codes(codes)
    if resolve_plan(plan).traversal_strategy == "reference":
        return _ref.traverse_ref(tree, codes, missing_bin)
    return _trav_k.traverse_cuda(tree, codes, missing_bin=missing_bin)


def traverse_forest(forest: TreeArrays, codes, *, missing_bin: int,
                    plan: Optional[ExecutionPlan] = None) -> torch.Tensor:
    """Step ⑤ for one round's K class trees (stacked (K, ...)) -> (n, K);
    codes (n, C) shared by every class or (K, n, C) per class."""
    codes = unpack_codes(codes)
    if resolve_plan(plan).traversal_strategy == "reference":
        return _ref.traverse_forest_ref(forest, codes, missing_bin)
    return _trav_k.traverse_forest_cuda(forest, codes,
                                        missing_bin=missing_bin)


def predict_ensemble(trees: TreeArrays, codes, *, missing_bin: int,
                     depth: int, plan: Optional[ExecutionPlan] = None,
                     n_classes: int = 1) -> torch.Tensor:
    """Ensemble margins: (n,) for scalar objectives, (n, K) when
    ``n_classes`` = K > 1 (trees round-major, tree t feeds class t % K)."""
    if trees.leaf_value.shape[-1] != 2 ** depth:
        raise ValueError(f"trees are not of depth {depth}")
    codes = unpack_codes(codes)
    if resolve_plan(plan).traversal_strategy == "reference":
        return _trav_k.predict_ensemble_plain(trees, codes, missing_bin,
                                              n_classes)
    return _trav_k.predict_ensemble_cuda(trees, codes,
                                         missing_bin=missing_bin,
                                         n_classes=n_classes)

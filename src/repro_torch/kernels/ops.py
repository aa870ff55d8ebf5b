"""Dispatch over the CUDA kernels and their plain PyTorch versions.

The counterparts of :mod:`repro.kernels.ops`.  Each entry reads its step's
strategy from an :class:`~repro_torch.api.plan.ExecutionPlan`:
``"reference"`` calls the plain version, ``"cuda"`` (what ``"auto"``
resolves to) calls the kernel's wrapper, which launches the kernel for CUDA
tensors — or raises — and takes the plain version for CPU tensors.  There
is no fallback from a kernel that fails: where ``repro`` demotes a failed
Pallas launch to its jnp twin and counts the demotion, the port raises, so
:func:`degradation_stats` is always empty.  It is kept, with
:func:`reset_degradation_stats`, so that callers read the same keys from
both packages.

4-bit :class:`~repro_torch.core.binning.PackedCodes` go straight to the
kernels, which read them in place (the nibble histogram, the nibble
column-major partition and the traversal kernel's nibble entry); the
``"reference"`` strategy, the naive-packing histogram and the row-layout
partition unpack first, as ``repro.kernels.ops`` does outside its Pallas
kernels.

Step ① also runs ``repro``'s software strategies, as plain PyTorch
baselines that run only where a plan names them: ``"scatter"`` (one shared
scatter-add), ``"scatter_private"`` (32 replica histograms, then their
sum: the GPU privatization of paper §II-D), ``"sort"`` (sort by key, then
a segment sum per field) and ``"onehot"`` (blocked one-hot contraction).
Each takes a class axis by a loop over the classes, as ``repro`` vmaps.
Batch inference also takes ``"scan"``, the one-tree-at-a-time baseline.

:func:`onehot_matmul` is ``repro``'s generic one-hot contraction (a jnp
product there, not a Pallas kernel), as plain PyTorch.
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
           "accumulate_histogram", "partition_level", "partition_level_cm",
           "traverse_tree", "traverse_forest", "predict_ensemble",
           "onehot_matmul", "degradation_stats", "reset_degradation_stats"]


def degradation_stats() -> dict:
    """``{"step:strategy->fallback": count}`` of the kernel demotions this
    process took: always ``{}``, since no kernel falls back."""
    return {}


def reset_degradation_stats() -> dict:
    """Zero the demotion counters and return their values before: ``{}``."""
    return {}


def pack_codes(codes) -> PackedCodes:
    """(..., n) codes <= 15 -> 4-bit ``PackedCodes``, on their device;
    wider codes lose bits, so callers gate on the bin count."""
    return PackedCodes.pack(codes)


def unpack_codes(codes) -> torch.Tensor:
    """``PackedCodes`` -> plain uint8; a plain tensor passes through."""
    return as_unpacked(codes)


def _hist_scatter_private(codes, g, h, node_ids, n_nodes: int, n_bins: int,
                          n_private: int = 32):
    """Privatization: ``n_private`` replica histograms over interleaved
    record blocks, then their sum (paper §II-D)."""
    n, F = codes.shape
    pad = -n % n_private
    codes = torch.nn.functional.pad(codes, (0, 0, 0, pad))
    g, h, node_ids = (torch.nn.functional.pad(a, (0, pad))
                      for a in (g, h, node_ids))
    per = [_ref.histogram_ref(c, gg, hh, nn, n_nodes, n_bins)
           for c, gg, hh, nn in zip(codes.reshape(n_private, -1, F),
                                    g.reshape(n_private, -1),
                                    h.reshape(n_private, -1),
                                    node_ids.reshape(n_private, -1))]
    return torch.stack(per).sum(dim=0)


def _hist_sort(codes, g, h, node_ids, n_nodes: int, n_bins: int):
    """Sort by (node, code) key, then a segment sum per field."""
    F = codes.shape[1]
    stats = torch.stack([g, h], dim=-1).to(torch.float32)
    out = torch.zeros((F, n_nodes * n_bins, 2), dtype=torch.float32,
                      device=codes.device)
    for f in range(F):
        comb = node_ids.long() * n_bins + codes[:, f].long()
        order = torch.argsort(comb, stable=True)
        out[f].index_add_(0, comb[order], stats[order])
    return out.reshape(F, n_nodes, n_bins, 2).permute(1, 0, 2, 3) \
        .contiguous()


def _hist_onehot(codes, g, h, node_ids, n_nodes: int, n_bins: int,
                 chunk: int = 2048, fblk: int = 8):
    """Blocked one-hot contraction: per chunk of records and block of
    fields, one-hot codes contracted with the one-hot node's statistics."""
    n, F = codes.shape
    pad = -n % chunk
    codes = torch.nn.functional.pad(codes, (0, -F % fblk, 0, pad))
    g, h, node_ids = (torch.nn.functional.pad(a, (0, pad))
                      for a in (g, h, node_ids))
    stats = torch.stack([g, h], dim=-1).to(torch.float32)
    Fp = codes.shape[1]
    acc = torch.zeros((Fp, n_bins, n_nodes * 2), dtype=torch.float32,
                      device=codes.device)
    onehot = torch.nn.functional.one_hot
    for lo in range(0, codes.shape[0], chunk):
        s = stats[lo:lo + chunk]
        oh_node = onehot(node_ids[lo:lo + chunk].long(), n_nodes).float()
        sn = (oh_node[:, :, None] * s[:, None, :]).reshape(-1, n_nodes * 2)
        for f0 in range(0, Fp, fblk):
            oh_bin = onehot(codes[lo:lo + chunk, f0:f0 + fblk].long(),
                            n_bins).float()
            acc[f0:f0 + fblk] += torch.einsum("nfb,ns->fbs", oh_bin, sn)
    hist = acc[:F].reshape(F, n_bins, n_nodes, 2)
    return hist.permute(2, 0, 1, 3).contiguous()


_PLAIN_HIST = {"scatter": _ref.histogram_ref,
               "scatter_private": _hist_scatter_private,
               "sort": _hist_sort, "onehot": _hist_onehot}


def build_histogram(codes, g, h, node_ids, *, n_nodes: int, n_bins: int,
                    plan: Optional[ExecutionPlan] = None,
                    scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n, F) codes -> (n_nodes, F, n_bins, 2) float32 histogram.

    Class-batched form: g, h and node_ids (K, n) — every class has its own
    node partition over the shared codes — give (K, n_nodes, F, n_bins, 2)
    from one launch.  ``PackedCodes`` feed the nibble kernel under
    ``"cuda"``; every other strategy unpacks them first.  ``scale``: the
    grouped kernel's fixed-point grid
    (:func:`repro_torch.kernels.histogram.fixed_point_scale`), which no
    other strategy reads; the kernel computes it when None.
    """
    strategy = resolve_plan(plan).hist_strategy
    if strategy == "reference":
        return _ref.histogram_ref(unpack_codes(codes), g, h, node_ids,
                                  n_nodes, n_bins)
    if strategy == "cuda_packed":
        return _hist_k.histogram_naive_cuda(unpack_codes(codes), g, h,
                                            node_ids, n_nodes=n_nodes,
                                            n_bins=n_bins)
    if strategy in _PLAIN_HIST:
        fn, codes = _PLAIN_HIST[strategy], unpack_codes(codes)
        if g.ndim == 2:
            return torch.stack([fn(codes, g[k], h[k], node_ids[k], n_nodes,
                                   n_bins) for k in range(g.shape[0])])
        return fn(codes, g, h, node_ids, n_nodes, n_bins)
    return _hist_k.histogram_cuda(codes, g, h, node_ids, n_nodes=n_nodes,
                                  n_bins=n_bins, scale=scale)


def accumulate_histogram(hist, codes, g, h, node_ids, *, n_nodes: int,
                         n_bins: int,
                         plan: Optional[ExecutionPlan] = None
                         ) -> torch.Tensor:
    """Chunked step ①: ``hist += build_histogram(chunk)``, in place into
    the resident accumulator (``repro`` donates it into its jit), which is
    returned.  A zero-statistic padded record adds exactly +0.0, so padded
    chunks keep bit-equality with the whole histogram."""
    return hist.add_(build_histogram(codes, g, h, node_ids, n_nodes=n_nodes,
                                     n_bins=n_bins, plan=plan))


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
    forest = TreeArrays(*[a[None] for a in tree])
    return traverse_forest(forest, codes, missing_bin=missing_bin,
                           plan=plan)[:, 0]


def traverse_forest(forest: TreeArrays, codes, *, missing_bin: int,
                    plan: Optional[ExecutionPlan] = None, margins=None,
                    check_fields: bool = True) -> torch.Tensor:
    """Step ⑤ for one round's K class trees (stacked (K, ...)) -> (n, K);
    codes (n, C), packed or not, shared by every class, or (K, n, C) per
    class (plain versions only).  Given ``margins`` ((n, K), or (n,) at
    K = 1) the leaves are added into them in place, which is returned.
    ``check_fields=False`` skips the kernel's device->host field check, for
    trees the grower made."""
    # "scan" only changes batch inference: a single walk is the plain one
    if resolve_plan(plan).traversal_strategy in ("reference", "scan"):
        delta = _ref.traverse_forest_ref(forest, unpack_codes(codes),
                                         missing_bin)
        return delta if margins is None \
            else margins.add_(delta.reshape(margins.shape))
    return _trav_k.traverse_forest_cuda(forest, codes,
                                        missing_bin=missing_bin,
                                        margins=margins,
                                        check_fields=check_fields)


def predict_ensemble(trees: TreeArrays, codes, *, missing_bin: int,
                     depth: int, plan: Optional[ExecutionPlan] = None,
                     n_classes: int = 1, out=None) -> torch.Tensor:
    """Ensemble margins: (n,) for scalar objectives, (n, K) when
    ``n_classes`` = K > 1 (trees round-major, tree t feeds class t % K);
    ``"scan"`` walks one tree at a time.  Given ``out`` ((n, K), or (n,)
    at K = 1), each record's leaves are added onto what it holds, in tree
    order, and it is returned."""
    if trees.leaf_value.shape[-1] != 2 ** depth:
        raise ValueError(f"trees are not of depth {depth}")
    strategy = resolve_plan(plan).traversal_strategy
    if strategy == "scan":
        return _ref.predict_ensemble_ref(trees, unpack_codes(codes),
                                         missing_bin, n_classes, out=out)
    if strategy == "reference":
        return _trav_k.predict_ensemble_plain(trees, unpack_codes(codes),
                                              missing_bin, n_classes,
                                              out=out)
    return _trav_k.predict_ensemble_cuda(trees, codes,
                                         missing_bin=missing_bin,
                                         n_classes=n_classes, out=out)


def onehot_matmul(idx: torch.Tensor, values: torch.Tensor,
                  width: int) -> torch.Tensor:
    """out[j] = sum_{i : idx[i] == j} values[i] as a dense one-hot product
    accumulated in float32.

    idx: (n,) int; values: (n, ...) -> (width, ...) float32.  An index
    outside [0, width) selects no row, as ``jax.nn.one_hot`` gives it a
    zero row."""
    oh = idx[:, None] == torch.arange(width, device=idx.device)
    flat = values.reshape(values.shape[0], -1)
    out = oh.float().T @ flat.float()
    return out.reshape((width,) + tuple(values.shape[1:]))

"""Step ⑤ traversal and batch inference kernels (``csrc/traversal.cu``).

Replace ``src/repro/kernels/traversal.py::_traverse_kernel`` (one tree,
and one round's K class trees, which the TPU build vmaps over classes)
and ``::_ensemble_kernel`` (the ensemble sum, with its class route at
K > 1).

Nodes are packed into one int32 word each (:func:`pack_node_table`), and a
tree's table and leaves sit in shared memory; one thread walks one record
D hops down with implicit children.

  * :func:`traverse_forest_cuda` — K class trees over the same records in
    one launch, the class a grid axis; (n, K) out.  :func:`traverse_cuda`
    is its K = 1 case.  Bound by bytes (each record's code row in, K
    floats out).
  * :func:`predict_ensemble_cuda` — bound by operations: n·T·D dependent
    hops against one pass over the codes.  Trees are staged in shared
    memory a block at a time and leaves sum in a register in tree order,
    class by class (tree t feeds margin column t % K), so the sum matches
    :func:`predict_ensemble_plain` to float tolerance while the leaf each
    tree picks is identical.

Decisions are integer-exact: :func:`traverse_forest_cuda` is bit-equal to
:func:`traverse_forest_plain`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (TreeArrays, predict_ensemble_batched,
                                     traverse_forest_ref as
                                     traverse_forest_plain,
                                     traverse_ref as traverse_plain)

THREADS = 256
TREE_SMEM = 48 * 1024        # shared memory for one block of staged trees
PLAIN_ROWS = 1 << 18         # records per pass of the plain ensemble walk
MAX_FIELDS = 1 << 15         # field ids must fit the packed node word


def pack_node_table(tree: TreeArrays) -> torch.Tensor:
    """(..., N_int) int32 packed node words
    ``((feature+1) << 16) | (threshold << 8) | (is_cat << 1) | default_left``."""
    return (((tree.feature.to(torch.int32) + 1) << 16)
            | (tree.threshold.to(torch.int32) << 8)
            | (tree.is_cat.to(torch.int32) << 1)
            | tree.default_left.to(torch.int32))


def predict_ensemble_plain(trees: TreeArrays, codes: torch.Tensor,
                           missing_bin: int,
                           n_classes: int = 1) -> torch.Tensor:
    """Plain version of the ensemble walk: :func:`predict_ensemble_batched`
    over blocks of ``PLAIN_ROWS`` records, which bounds its (rows, T) node
    matrices.  (n,) out, or (n, K) for ``n_classes`` = K > 1."""
    parts = [predict_ensemble_batched(trees, codes[lo:lo + PLAIN_ROWS],
                                      missing_bin, n_classes)
             for lo in range(0, codes.shape[0], PLAIN_ROWS)]
    if not parts:
        shape = (0,) if n_classes == 1 else (0, n_classes)
        return torch.zeros(shape, dtype=torch.float32, device=codes.device)
    return torch.cat(parts)


def _check(tables, leaves, codes, what: str) -> int:
    """Validate the kernel's inputs; returns the tree depth."""
    if codes.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {codes.device}")
    if codes.dtype != torch.uint8 or codes.ndim not in (2, 3) \
            or not codes.is_contiguous():
        raise ValueError(f"{what}: codes must be a contiguous (n, C) or "
                         "(K, n, C) uint8 tensor")
    depth = int(leaves.shape[-1]).bit_length() - 1
    if not 1 <= depth <= 10 or leaves.shape[-1] != 1 << depth \
            or tables.shape[-1] != (1 << depth) - 1:
        raise ValueError(f"{what}: tree tables are not a complete tree of "
                         "depth 1..10")
    if tables.device != codes.device or leaves.device != codes.device:
        raise ValueError(f"{what}: trees must lie on {codes.device}")
    C = codes.shape[-1]
    if C >= MAX_FIELDS:
        raise ValueError(f"{what}: {C} code columns do not fit the packed "
                         f"node word (< {MAX_FIELDS})")
    # one small device->host read: a field id past the code row would read
    # out of bounds in the kernel
    top = int(((tables >> 16) - 1).max()) if tables.numel() else -1
    if top >= C:
        raise ValueError(f"{what}: a tree splits on field {top} but codes "
                         f"have {C} columns")
    return depth


def traverse_forest_cuda(forest: TreeArrays, codes: torch.Tensor, *,
                         missing_bin: int) -> torch.Tensor:
    """One round's K class trees, stacked (K, ...), in one launch.

    codes: (n, C) shared by every class, or (K, n, C) with class k's
    columns; C matches the trees' field ids.  Returns (n, K) float32 leaf
    values.
    """
    if codes.device.type == "cpu":
        return traverse_forest_plain(forest, codes, missing_bin)
    tables = pack_node_table(forest).contiguous()
    leaves = forest.leaf_value.to(torch.float32).contiguous()
    if tables.ndim != 2:
        raise ValueError("traverse_forest: trees must be stacked (K, ...)")
    depth = _check(tables, leaves, codes, "traversal")
    K = tables.shape[0]
    n, C = codes.shape[-2:]
    if codes.ndim == 3 and codes.shape[0] != K:
        raise ValueError(f"traversal: codes hold {codes.shape[0]} class "
                         f"blocks for {K} trees")
    if not 1 <= K <= 65535:
        raise ValueError(f"traversal: {K} trees outside [1, 65535]")
    out = torch.empty((n, K), dtype=torch.float32, device=codes.device)
    if n == 0:
        return out
    class_stride = n * C if codes.ndim == 3 else 0
    P, I, I64 = _build.POINTER, _build.INT, _build.INT64
    fn = _build.function("traversal", "traverse_launch",
                         [P, P, P, P, I64, I, I, I64, I, I, I, P])
    err = fn(codes.data_ptr(), tables.data_ptr(), leaves.data_ptr(),
             out.data_ptr(), n, C, K, class_stride, depth, missing_bin,
             THREADS, torch.cuda.current_stream(codes.device).cuda_stream)
    _build.check("traversal", err, "traversal")
    _build.count("traversal")
    return out


def traverse_cuda(tree: TreeArrays, codes: torch.Tensor, *,
                  missing_bin: int) -> torch.Tensor:
    """One-tree traversal; codes (n, C) with C matching tree.feature ids.
    Returns (n,) float32 leaf values."""
    if codes.device.type == "cpu":
        return traverse_plain(tree, codes, missing_bin)
    forest = TreeArrays(*[a[None] for a in tree])
    return traverse_forest_cuda(forest, codes, missing_bin=missing_bin)[:, 0]


def predict_ensemble_cuda(trees: TreeArrays, codes: torch.Tensor, *,
                          missing_bin: int,
                          n_classes: int = 1) -> torch.Tensor:
    """Ensemble sums: trees hold stacked (T, ...) arrays; codes (n, F).
    Returns (n,) float32, or (n, K) class margins for ``n_classes`` = K > 1
    (trees round-major, tree t feeds column t % K)."""
    if codes.device.type == "cpu":
        return predict_ensemble_plain(trees, codes, missing_bin, n_classes)
    tables = pack_node_table(trees).contiguous()
    leaves = trees.leaf_value.to(torch.float32).contiguous()
    if tables.ndim != 2 or codes.ndim != 2:
        raise ValueError("predict_ensemble: trees must be stacked (T, ...) "
                         "and codes (n, F)")
    if n_classes < 1:
        raise ValueError(f"predict_ensemble: n_classes {n_classes} < 1")
    depth = _check(tables, leaves, codes, "predict_ensemble")
    n, F = codes.shape
    T = tables.shape[0]
    out = torch.zeros((n, n_classes), dtype=torch.float32,
                      device=codes.device)
    if n > 0 and T > 0:
        tree_bytes = ((2 << depth) - 1) * 4
        tb = max(1, min(T, TREE_SMEM // tree_bytes))
        P, I, I64 = _build.POINTER, _build.INT, _build.INT64
        fn = _build.function("traversal", "ensemble_launch",
                             [P, P, P, P, I64, I, I, I, I, I, I, I, P])
        err = fn(codes.data_ptr(), tables.data_ptr(), leaves.data_ptr(),
                 out.data_ptr(), n, F, T, n_classes, depth, missing_bin, tb,
                 THREADS, torch.cuda.current_stream(codes.device).cuda_stream)
        _build.check("traversal", err, "predict_ensemble")
        _build.count("ensemble")
    return out[:, 0] if n_classes == 1 else out

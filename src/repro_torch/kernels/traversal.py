"""Step ⑤ traversal and batch inference kernels (``csrc/traversal.cu``).

Replace ``src/repro/kernels/traversal.py::_traverse_kernel`` (one tree)
and ``::_ensemble_kernel`` (the ensemble sum, K = 1).

Nodes are packed into one int32 word each (:func:`pack_node_table`), and a
tree's table and leaves sit in shared memory; one thread walks one record
D hops down with implicit children.

  * :func:`traverse_cuda` — bound by bytes (each record's code row in, one
    float out).
  * :func:`predict_ensemble_cuda` — bound by operations: n·T·D dependent
    hops against one pass over the codes.  Trees are staged in shared
    memory a block at a time and leaves sum in a register in tree order, so
    the sum matches :func:`predict_ensemble_plain` to float tolerance while
    the leaf each tree picks is identical.

Decisions are integer-exact: :func:`traverse_cuda` is bit-equal to
:func:`traverse_plain`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (TreeArrays, predict_ensemble_batched,
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
                           missing_bin: int) -> torch.Tensor:
    """Plain version of the ensemble walk: :func:`predict_ensemble_batched`
    over blocks of ``PLAIN_ROWS`` records, which bounds its (rows, T) node
    matrices."""
    parts = [predict_ensemble_batched(trees, codes[lo:lo + PLAIN_ROWS],
                                      missing_bin)
             for lo in range(0, codes.shape[0], PLAIN_ROWS)]
    if not parts:
        return torch.zeros((0,), dtype=torch.float32, device=codes.device)
    return torch.cat(parts)


def _check(tables, leaves, codes, what: str) -> int:
    """Validate the kernel's inputs; returns the tree depth."""
    if codes.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {codes.device}")
    if codes.dtype != torch.uint8 or codes.ndim != 2 \
            or not codes.is_contiguous():
        raise ValueError(f"{what}: codes must be a contiguous 2-D uint8 "
                         "tensor")
    depth = int(leaves.shape[-1]).bit_length() - 1
    if not 1 <= depth <= 10 or leaves.shape[-1] != 1 << depth \
            or tables.shape[-1] != (1 << depth) - 1:
        raise ValueError(f"{what}: tree tables are not a complete tree of "
                         "depth 1..10")
    if tables.device != codes.device or leaves.device != codes.device:
        raise ValueError(f"{what}: trees must lie on {codes.device}")
    C = codes.shape[1]
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


def traverse_cuda(tree: TreeArrays, codes: torch.Tensor, *,
                  missing_bin: int) -> torch.Tensor:
    """One-tree traversal; codes (n, C) with C matching tree.feature ids.
    Returns (n,) float32 leaf values."""
    if codes.device.type == "cpu":
        return traverse_plain(tree, codes, missing_bin)
    table = pack_node_table(tree).contiguous()
    leaves = tree.leaf_value.to(torch.float32).contiguous()
    depth = _check(table, leaves, codes, "traversal")
    n, C = codes.shape
    out = torch.empty((n,), dtype=torch.float32, device=codes.device)
    if n == 0:
        return out
    P, I, I64 = _build.POINTER, _build.INT, _build.INT64
    fn = _build.function("traversal", "traverse_launch",
                         [P, P, P, P, I64, I, I, I, I, P])
    err = fn(codes.data_ptr(), table.data_ptr(), leaves.data_ptr(),
             out.data_ptr(), n, C, depth, missing_bin, THREADS,
             torch.cuda.current_stream(codes.device).cuda_stream)
    _build.check("traversal", err, "traversal")
    _build.count("traversal")
    return out


def predict_ensemble_cuda(trees: TreeArrays, codes: torch.Tensor, *,
                          missing_bin: int) -> torch.Tensor:
    """Ensemble sums: trees hold stacked (T, ...) arrays; codes (n, F).
    Returns (n,) float32."""
    if codes.device.type == "cpu":
        return predict_ensemble_plain(trees, codes, missing_bin)
    tables = pack_node_table(trees).contiguous()
    leaves = trees.leaf_value.to(torch.float32).contiguous()
    if tables.ndim != 2:
        raise ValueError("predict_ensemble: trees must be stacked (T, ...)")
    depth = _check(tables, leaves, codes, "predict_ensemble")
    n, F = codes.shape
    T = tables.shape[0]
    out = torch.zeros((n,), dtype=torch.float32, device=codes.device)
    if n == 0 or T == 0:
        return out
    tree_bytes = ((2 << depth) - 1) * 4
    tb = max(1, min(T, TREE_SMEM // tree_bytes))
    P, I, I64 = _build.POINTER, _build.INT, _build.INT64
    fn = _build.function("traversal", "ensemble_launch",
                         [P, P, P, P, I64, I, I, I, I, I, I, P])
    err = fn(codes.data_ptr(), tables.data_ptr(), leaves.data_ptr(),
             out.data_ptr(), n, F, T, depth, missing_bin, tb, THREADS,
             torch.cuda.current_stream(codes.device).cuda_stream)
    _build.check("traversal", err, "predict_ensemble")
    _build.count("ensemble")
    return out

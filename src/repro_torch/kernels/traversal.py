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
    hops against one pass over the codes.  A block stages its R records'
    code rows in shared memory in a bank-free layout, then blocks of TB
    trees in turn; a thread walks U records hop by hop
    (:func:`ensemble_geometry` sizes it).  Leaves sum in a register per
    record in tree order, class by class (tree t feeds margin column
    t % K), so the sum matches :func:`predict_ensemble_plain` to float
    tolerance while the leaf each tree picks is identical.  Rows too wide
    to stage take the wide entry, which reads the codes from global memory
    (counted as ``ensemble_wide``).

Decisions are integer-exact: :func:`traverse_forest_cuda` is bit-equal to
:func:`traverse_forest_plain`.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (TreeArrays, predict_ensemble_batched,
                                     traverse_forest_ref as
                                     traverse_forest_plain,
                                     traverse_ref as traverse_plain)

THREADS = 256
MIN_STAGED_TREES = 16        # trees a staged block holds where room allows
PLAIN_ROWS = 1 << 18         # records per pass of the plain ensemble walk
MAX_FIELDS = 1 << 15         # field ids must fit the packed node word


class EnsembleLimits(NamedTuple):
    """What sizes an ensemble launch on one card (:func:`ensemble_limits`):
    the threads a block at most, the records a thread of the staged entry
    (U) and the blocks an SM that the launch bounds allow, all fixed in
    ``csrc/traversal.cu``; then the card's shared memory an SM, what the
    runtime keeps of it for every block, and the most a block may opt
    into."""
    threads: int
    per_thread: int
    blocks_per_sm: int
    sm_shared: int
    block_reserved: int
    block_shared: int

    @property
    def budget(self) -> int:
        """Shared bytes a block may hold with ``blocks_per_sm`` blocks an
        SM."""
        return min(self.block_shared,
                   self.sm_shared // self.blocks_per_sm - self.block_reserved)


class EnsembleGeometry(NamedTuple):
    """One ensemble launch: ``records`` (R) records a block, ``per_thread``
    (U) of them a thread, ``trees`` (TB) trees a staged block, ``smem``
    shared bytes a block, and the entry, ``"staged"`` (code rows in shared
    memory) or ``"wide"`` (code rows read from global memory)."""
    records: int
    per_thread: int
    trees: int
    smem: int
    entry: str

    @property
    def threads(self) -> int:
        return self.records // self.per_thread


@functools.lru_cache(maxsize=None)
def _limits(index: int) -> EnsembleLimits:
    out = (ctypes.c_int * len(EnsembleLimits._fields))()
    fn = _build.function("traversal", "ensemble_limits",
                         [_build.INT, _build.POINTER])
    _build.check("traversal", fn(index, ctypes.addressof(out)),
                 "ensemble limits")
    return EnsembleLimits(*out)


def ensemble_limits(device) -> EnsembleLimits:
    """The ensemble kernel's :class:`EnsembleLimits` on a CUDA device, read
    from the built kernel and the card."""
    device = torch.device(device)
    return _limits(torch.cuda.current_device() if device.index is None
                   else device.index)


def max_staged_fields(depth: int, limits: EnsembleLimits) -> int:
    """The widest code row the staged entry takes: 32 records' rows
    (padded to 4 bytes) and one depth-``depth`` tree in a block's shared
    memory."""
    tree_bytes = 4 * ((2 << depth) - 1)
    return (limits.block_shared - tree_bytes) // 32 // 4 * 4


def ensemble_geometry(n: int, F: int, T: int, depth: int,
                      limits: EnsembleLimits) -> EnsembleGeometry:
    """The ensemble kernel's launch for n records of F fields over T trees
    of depth ``depth``.

    Staged entry (F up to :func:`max_staged_fields`): a block holds R
    records' code rows, ``4·ceil(F/4)`` bytes each, then TB trees.  R is the
    largest of U·threads, U·threads − 32U, ..., 32U, 32 (a multiple of 32,
    so lane l reads bank l) whose rows leave room for
    ``min(T, MIN_STAGED_TREES)`` trees, else for one, within
    ``limits.budget`` (``blocks_per_sm`` blocks an SM), or within the
    block's whole shared memory where not even 32 rows fit the budget; no
    larger than n needs.  TB fills the rest.  Wide entry: one record a
    thread, ``limits.threads`` threads, TB trees within the budget.
    """
    tree_bytes = 4 * ((2 << depth) - 1)
    if F > max_staged_fields(depth, limits):
        tb = max(1, min(T, limits.budget // tree_bytes))
        return EnsembleGeometry(limits.threads, 1, tb, tb * tree_bytes,
                                "wide")
    row = 4 * math.ceil(F / 4)
    U = limits.per_thread
    step = 32 * U
    budget = limits.budget
    if 32 * row + tree_bytes > budget:
        budget = limits.block_shared
    top = min(U * limits.threads, step * max(1, math.ceil(n / step)))
    cands = list(range(top, 0, -step)) + [32]
    for need in (min(T, MIN_STAGED_TREES), 1):
        fits = [r for r in cands if r * row + need * tree_bytes <= budget]
        if fits:
            R = fits[0]
            break
    tb = min(T, (budget - R * row) // tree_bytes)
    return EnsembleGeometry(R, U, tb, R * row + tb * tree_bytes, "staged")


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
        geo = ensemble_geometry(n, F, T, depth, ensemble_limits(codes.device))
        P, I, I64 = _build.POINTER, _build.INT, _build.INT64
        fn = _build.function("traversal", "ensemble_launch",
                             [P, P, P, P, I64, I, I, I, I, I, I, I, I, I, P])
        wide = geo.entry == "wide"
        err = fn(codes.data_ptr(), tables.data_ptr(), leaves.data_ptr(),
                 out.data_ptr(), n, F, T, n_classes, depth, missing_bin,
                 geo.records, geo.trees, geo.smem, int(wide),
                 torch.cuda.current_stream(codes.device).cuda_stream)
        _build.check("traversal", err, "predict_ensemble")
        _build.count("ensemble_wide" if wide else "ensemble")
    return out[:, 0] if n_classes == 1 else out

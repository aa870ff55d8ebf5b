"""Step ③ — the partition kernel (``csrc/partition.cu``).

Replaces ``src/repro/kernels/partition.py::_partition_kernel``.

Bound on the H100: bytes — per record a node id in, one code byte, a node
id out.  One thread per record; the level's split table lives in shared
memory and is indexed directly by node id (the TPU kernel's one-hot float
parameter fetch becomes an integer index).  Two entries:

  * :func:`partition_cuda` keeps the JAX signature and reads ``codes_lvl``
    (n, C), the level's gathered columns;
  * :func:`partition_cm_cuda` reads ``codes_cm[f, r]`` straight from the
    (F, n) column-major copy, so the grower never materialises the (NN, n)
    gather of a level's columns.  Its plain version is that gather plus
    :func:`partition_ref`.

Integer-exact: both entries are bit-equal to their plain versions.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import partition_ref as partition_plain

THREADS = 256
MAX_NODES = 3072             # split table of 16-byte entries within 48 KB


def partition_cm_plain(node_ids, codes_cm, split_feature, split_threshold,
                       split_is_cat, split_default_left, missing_bin: int):
    """Plain version of the column-major entry: gather the level's columns
    from ``codes_cm`` (global field ids, -1 = pass-through), renumber the
    splits onto them, and route with :func:`partition_ref`."""
    nn = split_feature.shape[0]
    codes_lvl = codes_cm[split_feature.clamp(min=0).long()].T      # (n, NN)
    renum = torch.where(split_feature >= 0,
                        torch.arange(nn, dtype=torch.int32,
                                     device=split_feature.device), -1)
    return partition_plain(node_ids, codes_lvl, renum, split_threshold,
                           split_is_cat, split_default_left, missing_bin)


def _split_table(node_ids, codes, split_feature, split_threshold,
                 split_is_cat, split_default_left, what: str) -> torch.Tensor:
    """Check the kernel's inputs and pack the (NN, 4) int32 split table."""
    if codes.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {codes.device}")
    if codes.dtype != torch.uint8 or codes.ndim != 2 \
            or not codes.is_contiguous():
        raise ValueError(f"{what}: codes must be a contiguous 2-D uint8 "
                         "tensor")
    if node_ids.dtype != torch.int32 or node_ids.ndim != 1 \
            or not node_ids.is_contiguous() \
            or node_ids.device != codes.device:
        raise ValueError(f"{what}: node_ids must be a contiguous 1-D int32 "
                         f"tensor on {codes.device}")
    nn = split_feature.shape[0]
    if not 1 <= nn <= MAX_NODES:
        raise ValueError(f"{what}: {nn} split nodes outside [1, {MAX_NODES}]")
    parts = (split_feature, split_threshold, split_is_cat, split_default_left)
    if any(p.shape != (nn,) or p.device != codes.device for p in parts):
        raise ValueError(f"{what}: split tables must be ({nn},) tensors on "
                         f"{codes.device}")
    return torch.stack(parts, dim=1).to(torch.int32).contiguous()


def _launch(symbol: str, what: str, node_ids, codes, table, n: int,
            width: int, missing_bin: int) -> torch.Tensor:
    out = torch.empty((n,), dtype=torch.int32, device=codes.device)
    if n == 0:
        return out
    P, I, I64 = _build.POINTER, _build.INT, _build.INT64
    fn = _build.function("partition", symbol, [P, P, P, P, I64, I, I, I, I, P])
    err = fn(node_ids.data_ptr(), codes.data_ptr(), table.data_ptr(),
             out.data_ptr(), n, width, table.shape[0], missing_bin, THREADS,
             torch.cuda.current_stream(codes.device).cuda_stream)
    _build.check("partition", err, what)
    _build.count("partition")
    return out


def partition_cuda(node_ids, codes_lvl, split_feature, split_threshold,
                   split_is_cat, split_default_left, *,
                   missing_bin: int) -> torch.Tensor:
    """Route records to children; out in [0, 2*NN) int32.

    node_ids (n,) int32; codes_lvl (n, C) uint8; split_* (NN,) with
    split_feature indexing [0, C) or -1 (pass-through).
    """
    if codes_lvl.device.type == "cpu":
        return partition_plain(node_ids, codes_lvl, split_feature,
                               split_threshold, split_is_cat,
                               split_default_left, missing_bin)
    table = _split_table(node_ids, codes_lvl, split_feature, split_threshold,
                         split_is_cat, split_default_left, "partition")
    n, C = codes_lvl.shape
    if node_ids.shape[0] != n:
        raise ValueError("partition: node_ids and codes_lvl disagree on n")
    return _launch("partition_rows_launch", "partition", node_ids, codes_lvl,
                   table, n, C, missing_bin)


def partition_cm_cuda(node_ids, codes_cm, split_feature, split_threshold,
                      split_is_cat, split_default_left, *,
                      missing_bin: int) -> torch.Tensor:
    """As :func:`partition_cuda`, reading the (F, n) column-major copy;
    split_feature holds global field ids, or -1 (pass-through)."""
    if codes_cm.device.type == "cpu":
        return partition_cm_plain(node_ids, codes_cm, split_feature,
                                  split_threshold, split_is_cat,
                                  split_default_left, missing_bin)
    table = _split_table(node_ids, codes_cm, split_feature, split_threshold,
                         split_is_cat, split_default_left, "partition_cm")
    F, n = codes_cm.shape
    if node_ids.shape[0] != n:
        raise ValueError("partition_cm: node_ids and codes_cm disagree on n")
    return _launch("partition_cm_launch", "partition_cm", node_ids, codes_cm,
                   table, n, F, missing_bin)

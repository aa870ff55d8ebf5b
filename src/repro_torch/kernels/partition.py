"""Step ③ — the partition kernel (``csrc/partition.cu``).

Replaces ``src/repro/kernels/partition.py::_partition_kernel``.

Bound on the H100: bytes — per record a node id in, one code byte, a node
id out.  One thread per record; the level's split table lives in shared
memory and is indexed directly by node id (the TPU kernel's one-hot float
parameter fetch becomes an integer index).  The entries:

  * :func:`partition_cuda` keeps the JAX signature and reads ``codes_lvl``
    (n, C), the level's gathered columns;
  * :func:`partition_cm_cuda` reads ``codes_cm[f, r]`` straight from the
    (F, n) column-major copy, so the grower never materialises the (NN, n)
    gather of a level's columns.  It takes a class axis — node ids (K, n),
    split tables (K, NN), output (K, n) — in one launch with the class as
    a grid axis (the TPU build vmaps ``partition_pallas`` over classes).
    Its plain version is that gather plus :func:`partition_ref`, class by
    class (:func:`repro_torch.kernels.ref.partition_cm_ref`).

    Given 4-bit :class:`~repro_torch.core.binning.PackedCodes` over the
    record axis it launches the nibble entry (counted as
    ``partition_nibble``), which reads the packed bytes in place.

Integer-exact: every entry is bit-equal to its plain version.
"""
from __future__ import annotations

import torch

from repro_torch.core.binning import PackedCodes, as_unpacked
from repro_torch.kernels import _build
from repro_torch.kernels.ref import partition_cm_ref
from repro_torch.kernels.ref import partition_ref as partition_plain

THREADS = 256
MAX_NODES = 3072             # split table of 16-byte entries within 48 KB


def partition_cm_plain(node_ids, codes_cm, split_feature, split_threshold,
                       split_is_cat, split_default_left,
                       missing_bin: int) -> torch.Tensor:
    """Plain version of the column-major entries: unpack ``PackedCodes``,
    then :func:`~repro_torch.kernels.ref.partition_cm_ref`."""
    return partition_cm_ref(node_ids, as_unpacked(codes_cm), split_feature,
                            split_threshold, split_is_cat, split_default_left,
                            missing_bin)


def _split_table(node_ids, codes, split_feature, split_threshold,
                 split_is_cat, split_default_left, what: str) -> torch.Tensor:
    """Check the kernel's inputs and pack the (NN, 4) — class-batched
    (K, NN, 4) — int32 split table."""
    if codes.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {codes.device}")
    if codes.dtype != torch.uint8 or codes.ndim != 2 \
            or not codes.is_contiguous():
        raise ValueError(f"{what}: codes must be a contiguous 2-D uint8 "
                         "tensor")
    if node_ids.dtype != torch.int32 or node_ids.ndim not in (1, 2) \
            or not node_ids.is_contiguous() \
            or node_ids.device != codes.device:
        raise ValueError(f"{what}: node_ids must be a contiguous (n,) or "
                         f"(K, n) int32 tensor on {codes.device}")
    nn = split_feature.shape[-1]
    if not 1 <= nn <= MAX_NODES:
        raise ValueError(f"{what}: {nn} split nodes outside [1, {MAX_NODES}]")
    shape = node_ids.shape[:-1] + (nn,)
    parts = (split_feature, split_threshold, split_is_cat, split_default_left)
    if any(p.shape != shape or p.device != codes.device for p in parts):
        raise ValueError(f"{what}: split tables must be {tuple(shape)} "
                         f"tensors on {codes.device}")
    return torch.stack(parts, dim=-1).to(torch.int32).contiguous()


def _launch(symbol: str, what: str, node_ids, codes, table, n: int,
            dims, missing_bin: int, counter: str = "partition"
            ) -> torch.Tensor:
    """Launch a partition entry: ``dims`` are its int shape arguments
    between n and the table's node count."""
    out = torch.empty(node_ids.shape, dtype=torch.int32, device=codes.device)
    if out.numel() == 0:
        return out
    P, I, I64 = _build.POINTER, _build.INT, _build.INT64
    fn = _build.function("partition", symbol,
                         [P, P, P, P, I64] + [I] * len(dims) + [I, I, I, P])
    err = fn(node_ids.data_ptr(), codes.data_ptr(), table.data_ptr(),
             out.data_ptr(), n, *dims, table.shape[-2], missing_bin, THREADS,
             torch.cuda.current_stream(codes.device).cuda_stream)
    _build.check("partition", err, what)
    _build.count(counter)
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
    if node_ids.shape != (n,):
        raise ValueError("partition: node_ids must be (n,) with n the "
                         "records of codes_lvl")
    return _launch("partition_rows_launch", "partition", node_ids, codes_lvl,
                   table, n, (C,), missing_bin)


def partition_cm_cuda(node_ids, codes_cm, split_feature, split_threshold,
                      split_is_cat, split_default_left, *,
                      missing_bin: int) -> torch.Tensor:
    """As :func:`partition_cuda`, reading the (F, n) column-major copy, a
    uint8 tensor or ``PackedCodes`` over n; split_feature holds global
    field ids, or -1 (pass-through).

    Class-batched: node_ids (K, n) and split_* (K, NN) route every class's
    records in one launch; out (K, n).
    """
    if codes_cm.device.type == "cpu":
        return partition_cm_plain(node_ids, codes_cm, split_feature,
                                  split_threshold, split_is_cat,
                                  split_default_left, missing_bin)
    packed = isinstance(codes_cm, PackedCodes)
    what = "partition_nibble" if packed else "partition_cm"
    data = codes_cm.data if packed else codes_cm
    table = _split_table(node_ids, data, split_feature, split_threshold,
                         split_is_cat, split_default_left, what)
    F, n = codes_cm.shape                # the logical shape
    if packed and data.shape[1] != (n + 1) // 2:
        raise ValueError(f"{what}: {data.shape[1]} packed bytes a field do "
                         f"not hold {n} records")
    if node_ids.shape[-1] != n:
        raise ValueError(f"{what}: node_ids and codes_cm disagree on n")
    K = node_ids.shape[0] if node_ids.ndim == 2 else 1
    if K > 65535:
        raise ValueError(f"{what}: {K} classes exceed the grid")
    if packed:
        return _launch("partition_cm_nibble_launch", what, node_ids, data,
                       table, n, (F, K), missing_bin, "partition_nibble")
    return _launch("partition_cm_launch", what, node_ids, data, table, n,
                   (F, K), missing_bin)

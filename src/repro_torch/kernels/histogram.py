"""Step ① — the histogram kernels (``csrc/histogram.cu``).

Replace ``src/repro/kernels/histogram.py::_hist_kernel_grouped`` (the
``histogram_pallas(packed=False)`` path, at K = 1 and with ``_stats_node``'s
class axis at K > 1, on uint8 codes and, its ``nibble_packed`` branch, on
4-bit :class:`~repro_torch.core.binning.PackedCodes`) and
``::_hist_kernel_packed`` (the Fig. 9 naive-packing ablation).

Bound on the H100: bytes — the codes (n·F bytes, n·⌈F/2⌉ packed) plus g, h
and the node ids (12 bytes a record per class) are read once per (slot,
field) tile; two float adds per (record, field, class).  The TPU's one-hot
contraction would run on the tensor cores in TF32 here and truncate g and
h, so the kernels keep per-(slot, field) bin arrays in shared memory
instead (the paper's 2 KB SRAM per field) and reduce across blocks with
global float atomics; see the source for the tiling.  A slot is a (class,
node) pair, class-major, so K classes of NN nodes tile like K·NN nodes and
one launch reads the codes once for every class.  Sums are reordered from
run to run: bit-equal to :func:`histogram_plain` only for dyadic g, h.

  * :func:`histogram_cuda` — the grouped kernel: consecutive threads take
    consecutive (record, field) pairs.  Given ``PackedCodes`` it launches
    the same body reading nibbles (counted as ``histogram_nibble``).
  * :func:`histogram_naive_cuda` — the naive-packing twin on uint8 codes:
    each thread adds a record's tile fields one after another.  It serves
    ``hist_strategy="cuda_packed"`` and is never the default.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.binning import PackedCodes, as_unpacked
from repro_torch.kernels import _build
from repro_torch.kernels.ref import histogram_ref

SMEM_BUDGET = 192 * 1024     # dynamic shared memory for one block's bins
THREADS = 512
MIN_CHUNK = 4096             # records per block at the least
BLOCKS_PER_SM = 2


def tile_shape(n_slots: int, n_fields: int, n_bins: int):
    """(slot tile, field tile): as many (slot, field) bin arrays as fit
    the shared-memory budget, slots first."""
    pairs = max(1, SMEM_BUDGET // (n_bins * 2 * 4))
    st = min(n_slots, pairs)
    ft = min(n_fields, max(1, pairs // st))
    return st, ft


def histogram_plain(codes, g, h, node_ids, n_nodes: int,
                    n_bins: int) -> torch.Tensor:
    """Plain version of every histogram kernel: unpack ``PackedCodes``,
    then :func:`~repro_torch.kernels.ref.histogram_ref`."""
    return histogram_ref(as_unpacked(codes), g, h, node_ids, n_nodes, n_bins)


def histogram_cuda(codes, g: torch.Tensor, h: torch.Tensor,
                   node_ids: torch.Tensor, *, n_nodes: int,
                   n_bins: int) -> torch.Tensor:
    """(n, F) uint8 codes, or ``PackedCodes`` over F -> (n_nodes, F,
    n_bins, 2) float32 histogram, by the grouped kernel.

    g, h: (n,) float32; node_ids: (n,) int32 in [0, n_nodes).  Class-batched
    form: g, h and node_ids (K, n), one launch for all K classes, output
    (K, n_nodes, F, n_bins, 2).  CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise.
    """
    if isinstance(codes, PackedCodes):
        return _launch("hist_nibble_launch", "histogram_nibble", codes, g, h,
                       node_ids, n_nodes, n_bins)
    return _launch("hist_grouped_launch", "histogram", codes, g, h, node_ids,
                   n_nodes, n_bins)


def histogram_naive_cuda(codes: torch.Tensor, g: torch.Tensor,
                         h: torch.Tensor, node_ids: torch.Tensor, *,
                         n_nodes: int, n_bins: int) -> torch.Tensor:
    """The same histogram as :func:`histogram_cuda` from (n, F) uint8 codes,
    by the naive-packing kernel (the Fig. 9 ablation twin)."""
    if isinstance(codes, PackedCodes):
        raise ValueError("histogram_naive: codes must be unpacked uint8")
    return _launch("hist_naive_launch", "histogram_naive", codes, g, h,
                   node_ids, n_nodes, n_bins)


def _launch(symbol: str, counter: str, codes, g, h, node_ids, n_nodes: int,
            n_bins: int) -> torch.Tensor:
    """Check the inputs and launch one histogram entry; ``codes`` is a
    uint8 tensor, or ``PackedCodes`` for the nibble entry."""
    if codes.device.type == "cpu":
        return histogram_plain(codes, g, h, node_ids, n_nodes, n_bins)
    if codes.device.type != "cuda":
        raise ValueError(f"{counter}: unsupported device {codes.device}")
    packed = isinstance(codes, PackedCodes)
    data = codes.data if packed else codes
    if data.dtype != torch.uint8 or data.ndim != 2:
        raise ValueError(f"{counter}: codes must be a 2-D uint8 tensor")
    if packed and n_bins > 16:
        raise ValueError(f"{counter}: packed codes hold at most 16 bins, "
                         f"not {n_bins}")
    n, F = codes.shape                   # the logical shape
    if packed and data.shape[1] != (F + 1) // 2:
        raise ValueError(f"{counter}: {data.shape[1]} packed bytes a record "
                         f"do not hold {F} fields")
    codes = data
    stat_shape = (n,) if g.ndim == 1 else (g.shape[0], n)
    K = 1 if g.ndim == 1 else g.shape[0]
    for name, t, dtype in (("g", g, torch.float32), ("h", h, torch.float32),
                           ("node_ids", node_ids, torch.int32)):
        if t.dtype != dtype or t.shape != stat_shape \
                or t.device != codes.device:
            raise ValueError(f"{counter}: {name} must be a (n,) or (K, n) "
                             f"{dtype} tensor on {codes.device} matching "
                             f"g's {tuple(stat_shape)}")
    if not all(t.is_contiguous() for t in (codes, g, h, node_ids)):
        raise ValueError(f"{counter}: inputs must be contiguous")
    if not 1 <= n_bins <= 256 or n_nodes < 1 or K < 1:
        raise ValueError(f"{counter}: n_bins {n_bins} outside [1, 256], "
                         f"n_nodes {n_nodes} < 1 or no class")
    out = torch.zeros(stat_shape[:-1] + (n_nodes, F, n_bins, 2),
                      dtype=torch.float32, device=codes.device)
    if n == 0 or F == 0:
        return out
    st, ft = tile_shape(K * n_nodes, F, n_bins)
    tiles = math.ceil(K * n_nodes / st) * math.ceil(F / ft)
    sms = torch.cuda.get_device_properties(codes.device).multi_processor_count
    n_chunks = max(1, min(math.ceil(n / MIN_CHUNK),
                          math.ceil(BLOCKS_PER_SM * sms / tiles), 65535))
    chunk = math.ceil(n / n_chunks)
    P, I, I64 = _build.POINTER, _build.INT, _build.INT64
    fn = _build.function("histogram", symbol,
                         [P, P, P, P, P, I64, I, I, I, I, I, I, I, I64, I, P])
    err = fn(codes.data_ptr(), g.data_ptr(), h.data_ptr(),
             node_ids.data_ptr(), out.data_ptr(), n, F, K, n_nodes, n_bins,
             ft, st, n_chunks, chunk, THREADS,
             torch.cuda.current_stream(codes.device).cuda_stream)
    _build.check("histogram", err, counter)
    _build.count(counter)
    return out

"""Step ① — the histogram kernels (``csrc/histogram.cu``).

Replace ``src/repro/kernels/histogram.py::_hist_kernel_grouped`` (the
``histogram_pallas(packed=False)`` path, at K = 1 and with ``_stats_node``'s
class axis at K > 1, on uint8 codes and, its ``nibble_packed`` branch, on
4-bit :class:`~repro_torch.core.binning.PackedCodes`) and
``::_hist_kernel_packed`` (the Fig. 9 naive-packing ablation).

Bound on the H100: bytes — the codes (n·F bytes, n·⌈F/2⌉ packed) plus g, h
and the node ids (12 bytes a record per class); two float adds per (record,
field, class).  The TPU's one-hot contraction would run on the tensor cores
in TF32 here and truncate g and h, so the kernels keep per-field bin arrays
in shared memory instead (the paper's 2 KB SRAM per field) and reduce
across blocks with global float atomics; see the source.  A slot is a
(class, node) pair, class-major, so K classes of NN nodes are K·NN slots.
Sums are reordered from run to run: bit-equal to :func:`histogram_plain`
only for dyadic g, h.

  * :func:`histogram_cuda` — the grouped kernel: a counting sort groups the
    (class, record) pairs by slot, then each block adds an equal share of
    the sorted list into one slot's bins at a time, a warp per record and
    a lane per field, so every pair is read once a level
    (:func:`grouped_geometry` sizes it).  Given ``PackedCodes`` it launches
    the same body reading nibbles (counted as ``histogram_nibble``).
  * :func:`histogram_naive_cuda` — the naive-packing twin on uint8 codes:
    (slot, field) tiles (:func:`tile_shape`), each thread adding a record's
    tile fields one after another.  It serves ``hist_strategy="cuda_packed"``
    and is never the default.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.core.binning import PackedCodes, as_unpacked
from repro_torch.kernels import _build
from repro_torch.kernels.ref import histogram_ref

# The naive-packing twin's (slot, field) tiles
SMEM_BUDGET = 192 * 1024     # dynamic shared memory for one block's bins
THREADS = 512
MIN_CHUNK = 4096             # records (grouped: positions) a block at least
BLOCKS_PER_SM = 2

# The grouped kernel's grid and its counting sort's (the rest of what sizes
# them is read from the built kernel and the card: GroupedLimits)
MIN_GROUPED_BLOCKS_PER_SM = 2   # shared memory for two blocks' bins an SM
SORT_BLOCKS_PER_SM = 4
SORT_MIN_CHUNK = 8192        # records a sort block takes at the least


class GroupedLimits(NamedTuple):
    """What sizes a grouped launch on one card (:func:`grouped_limits`):
    the blocks an SM that the kernel's launch bounds allow and the counting
    sort's shared bytes a node, both fixed in ``csrc/histogram.cu``; then
    the card's SMs, shared memory an SM, what the runtime keeps of it for
    every block, and the most a block may opt into."""
    blocks_per_sm: int
    sort_node_bytes: int
    sms: int
    sm_shared: int
    block_reserved: int
    block_shared: int

    @property
    def budget(self) -> int:
        """Bytes of bins a block may hold: two blocks an SM at least."""
        return min(self.block_shared,
                   self.sm_shared // MIN_GROUPED_BLOCKS_PER_SM
                   - self.block_reserved)

    @property
    def max_sort_nodes(self) -> int:
        """The most nodes a class whose counters one sort block holds."""
        return self.block_shared // self.sort_node_bytes


class GroupedGeometry(NamedTuple):
    """One launch of the grouped kernel: blocks x field tiles, each block
    adding ``per_block`` positions of the sorted list into ``field_tile``
    fields' bins (a bin's fields ``row`` words apart, g then h: ``smem``
    bytes); the counting sort runs ``sort_blocks`` blocks of ``sort_chunk``
    records a class (none with one slot)."""
    field_tile: int
    n_ftiles: int
    row: int
    smem: int
    blocks: int
    per_block: int
    sort_blocks: int
    sort_chunk: int


def tile_shape(n_slots: int, n_fields: int, n_bins: int):
    """(slot tile, field tile): as many (slot, field) bin arrays as fit
    the shared-memory budget, slots first."""
    pairs = max(1, SMEM_BUDGET // (n_bins * 2 * 4))
    st = min(n_slots, pairs)
    ft = min(n_fields, max(1, pairs // st))
    return st, ft


@functools.lru_cache(maxsize=None)
def _limits(index: int) -> GroupedLimits:
    out = (ctypes.c_int * len(GroupedLimits._fields))()
    fn = _build.function("histogram", "hist_grouped_limits",
                         [_build.INT, _build.POINTER])
    _build.check("histogram", fn(index, ctypes.addressof(out)),
                 "histogram limits")
    return GroupedLimits(*out)


def grouped_limits(device) -> GroupedLimits:
    """The grouped kernel's :class:`GroupedLimits` on a CUDA device, read
    from the built kernel and the card."""
    device = torch.device(device)
    return _limits(torch.cuda.current_device() if device.index is None
                   else device.index)


def grouped_geometry(n: int, n_classes: int, n_nodes: int, n_fields: int,
                     n_bins: int, limits: GroupedLimits) -> GroupedGeometry:
    """The grouped kernel's launch for n records of ``n_classes`` classes.

    The bins are [bin][field] with the fields of a tile padded to a
    multiple of 32 (``row``), so the lane of field f always adds into bank
    f mod 32; twice (g and h).  A block takes the fewest equal field tiles
    whose bins fit ``limits.budget``.  Blocks fill the card once (as many
    as are resident at once, split over the field tiles), each taking an
    equal share of the K·n sorted positions.
    """
    n_ftiles = 1
    while True:
        field_tile = math.ceil(n_fields / n_ftiles)
        row = 32 * math.ceil(field_tile / 32)
        smem = 8 * n_bins * row
        if smem <= limits.budget or field_tile == 1:
            break
        n_ftiles += 1
    n_ftiles = math.ceil(n_fields / field_tile)
    per_sm = max(1, min(limits.blocks_per_sm,
                        limits.sm_shared // (smem + limits.block_reserved)))
    pairs = n_classes * n
    blocks = max(1, min(math.ceil(pairs / MIN_CHUNK),
                        per_sm * limits.sms // n_ftiles))
    if n_classes * n_nodes == 1:
        sort_blocks = sort_chunk = 0
    else:
        sort_blocks = max(1, min(math.ceil(n / SORT_MIN_CHUNK),
                                 math.ceil(SORT_BLOCKS_PER_SM * limits.sms
                                           / n_classes)))
        sort_chunk = math.ceil(n / sort_blocks)
    return GroupedGeometry(field_tile, n_ftiles, row, smem, blocks,
                           math.ceil(pairs / blocks), sort_blocks, sort_chunk)


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
        return _launch_grouped("hist_nibble_launch", "histogram_nibble",
                               codes, g, h, node_ids, n_nodes, n_bins)
    return _launch_grouped("hist_grouped_launch", "histogram", codes, g, h,
                           node_ids, n_nodes, n_bins)


def histogram_naive_cuda(codes: torch.Tensor, g: torch.Tensor,
                         h: torch.Tensor, node_ids: torch.Tensor, *,
                         n_nodes: int, n_bins: int) -> torch.Tensor:
    """The same histogram as :func:`histogram_cuda` from (n, F) uint8 codes,
    by the naive-packing kernel (the Fig. 9 ablation twin)."""
    if isinstance(codes, PackedCodes):
        raise ValueError("histogram_naive: codes must be unpacked uint8")
    return _launch_naive(codes, g, h, node_ids, n_nodes, n_bins)


def _prepare(counter: str, codes, g, h, node_ids, n_nodes: int,
             n_bins: int):
    """Check the inputs of one histogram entry and allocate its zeroed
    output.  Returns (codes tensor, n, F, K, output)."""
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
    stat_shape = (n,) if g.ndim == 1 else (g.shape[0], n)
    K = 1 if g.ndim == 1 else g.shape[0]
    for name, t, dtype in (("g", g, torch.float32), ("h", h, torch.float32),
                           ("node_ids", node_ids, torch.int32)):
        if t.dtype != dtype or t.shape != stat_shape \
                or t.device != data.device:
            raise ValueError(f"{counter}: {name} must be a (n,) or (K, n) "
                             f"{dtype} tensor on {data.device} matching "
                             f"g's {tuple(stat_shape)}")
    if not all(t.is_contiguous() for t in (data, g, h, node_ids)):
        raise ValueError(f"{counter}: inputs must be contiguous")
    if not 1 <= n_bins <= 256 or n_nodes < 1 or K < 1:
        raise ValueError(f"{counter}: n_bins {n_bins} outside [1, 256], "
                         f"n_nodes {n_nodes} < 1 or no class")
    out = torch.zeros(stat_shape[:-1] + (n_nodes, F, n_bins, 2),
                      dtype=torch.float32, device=data.device)
    return data, n, F, K, out


def _launch_grouped(symbol: str, counter: str, codes, g, h, node_ids,
                    n_nodes: int, n_bins: int) -> torch.Tensor:
    """The grouped kernel (uint8 or nibble entry): counting sort by slot,
    then the histogram."""
    if codes.device.type == "cpu":
        return histogram_plain(codes, g, h, node_ids, n_nodes, n_bins)
    data, n, F, K, out = _prepare(counter, codes, g, h, node_ids, n_nodes,
                                  n_bins)
    limits = grouped_limits(data.device)
    if n >= 2 ** 31 or n_nodes > limits.max_sort_nodes:
        raise ValueError(f"{counter}: {n} records (at most 2**31 - 1) or "
                         f"{n_nodes} nodes (at most {limits.max_sort_nodes})")
    if n == 0 or F == 0:
        return out
    geo = grouped_geometry(n, K, n_nodes, F, n_bins, limits)
    order = slots = None
    if K * n_nodes > 1:
        order = torch.empty(K * n, dtype=torch.int32, device=data.device)
        slots = torch.zeros(3 * K * n_nodes + 1, dtype=torch.int64,
                            device=data.device)
    P, I, I64 = _build.POINTER, _build.INT, _build.INT64
    fn = _build.function("histogram", symbol,
                         [P, P, P, P, P, P, P, I64, I, I, I, I, I, I, I, I,
                          I64, I, I64, P])
    err = fn(data.data_ptr(), g.data_ptr(), h.data_ptr(),
             node_ids.data_ptr(), None if order is None else order.data_ptr(),
             None if slots is None else slots.data_ptr(), out.data_ptr(), n,
             F, K, n_nodes, n_bins, geo.field_tile, geo.row, geo.n_ftiles,
             geo.blocks, geo.per_block, geo.sort_blocks, geo.sort_chunk,
             torch.cuda.current_stream(data.device).cuda_stream)
    _build.check("histogram", err, counter)
    _build.count(counter)
    return out


def _launch_naive(codes, g, h, node_ids, n_nodes: int,
                  n_bins: int) -> torch.Tensor:
    """The naive-packing twin over (slot, field) tiles."""
    counter = "histogram_naive"
    if codes.device.type == "cpu":
        return histogram_plain(codes, g, h, node_ids, n_nodes, n_bins)
    codes, n, F, K, out = _prepare(counter, codes, g, h, node_ids, n_nodes,
                                   n_bins)
    if n == 0 or F == 0:
        return out
    st, ft = tile_shape(K * n_nodes, F, n_bins)
    tiles = math.ceil(K * n_nodes / st) * math.ceil(F / ft)
    sms = torch.cuda.get_device_properties(codes.device).multi_processor_count
    n_chunks = max(1, min(math.ceil(n / MIN_CHUNK),
                          math.ceil(BLOCKS_PER_SM * sms / tiles), 65535))
    chunk = math.ceil(n / n_chunks)
    P, I, I64 = _build.POINTER, _build.INT, _build.INT64
    fn = _build.function("histogram", "hist_naive_launch",
                         [P, P, P, P, P, I64, I, I, I, I, I, I, I, I64, I, P])
    err = fn(codes.data_ptr(), g.data_ptr(), h.data_ptr(),
             node_ids.data_ptr(), out.data_ptr(), n, F, K, n_nodes, n_bins,
             ft, st, n_chunks, chunk, THREADS,
             torch.cuda.current_stream(codes.device).cuda_stream)
    _build.check("histogram", err, counter)
    _build.count(counter)
    return out

"""Step ① — the histogram kernels (``csrc/histogram.cu``).

Replace ``src/repro/kernels/histogram.py::_hist_kernel_grouped`` (the
``histogram_pallas(packed=False)`` path, at K = 1 and with ``_stats_node``'s
class axis at K > 1, on uint8 codes and, its ``nibble_packed`` branch, on
4-bit :class:`~repro_torch.core.binning.PackedCodes`) and
``::_hist_kernel_packed`` (the Fig. 9 naive-packing ablation).

Bound on the H100: bytes — the codes (n·F bytes, n·⌈F/2⌉ packed) plus g, h
and the node ids (12 bytes a record per class); two adds per (record,
field, class).  The TPU's one-hot contraction would run on the tensor cores
in TF32 here and truncate g and h, so the kernels keep per-field bin arrays
in shared memory instead (the paper's 2 KB SRAM per field); see the source.
A slot is a (class, node) pair, class-major, so K classes of NN nodes are
K·NN slots.

  * :func:`histogram_cuda` — the grouped kernel: a counting sort groups the
    (class, record) pairs by slot, then each block adds an equal share of
    the sorted list into one slot's bins at a time, a warp per record and
    a lane per field, so every pair is read once a level
    (:func:`grouped_geometry` sizes it).  Given ``PackedCodes`` it launches
    the same body reading nibbles (counted as ``histogram_nibble``).  Its
    bins are fixed-point: each g (h) is rounded once to a power-of-two grid
    (:func:`fixed_point_scale`, at most 2^-30 of the largest |g| of the
    tree's records) and added as two 32-bit integer words, a high and a
    low half, with native shared-memory integer atomics; a block flushes
    at each slot's edge and at least every 2^16 sorted positions, so no
    word overflows, into an int64 scratch with 64-bit global atomics, and
    one pass a call turns the int64 sums into the float32 histogram.
    Integer sums do not depend on their order: the histogram is the same
    from launch to launch, and bit-equal to :func:`histogram_plain` where
    g and h lie on the grid and every float32 partial sum is exact
    (dyadic g, h).  A non-finite g (h) makes its statistic's histogram NaN.
  * :func:`histogram_level_cuda` — the same kernels for one level of the
    depthwise grower, which also hands back the level's int64 sums; given
    the last level's (``parent``) it builds the level by exact subtraction
    (paper §II-A): the counting sort lists only each parent's smaller
    child (:func:`smaller_child_plain`), the kernel bins at most half the
    (class, record) pairs, and the finish pass derives each sibling as
    ``parent − smaller`` in int64 (:func:`derive_siblings_plain`), so the
    level equals the direct pass bit for bit.  The pairs listed and the
    pairs a direct pass lists add into a device counter
    (:func:`record_pair_counts`).
  * :func:`histogram_naive_cuda` — the naive-packing twin on uint8 codes:
    the same sort and schedule, but a block's bins are one slot's flat
    float32 [field][bin][2] array and each thread adds a whole record's
    fields one after another (``grouped_geometry(..., naive=True)`` sizes
    it).  Its float atomics reorder the sums from run to run: bit-equal to
    :func:`histogram_plain` only for dyadic g, h.  It serves
    ``hist_strategy="cuda_packed"`` and is never the default.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.core.binning import PackedCodes, as_unpacked
from repro_torch.kernels import _build
from repro_torch.kernels.ref import histogram_ref

# The histogram kernels' grid and their counting sort's (the rest of what
# sizes them is read from the built kernel and the card: GroupedLimits)
MIN_CHUNK = 4096             # sorted positions a block takes at the least
MIN_NAIVE_BLOCKS_PER_SM = 2  # shared memory for two naive blocks' bins an SM
SORT_BLOCKS_PER_SM = 4
SORT_MIN_CHUNK = 8192        # records a sort block takes at the least
# Bytes of a (field, bin) in the grouped kernel's bins: g's high and low
# words, then h's (NB + 1 bins a field); in the naive kernel's, the float32
# g and h.
GROUPED_BIN_BYTES = 16
NAIVE_BIN_BYTES = 8
# What a grouped block holds beside its bins: each of its 32 warps' stage
# of 32 positions' record index and fixed-point g, h words
# (GROUPED_STAGE_BYTES)
GROUPED_STAGE_BYTES = 32 * 5 * 32 * 4
# The most sorted positions the grouped kernel adds between two flushes:
# a high word takes 2^16 adds of [-2^15, 2^15) and a low word 2^16 adds of
# [0, 2^16) before it could overflow 32 bits.
FLUSH_POSITIONS = 2 ** 16
# The grid puts the largest |g| of the tree's records in [2^30, 2^31):
# a record's fixed-point g then fits 32 bits, its halves the ranges above.
GRID_TOP = 2.0 ** 30
MAX_SCALE = 2.0 ** 126       # the scale of all-zero (or subnormal) g


class GroupedLimits(NamedTuple):
    """What sizes a launch of either histogram kernel on one card
    (:func:`grouped_limits`): the grouped kernel's blocks an SM by its
    registers and threads, the naive kernel's blocks an SM by its launch
    bounds, and the counting sort's shared bytes a node, all from
    ``csrc/histogram.cu``; then the card's SMs, shared memory an SM, what
    the runtime keeps of it for every block, and the most a block may opt
    into."""
    blocks_per_sm: int
    naive_blocks_per_sm: int
    sort_node_bytes: int
    sms: int
    sm_shared: int
    block_reserved: int
    block_shared: int

    @property
    def budget(self) -> int:
        """Bytes of bins a naive block may hold: two blocks an SM at
        least."""
        return min(self.block_shared,
                   self.sm_shared // MIN_NAIVE_BLOCKS_PER_SM
                   - self.block_reserved)

    @property
    def grouped_budget(self) -> int:
        """Bytes of bins a grouped block may hold: one block an SM."""
        return min(self.block_shared, self.sm_shared - self.block_reserved)

    @property
    def max_sort_nodes(self) -> int:
        """The most nodes a class whose counters one sort block holds."""
        return self.block_shared // self.sort_node_bytes


class GroupedGeometry(NamedTuple):
    """One launch of a histogram kernel: blocks x field tiles, each block
    adding ``per_block`` positions of the sorted list into ``field_tile``
    fields' bins, laid out for ``row`` fields (``smem`` bytes: 16·(NB +
    1)·row and the warps' stages grouped, 8·NB·row naive), flushing them
    at each slot's edge and every ``flush_every`` positions; the counting
    sort runs ``sort_blocks`` blocks of ``sort_chunk`` records a class (none
    with one slot).  ``per_block`` is the share of a list of every pair:
    the kernels take an equal share of the list's length as the device
    reads it (``_flush_runs`` in the tests mirrors that)."""
    field_tile: int
    n_ftiles: int
    row: int
    smem: int
    blocks: int
    per_block: int
    flush_every: int
    sort_blocks: int
    sort_chunk: int


@functools.lru_cache(maxsize=None)
def _limits(index: int) -> GroupedLimits:
    out = (ctypes.c_int * len(GroupedLimits._fields))()
    fn = _build.function("histogram", "hist_grouped_limits",
                         [_build.INT, _build.POINTER])
    _build.check("histogram", fn(index, ctypes.addressof(out)),
                 "histogram limits")
    return GroupedLimits(*out)


def grouped_limits(device) -> GroupedLimits:
    """The histogram kernels' :class:`GroupedLimits` on a CUDA device, read
    from the built kernel and the card."""
    device = torch.device(device)
    return _limits(torch.cuda.current_device() if device.index is None
                   else device.index)


def grouped_geometry(n: int, n_classes: int, n_nodes: int, n_fields: int,
                     n_bins: int, limits: GroupedLimits,
                     naive: bool = False) -> GroupedGeometry:
    """The launch of the grouped kernel, or with ``naive`` of the
    naive-packing kernel, for n records of ``n_classes`` classes.

    The grouped kernel's bins are four [bin][field] word arrays with the
    fields of a tile padded to a multiple of 32 (``row``), so the lane of
    field f always adds into bank f mod 32; they may take the whole SM's
    shared memory (``limits.grouped_budget``), and it flushes at least
    every ``FLUSH_POSITIONS``.  The naive kernel's are the output's flat
    [field][bin][2] float32, unpadded (``row`` = the field tile), two
    blocks' an SM (``limits.budget``), flushed only at slots' edges.  A
    block takes the fewest equal field tiles whose bins fit the budget.
    Blocks fill the card once (as many as are resident at once, split over
    the field tiles), each taking an equal share of the K·n sorted
    positions.
    """
    if naive:
        pad, bin_bytes, budget = 1, NAIVE_BIN_BYTES, limits.budget
        blocks_per_sm, stage = limits.naive_blocks_per_sm, 0
    else:
        pad, bin_bytes, budget = 32, GROUPED_BIN_BYTES, limits.grouped_budget
        blocks_per_sm, stage = limits.blocks_per_sm, GROUPED_STAGE_BYTES
    n_ftiles = 1
    while True:
        field_tile = math.ceil(n_fields / n_ftiles)
        row = pad * math.ceil(field_tile / pad)
        # the grouped kernel's bins have one more, for what is not added
        smem = bin_bytes * (n_bins + (not naive)) * row + stage
        if smem <= budget or field_tile == 1:
            break
        n_ftiles += 1
    n_ftiles = math.ceil(n_fields / field_tile)
    per_sm = max(1, min(blocks_per_sm,
                        limits.sm_shared // (smem + limits.block_reserved)))
    pairs = n_classes * n
    blocks = max(1, min(math.ceil(pairs / MIN_CHUNK),
                        per_sm * limits.sms // n_ftiles))
    per_block = math.ceil(pairs / blocks)
    flush_every = per_block if naive else min(per_block, FLUSH_POSITIONS)
    if n_classes * n_nodes == 1:
        sort_blocks = sort_chunk = 0
    else:
        sort_blocks = max(1, min(math.ceil(n / SORT_MIN_CHUNK),
                                 math.ceil(SORT_BLOCKS_PER_SM * limits.sms
                                           / n_classes)))
        sort_chunk = math.ceil(n / sort_blocks)
    return GroupedGeometry(field_tile, n_ftiles, row, smem, blocks,
                           per_block, flush_every, sort_blocks, sort_chunk)


def fixed_point_scale(g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The grid of the grouped kernel's fixed-point bins: for (n,) g, h a
    (2,) float32 tensor, for (K, n) a (K, 2) one, of each class's scale
    for g and for h, a power of two that puts the largest |g| (|h|) of the
    class's records in [2^30, 2^31) (``MAX_SCALE`` where every value is 0
    or subnormal).  A record's g then lands on the integer rint(g·scale),
    at most 2^-31 of the largest |g| from it.  0 where a g (h) is NaN or
    infinite: the kernel's histogram of that statistic is then NaN.

    Plain PyTorch on the tensors' device, reading nothing back: the
    grower computes it once a tree, inside a CUDA graph's capture too."""
    if g.shape[-1] == 0:           # no record: every statistic is 0
        return torch.full(g.shape[:-1] + (2,), MAX_SCALE, device=g.device)
    top = torch.stack((torch.linalg.vector_norm(g, math.inf, dim=-1),
                       torch.linalg.vector_norm(h, math.inf, dim=-1)), -1)
    # 2^floor(log2 max): the float's exponent bits alone; +inf for a NaN
    # or infinite max, 0 for 0 or a subnormal
    top = (top.view(torch.int32) & 0x7F800000).view(torch.float32)
    return (GRID_TOP / top).clamp_max(MAX_SCALE)


def histogram_plain(codes, g, h, node_ids, n_nodes: int,
                    n_bins: int) -> torch.Tensor:
    """Plain version of every histogram kernel: unpack ``PackedCodes``,
    then :func:`~repro_torch.kernels.ref.histogram_ref`."""
    return histogram_ref(as_unpacked(codes), g, h, node_ids, n_nodes, n_bins)


def histogram_cuda(codes, g: torch.Tensor, h: torch.Tensor,
                   node_ids: torch.Tensor, *, n_nodes: int, n_bins: int,
                   scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n, F) uint8 codes, or ``PackedCodes`` over F -> (n_nodes, F,
    n_bins, 2) float32 histogram, by the grouped kernel.

    g, h: (n,) float32; node_ids: (n,) int32 in [0, n_nodes).  Class-batched
    form: g, h and node_ids (K, n), one launch for all K classes, output
    (K, n_nodes, F, n_bins, 2).  ``scale``: the fixed-point grid,
    :func:`fixed_point_scale` of g and h or of statistics whose magnitudes
    bound theirs (the tree's, where g and h are masked to some of its
    records); computed here when None.  CPU tensors take the plain version;
    CUDA tensors launch the kernel (:func:`histogram_level_cuda`'s direct
    pass) or raise.
    """
    if codes.device.type == "cpu":
        return histogram_plain(codes, g, h, node_ids, n_nodes, n_bins)
    if scale is None:
        _prepare("histogram", codes, g, h, node_ids, n_nodes, n_bins)
        scale = fixed_point_scale(g, h)     # g, h checked first
    return histogram_level_cuda(codes, g, h, node_ids, n_nodes=n_nodes,
                                n_bins=n_bins, scale=scale)[0]


def histogram_sums_cuda(codes, g: torch.Tensor, h: torch.Tensor,
                        node_ids: torch.Tensor, *, n_nodes: int, n_bins: int,
                        scale: torch.Tensor) -> torch.Tensor:
    """The grouped kernel's exact sums: the int64 ((K,) n_nodes, n_bins, F,
    2) sums of g and h on the grid ``scale`` (:func:`fixed_point_scale`),
    for inputs as :func:`histogram_cuda` takes them on a CUDA device.
    Sums of shards of the records on one grid add up exactly to the sums of
    all of them; :func:`histogram_from_sums` turns them into the float32
    histogram."""
    return _launch_grouped(codes, g, h, node_ids, n_nodes, n_bins,
                           scale=scale)[0]


def histogram_level_cuda(codes, g: torch.Tensor, h: torch.Tensor,
                         node_ids: torch.Tensor, *, n_nodes: int,
                         n_bins: int, scale: torch.Tensor,
                         parent: Optional[torch.Tensor] = None):
    """One level's step ① on the card: ``(hist, sums)``, the float32
    histogram of :func:`histogram_cuda` and the int64 sums of
    :func:`histogram_sums_cuda` it came from, for inputs as those take
    them.

    ``parent``: None for a direct pass; or the sums this call returned for
    the last level, when ``node_ids`` are that level's ids after step ③
    (node p's children at 2p and 2p + 1, ``n_nodes`` twice its nodes).
    Then the counting sort lists only each parent's smaller child (the
    left on a tie), the kernel bins at most half the (class, record) pairs
    and the finish pass writes every sibling's sums as ``parent −
    smaller``, exactly: both outputs equal the direct pass's bit for bit.
    The pairs listed and the pairs a direct pass lists add into the
    device's pair counter (:func:`record_pair_counts`).  Reads nothing
    back, so a CUDA graph can capture it.
    """
    sums, slots = _launch_grouped(codes, g, h, node_ids, n_nodes, n_bins,
                                  scale=scale, parent=parent)
    if slots is None:          # no sort: one slot, or no record
        parent = None
    return _finish(sums, scale, parent, slots), sums


def histogram_from_sums(sums: torch.Tensor,
                        scale: torch.Tensor) -> torch.Tensor:
    """The float32 ((K,) n_nodes, F, n_bins, 2) histogram of
    :func:`histogram_sums_cuda`'s sums on the grid ``scale``: each sum
    rounded once to float32 and divided by its scale (NaN where the scale
    is 0: a non-finite g or h)."""
    return _finish(sums, scale)


def _finish(sums: torch.Tensor, scale: torch.Tensor,
            parent: Optional[torch.Tensor] = None,
            slots: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The finish pass: the float32 histogram of ``sums``, with ``parent``
    the unbinned slots (their cursors in ``slots``, SKIP) derived first."""
    *lead, NB, F, _ = sums.shape
    if sums.dtype != torch.int64 or not sums.is_contiguous() \
            or sums.device.type != "cuda" or scale.dtype != torch.float32 \
            or scale.shape != tuple(lead[:-1]) + (2,) \
            or scale.device != sums.device or not scale.is_contiguous():
        raise ValueError("histogram_from_sums: a contiguous int64 CUDA "
                         f"tensor of sums and its {tuple(lead[:-1]) + (2,)} "
                         "float32 scale")
    out = torch.empty(tuple(lead) + (F, NB, 2), dtype=torch.float32,
                      device=sums.device)
    if out.numel() == 0:
        return out
    S = math.prod(lead)
    P, I, I64 = _build.POINTER, _build.INT, _build.INT64
    fn = _build.function("histogram", "hist_grouped_finish",
                         [P, P, P, P, P, I64, I, I, I, P])
    _build.check("histogram", fn(
        sums.data_ptr(), None if parent is None else parent.data_ptr(),
        None if parent is None else slots[2 * S + 1:].data_ptr(),
        scale.data_ptr(), out.data_ptr(), S, lead[-1], F, NB,
        torch.cuda.current_stream(sums.device).cuda_stream), "histogram")
    return out


# The device's (2,) int64 pair counter: the (class, record) pairs that the
# exact subtraction's sorts listed, and those a direct pass would have
# listed; made once a device, outside any capture, so that a CUDA graph's
# replays add into it; and what record_pair_counts last read of it.
_PAIRS: Dict[torch.device, torch.Tensor] = {}
_PAIRS_READ: Dict[torch.device, Tuple[int, int]] = {}
PAIR_COUNTERS = ("hist.pairs_binned", "hist.pairs_total")


def _pair_counter(device: torch.device) -> Optional[torch.Tensor]:
    """The device's pair counter, made at its first use outside a CUDA
    graph's capture (None inside one before that: the level is not
    counted)."""
    acc = _PAIRS.get(device)
    if acc is None and not torch.cuda.is_current_stream_capturing():
        acc = _PAIRS[device] = torch.zeros(2, dtype=torch.int64,
                                           device=device)
    return acc


def record_pair_counts() -> None:
    """Add what every device's pair counter gained since the last read to
    ``obs``'s ``PAIR_COUNTERS``: one copy to the host a device, no kernel;
    the trainer calls it once a fit, after its last round."""
    for device, acc in _PAIRS.items():
        binned, total = acc.tolist()
        before = _PAIRS_READ.get(device, (0, 0))
        _PAIRS_READ[device] = (binned, total)
        for name, now, was in zip(PAIR_COUNTERS, (binned, total), before):
            obs.record(name, now - was)


def smaller_child_plain(counts: torch.Tensor) -> torch.Tensor:
    """Plain version of the counting sort's choice under exact subtraction:
    for (..., NN) records a node (children of parent p at 2p and 2p + 1), a
    (..., NN) bool of the child each parent bins, the one with fewer
    records, the left on a tie; the other is derived."""
    left, right = counts[..., 0::2], counts[..., 1::2]
    return torch.stack((left <= right, right < left), -1).flatten(-2)


def derive_siblings_plain(parent: torch.Tensor, sums: torch.Tensor,
                          binned: torch.Tensor) -> torch.Tensor:
    """Plain version of the finish pass's derivation: the (..., NN, NB, F,
    2) int64 sums of a level whose ``binned`` (..., NN) slots hold their own
    sums, every other slot taking ``parent − sibling`` from the last level's
    (..., NN/2, NB, F, 2) ``parent``."""
    sibling = sums.unflatten(-4, (-1, 2)).flip(-4).flatten(-5, -4)
    derived = parent.repeat_interleave(2, dim=-4) - sibling
    return torch.where(binned[..., None, None, None], sums, derived)


def histogram_sums_plain(codes, g, h, node_ids, n_nodes: int, n_bins: int,
                         scale: torch.Tensor) -> torch.Tensor:
    """Plain version of the grouped kernel's sums: the int64 ((K,) n_nodes,
    n_bins, F, 2) sums of each record's rint(g·scale), rint(h·scale)."""
    codes = as_unpacked(codes).long()
    if g.ndim == 1:
        return histogram_sums_plain(codes, g[None], h[None], node_ids[None],
                                    n_nodes, n_bins, scale[None])[0]
    K, n = g.shape
    F = codes.shape[1]
    q = torch.round(torch.stack((g, h), -1) * scale[:, None, :]).long()
    slot = node_ids.long() + n_nodes * torch.arange(K)[:, None]   # (K, n)
    at = (slot[:, :, None] * n_bins + codes[None]) * F + torch.arange(F)
    out = torch.zeros((K * n_nodes * n_bins * F, 2), dtype=torch.int64)
    out.index_add_(0, at.reshape(-1),
                   q[:, :, None, :].expand(K, n, F, 2).reshape(-1, 2))
    return out.reshape(K, n_nodes, n_bins, F, 2)


def histogram_naive_cuda(codes: torch.Tensor, g: torch.Tensor,
                         h: torch.Tensor, node_ids: torch.Tensor, *,
                         n_nodes: int, n_bins: int) -> torch.Tensor:
    """The same histogram as :func:`histogram_cuda` from (n, F) uint8 codes,
    by the naive-packing kernel (the Fig. 9 ablation twin)."""
    if isinstance(codes, PackedCodes):
        raise ValueError("histogram_naive: codes must be unpacked uint8")
    if codes.device.type == "cpu":
        return histogram_plain(codes, g, h, node_ids, n_nodes, n_bins)
    return _launch_grouped(codes, g, h, node_ids, n_nodes, n_bins,
                           naive=True)[0]


def _prepare(counter: str, codes, g, h, node_ids, n_nodes: int,
             n_bins: int):
    """Check the inputs of one histogram entry.  Returns (codes tensor, n,
    F, K)."""
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
    return data, n, F, K


def _launch_grouped(codes, g, h, node_ids, n_nodes: int, n_bins: int,
                    naive: bool = False,
                    scale: Optional[torch.Tensor] = None,
                    parent: Optional[torch.Tensor] = None):
    """The grouped kernel (uint8 or nibble entry): counting sort by slot,
    then the int64 sums on the grid ``scale``, with ``parent`` those of
    each parent's smaller child only; or, with ``naive``, the naive-packing
    kernel's float32 histogram.  Returns (output, the sort's slots or None
    where it did not run)."""
    packed = isinstance(codes, PackedCodes)
    counter = ("histogram_naive" if naive
               else "histogram_nibble" if packed else "histogram")
    data, n, F, K = _prepare(counter, codes, g, h, node_ids, n_nodes,
                             n_bins)
    limits = grouped_limits(data.device)
    if n >= 2 ** 31 or n_nodes > limits.max_sort_nodes:
        raise ValueError(f"{counter}: {n} records (at most 2**31 - 1) or "
                         f"{n_nodes} nodes (at most {limits.max_sort_nodes})")
    if not naive and (scale is None or scale.dtype != torch.float32
                      or scale.device != data.device
                      or scale.shape != g.shape[:-1] + (2,)
                      or not scale.is_contiguous()):
        raise ValueError(f"{counter}: scale must be a contiguous "
                         f"{tuple(g.shape[:-1]) + (2,)} float32 tensor on "
                         f"{data.device}")
    shape = g.shape[:-1] + ((n_nodes, F, n_bins, 2) if naive
                            else (n_nodes, n_bins, F, 2))
    if parent is not None and (
            n_nodes % 2 or parent.dtype != torch.int64
            or parent.device != data.device or not parent.is_contiguous()
            or parent.shape != g.shape[:-1] + (n_nodes // 2, n_bins, F, 2)):
        raise ValueError(f"{counter}: parent must be the last level's "
                         f"contiguous int64 sums of {n_nodes // 2} nodes on "
                         f"{data.device}")
    out = torch.zeros(shape, dtype=torch.float32 if naive else torch.int64,
                      device=data.device) if n == 0 or F == 0 or naive \
        else torch.empty(shape, dtype=torch.int64, device=data.device)
    if n == 0 or F == 0:
        return out, None
    geo = grouped_geometry(n, K, n_nodes, F, n_bins, limits, naive)
    order = slots = None
    if K * n_nodes > 1:
        order = torch.empty(K * n, dtype=torch.int32, device=data.device)
        slots = torch.zeros(3 * K * n_nodes + 1, dtype=torch.int64,
                            device=data.device)
    P, I, I64 = _build.POINTER, _build.INT, _build.INT64
    args = [data.data_ptr(), g.data_ptr(), h.data_ptr(), node_ids.data_ptr(),
            None if order is None else order.data_ptr(),
            None if slots is None else slots.data_ptr(), n, F, K, n_nodes,
            n_bins, geo.field_tile, geo.row, geo.n_ftiles, geo.blocks,
            geo.sort_blocks, geo.sort_chunk]
    types = [P] * 6 + [I64, I, I, I, I, I, I, I, I, I, I64]
    stream = torch.cuda.current_stream(data.device).cuda_stream
    if naive:
        fn = _build.function("histogram", "hist_naive_launch", types + [P, P])
        err = fn(*args, out.data_ptr(), stream)
    else:
        pairs = None if parent is None else _pair_counter(data.device)
        fn = _build.function(
            "histogram", "hist_nibble_launch" if packed
            else "hist_grouped_launch",
            types + [P, P, I64, ctypes.c_bool, P, P])
        err = fn(*args, scale.data_ptr(), out.data_ptr(), geo.flush_every,
                 parent is not None,
                 None if pairs is None else pairs.data_ptr(), stream)
    _build.check("histogram", err, counter)
    _build.count(counter)
    return out, slots

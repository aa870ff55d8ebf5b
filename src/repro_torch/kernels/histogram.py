"""Step ① — the grouped histogram kernel (``csrc/histogram.cu``).

Replaces ``src/repro/kernels/histogram.py::_hist_kernel_grouped`` (the
``histogram_pallas(packed=False)`` path on uint8 codes, at K = 1 and with
``_stats_node``'s class axis at K > 1).

Bound on the H100: bytes — the codes (n·F bytes) plus g, h and the node
ids (12 bytes a record per class) are read once per (slot, field) tile;
two float adds per (record, field, class).  The TPU's one-hot contraction
would run on the tensor cores in TF32 here and truncate g and h, so the
kernel keeps per-(slot, field) bin arrays in shared memory instead (the
paper's 2 KB SRAM per field) and reduces across blocks with global float
atomics; see the source for the tiling.  A slot is a (class, node) pair,
class-major, so K classes of NN nodes tile like K·NN nodes and one launch
reads the codes once for every class.  Sums are reordered from run to run:
bit-equal to :func:`histogram_plain` only for dyadic g, h.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import histogram_ref as histogram_plain

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


def histogram_cuda(codes: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
                   node_ids: torch.Tensor, *, n_nodes: int,
                   n_bins: int) -> torch.Tensor:
    """(n, F) uint8 codes -> (n_nodes, F, n_bins, 2) float32 histogram.

    g, h: (n,) float32; node_ids: (n,) int32 in [0, n_nodes).  Class-batched
    form: g, h and node_ids (K, n), one launch for all K classes, output
    (K, n_nodes, F, n_bins, 2).  CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise.
    """
    if codes.device.type == "cpu":
        return histogram_plain(codes, g, h, node_ids, n_nodes, n_bins)
    if codes.device.type != "cuda":
        raise ValueError(f"histogram: unsupported device {codes.device}")
    if codes.dtype != torch.uint8 or codes.ndim != 2:
        raise ValueError("histogram: codes must be a 2-D uint8 tensor")
    n, F = codes.shape
    stat_shape = (n,) if g.ndim == 1 else (g.shape[0], n)
    K = 1 if g.ndim == 1 else g.shape[0]
    for name, t, dtype in (("g", g, torch.float32), ("h", h, torch.float32),
                           ("node_ids", node_ids, torch.int32)):
        if t.dtype != dtype or t.shape != stat_shape \
                or t.device != codes.device:
            raise ValueError(f"histogram: {name} must be a (n,) or (K, n) "
                             f"{dtype} tensor on {codes.device} matching "
                             f"g's {tuple(stat_shape)}")
    if not all(t.is_contiguous() for t in (codes, g, h, node_ids)):
        raise ValueError("histogram: inputs must be contiguous")
    if not 1 <= n_bins <= 256 or n_nodes < 1 or K < 1:
        raise ValueError(f"histogram: n_bins {n_bins} outside [1, 256], "
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
    fn = _build.function("histogram", "hist_grouped_launch",
                         [P, P, P, P, P, I64, I, I, I, I, I, I, I, I64, I, P])
    err = fn(codes.data_ptr(), g.data_ptr(), h.data_ptr(),
             node_ids.data_ptr(), out.data_ptr(), n, F, K, n_nodes, n_bins,
             ft, st, n_chunks, chunk, THREADS,
             torch.cuda.current_stream(codes.device).cuda_stream)
    _build.check("histogram", err, "histogram")
    _build.count("histogram")
    return out

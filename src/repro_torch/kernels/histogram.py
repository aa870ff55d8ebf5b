"""Step ① — the grouped histogram kernel (``csrc/histogram.cu``).

Replaces ``src/repro/kernels/histogram.py::_hist_kernel_grouped`` (the
``histogram_pallas(packed=False)`` path at K = 1, uint8 codes).

Bound on the H100: bytes — the codes (n·F bytes) plus g, h and the node
ids (12 bytes a record) are read once per field tile; two float adds per
(record, field).  The TPU's one-hot contraction would run on the tensor
cores in TF32 here and truncate g and h, so the kernel keeps per-(node,
field) bin arrays in shared memory instead (the paper's 2 KB SRAM per
field) and reduces across blocks with global float atomics; see the source
for the tiling.  Sums are reordered from run to run: bit-equal to
:func:`histogram_plain` only for dyadic g, h.
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


def tile_shape(n_nodes: int, n_fields: int, n_bins: int):
    """(node tile, field tile): as many (node, field) bin arrays as fit
    the shared-memory budget, nodes first."""
    pairs = max(1, SMEM_BUDGET // (n_bins * 2 * 4))
    nt = min(n_nodes, pairs)
    ft = min(n_fields, max(1, pairs // nt))
    return nt, ft


def histogram_cuda(codes: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
                   node_ids: torch.Tensor, *, n_nodes: int,
                   n_bins: int) -> torch.Tensor:
    """(n, F) uint8 codes -> (n_nodes, F, n_bins, 2) float32 histogram.

    g, h: (n,) float32; node_ids: (n,) int32 in [0, n_nodes).  CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise.
    """
    if codes.device.type == "cpu":
        return histogram_plain(codes, g, h, node_ids, n_nodes, n_bins)
    if codes.device.type != "cuda":
        raise ValueError(f"histogram: unsupported device {codes.device}")
    if codes.dtype != torch.uint8 or codes.ndim != 2:
        raise ValueError("histogram: codes must be a 2-D uint8 tensor")
    n, F = codes.shape
    for name, t, dtype in (("g", g, torch.float32), ("h", h, torch.float32),
                           ("node_ids", node_ids, torch.int32)):
        if t.dtype != dtype or t.shape != (n,) or t.device != codes.device:
            raise ValueError(f"histogram: {name} must be a ({n},) {dtype} "
                             f"tensor on {codes.device}")
    if not all(t.is_contiguous() for t in (codes, g, h, node_ids)):
        raise ValueError("histogram: inputs must be contiguous")
    if not 1 <= n_bins <= 256 or n_nodes < 1:
        raise ValueError(f"histogram: n_bins {n_bins} outside [1, 256] or "
                         f"n_nodes {n_nodes} < 1")
    out = torch.zeros((n_nodes, F, n_bins, 2), dtype=torch.float32,
                      device=codes.device)
    if n == 0 or F == 0:
        return out
    nt, ft = tile_shape(n_nodes, F, n_bins)
    tiles = math.ceil(n_nodes / nt) * math.ceil(F / ft)
    sms = torch.cuda.get_device_properties(codes.device).multi_processor_count
    n_chunks = max(1, min(math.ceil(n / MIN_CHUNK),
                          math.ceil(BLOCKS_PER_SM * sms / tiles), 65535))
    chunk = math.ceil(n / n_chunks)
    P, I, I64 = _build.POINTER, _build.INT, _build.INT64
    fn = _build.function("histogram", "hist_grouped_launch",
                         [P, P, P, P, P, I64, I, I, I, I, I, I, I64, I, P])
    err = fn(codes.data_ptr(), g.data_ptr(), h.data_ptr(),
             node_ids.data_ptr(), out.data_ptr(), n, F, n_nodes, n_bins, ft,
             nt, n_chunks, chunk, THREADS,
             torch.cuda.current_stream(codes.device).cuda_stream)
    _build.check("histogram", err, "histogram")
    _build.count("histogram")
    return out

"""Step ② — the split-search kernel (``csrc/splits.cu``).

Replaces no TPU kernel: ``repro``'s ``find_best_splits`` is jnp that XLA
fuses under ``jit``; run eagerly on the card, the same function is ~100
small PyTorch operations a level and the fold of its decisions into the
tree tables ~30 more, each a launch that costs the host more than the
device.  One launch of :func:`split_level_cuda` does both.

Bound on the H100: the launch's latency, not bytes (a level's histogram is
1.8–24.8 MB in the benchmark's cells) nor operations.  One block a node,
one warp a field, a lane a run of consecutive bins loaded as 16-byte
vectors and scanned, a shuffle scan for the prefixes, a shuffle argmax a
field and a shared-memory argmax over fields (the source's head note).

Its plain version is :func:`repro_torch.core.splits.find_best_splits_plain`
(and, for the fold, the plain tail of
:func:`repro_torch.core.tree.decide_level`), which a CPU histogram takes;
on dyadic statistics the kernel's decisions are bit-equal to it.  The
wrapper launches on the current stream, never synchronises and reads
nothing back, so a CUDA graph can capture it.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build

MAX_BINS = 257               # 32 lanes x 8 value bins, plus the missing bin


def _flags(flags: torch.Tensor, F: int, device, what: str):
    """A (F,) field flag as the kernel reads it: its bytes where it holds
    one a field (bool, uint8, int8), else as int32; returns (tensor, bytes
    a flag)."""
    if flags.shape != (F,) or flags.device != device:
        raise ValueError(f"split_level: {what} must be a ({F},) tensor on "
                         f"{device}")
    if flags.dtype in (torch.bool, torch.uint8, torch.int8):
        return flags.contiguous(), 1
    return flags.to(torch.int32).contiguous(), 4


def _table(t: torch.Tensor, shape, dtype, device, what: str) -> int:
    if (t.shape != shape or t.dtype != dtype or t.device != device
            or not t.is_contiguous()):
        raise ValueError(f"split_level: {what} must be a contiguous "
                         f"{tuple(shape)} {dtype} tensor on {device}")
    return t.data_ptr()


def split_level_cuda(hist: torch.Tensor, is_cat_field: torch.Tensor,
                     field_mask: torch.Tensor, lambda_: float, gamma: float,
                     min_child_weight: float, *,
                     tables: Optional[Sequence[torch.Tensor]] = None,
                     level: int = 0, depth: int = 0
                     ) -> Tuple[Tuple[torch.Tensor, ...],
                                Optional[torch.Tensor]]:
    """Step ② of a level on the card in one launch.

    hist: (NN, F, NB, 2) float32, or (K, nn, F, NB, 2) with the class axis
    folded into the node axis; the last bin of every field is the missing
    bin.  Returns ``(decision, do_split)``: ``decision`` the eight arrays
    of :class:`~repro_torch.core.splits.SplitDecision` in its order, each
    shaped as the histogram's leading axes; ``do_split`` None unless
    ``tables`` is given.

    ``tables``: the grower's (K, 2^depth - 1) int32 feature, threshold,
    is_cat and default_left tables and its (K, 2^depth) float32
    value_bottom and bool value_set tables, which the launch updates in
    place at ``level`` as :func:`repro_torch.core.tree.decide_level` does;
    ``do_split`` is then the (K, nn) bool split mask.
    """
    if hist.device.type != "cuda":
        raise ValueError(f"split_level: unsupported device {hist.device}")
    if hist.dtype != torch.float32 or hist.ndim not in (4, 5) \
            or hist.shape[-1] != 2:
        raise ValueError("split_level: hist must be a float32 (NN, F, NB, 2) "
                         "or (K, nn, F, NB, 2) tensor")
    lead = tuple(hist.shape[:-3])
    F, NB = hist.shape[-3], hist.shape[-2]
    NN = 1
    for d in lead:
        NN *= d
    if not 2 <= NB <= MAX_BINS or F < 1 or NN < 1:
        raise ValueError(f"split_level: {NN} nodes of {F} fields of {NB} "
                         f"bins outside NN, F >= 1, 2 <= NB <= {MAX_BINS}")
    hist = hist.contiguous()
    dev = hist.device
    cat, cat_bytes = _flags(is_cat_field, F, dev, "is_cat_field")
    mask, mask_bytes = _flags(field_mask, F, dev, "field_mask")
    f32 = torch.empty((4,) + lead, dtype=torch.float32, device=dev)
    i32 = torch.empty((4,) + lead, dtype=torch.int32, device=dev)
    fold = [0, 0, 0, 0, 0] + [None] * 7
    do_split = None
    if tables is not None:
        if hist.ndim != 5:
            raise ValueError("split_level: the fold takes a (K, nn, F, NB, 2) "
                             "histogram")
        K, nn = lead
        n_int, n_leaf = 2 ** depth - 1, 2 ** depth
        if nn != 2 ** level or not 0 <= level < depth:
            raise ValueError(f"split_level: {nn} nodes at level {level} of "
                             f"a depth-{depth} tree")
        do_split = torch.empty((K, nn), dtype=torch.bool, device=dev)
        names = ("feature", "threshold", "is_cat", "default_left")
        ptrs = [_table(t, (K, n_int), torch.int32, dev, name)
                for t, name in zip(tables[:4], names)]
        ptrs += [_table(tables[4], (K, n_leaf), torch.float32, dev,
                        "value_bottom"),
                 _table(tables[5], (K, n_leaf), torch.bool, dev, "value_set")]
        fold = [nn, nn - 1, 2 ** (depth - level), n_int, n_leaf,
                do_split.data_ptr(), *ptrs]
    P, I, FL = _build.POINTER, _build.INT, _build.FLOAT
    fn = _build.function("splits", "split_level_launch",
                         [P, I, I, I, I, P, I, P, I, FL, FL, FL, P, P,
                          I, I, I, I, I, P, P, P, P, P, P, P, P])
    vec = int(NB % 2 == 0 and hist.data_ptr() % 16 == 0)
    err = fn(hist.data_ptr(), NN, F, NB, vec, cat.data_ptr(), cat_bytes,
             mask.data_ptr(), mask_bytes, float(lambda_), float(gamma),
             float(min_child_weight), f32.data_ptr(), i32.data_ptr(), *fold,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check("splits", err, "split_level")
    _build.count("split_level")
    gain, node_g, node_h, left_h = f32.unbind(0)
    feature, threshold, is_cat, default_left = i32.unbind(0)
    return (gain, feature, threshold, is_cat, default_left, node_g, node_h,
            left_h), do_split

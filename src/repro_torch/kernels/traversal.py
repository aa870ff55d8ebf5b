"""Step ⑤ traversal and batch inference: one kernel (``csrc/traversal.cu``).

Replaces ``src/repro/kernels/traversal.py::_traverse_kernel`` (one tree,
and one round's K class trees, which the TPU build vmaps over classes)
and ``::_ensemble_kernel`` (the ensemble sum, with its class route at
K > 1).

Nodes are packed into one int32 word each (:func:`pack_node_table`).  One
kernel body walks T trees over n records and sums tree t into margin
column t % K: a block stages its R records' code rows in shared memory in
a bank-free layout, then blocks of TB trees in turn, each node decoded as
it is staged into the 8 bytes a hop reads (:func:`decode_node_table`
mirrors it); a thread walks U records hop by hop (:func:`ensemble_geometry`
sizes it).  Leaves sum in a
register per record in tree order, class by class, starting from what the
output holds; :func:`predict_ensemble_plain` adds in the same order, so
the two agree bit for bit.  Rows too wide to
stage take the wide entry, which reads the codes from global memory.
Codes are uint8 (n, F) or 4-bit :class:`~repro_torch.core.binning.
PackedCodes` (n, F) over the field axis, which the kernel reads as they lie
(the nibble entry) and never unpacks.

  * :func:`traverse_forest_cuda` — step ⑤: one round's K class trees in
    one launch with T = K, (n, K) out, or added into the margins in place
    (one float add a record and class, as ``margins + leaf``).  Bound by
    bytes: each record's code row in, K floats out.  Counted as
    ``traversal`` (``traversal_wide`` for the wide entry).
    :func:`traverse_cuda` is its K = 1 case.
  * :func:`predict_ensemble_cuda` — batch inference, bound by operations:
    n·T·D dependent hops against one pass over the codes.  Counted as
    ``ensemble`` (``ensemble_wide``).

Decisions are integer-exact: :func:`traverse_forest_cuda` is bit-equal to
:func:`traverse_forest_plain`.  A field id past the code row would read
out of bounds in the kernel, so trees that come from outside are checked
(:func:`check_fields`, one small device->host read); the grower's trees,
whose field ids are < F by construction, skip it (``check_fields=False``).
:func:`launch_tables` is the bare launch on packed tables, with no check,
allocation or host read: the step that ``core/inference.py`` captures in
a CUDA graph.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.core.binning import PackedCodes
from repro_torch.kernels import _build
from repro_torch.kernels.ref import (TreeArrays, ensemble_leaves,
                                     traverse_forest_ref,
                                     traverse_ref as traverse_plain)

MIN_STAGED_TREES = 16        # trees a staged block holds where room allows
PLAIN_ENTRIES = 1 << 26      # node-matrix entries per plain ensemble pass
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


def row_bytes(F: int, packed: bool) -> int:
    """Bytes of one record's code row: F uint8 codes, or ceil(F/2) bytes
    of 4-bit packed ones."""
    return (F + 1) // 2 if packed else F


def tree_bytes(depth: int) -> int:
    """Shared bytes of one staged tree of depth ``depth``: its nodes as
    the kernel decodes them, 8 bytes each (:func:`decode_node_table`),
    then its 2^depth float leaves."""
    n_int = (1 << depth) - 1
    return 8 * n_int + 4 * (n_int + 1)


def max_staged_fields(depth: int, limits: EnsembleLimits,
                      packed: bool = False) -> int:
    """The widest code row, in fields, the staged entry takes: 32 records'
    rows (padded to 4 bytes) and one depth-``depth`` tree in a block's
    shared memory."""
    top = (limits.block_shared - tree_bytes(depth)) // 32 // 4 * 4
    return 2 * top if packed else top


def ensemble_geometry(n: int, F: int, T: int, depth: int,
                      limits: EnsembleLimits,
                      packed: bool = False) -> EnsembleGeometry:
    """The kernel's launch for n records of F fields (uint8, or 4-bit
    ``packed``) over T trees of depth ``depth``; step ⑤ is T = K.

    Staged entry (F up to :func:`max_staged_fields`): a block holds R
    records' code rows, :func:`row_bytes` padded to 4 bytes each, then TB
    trees of :func:`tree_bytes`.  R is the largest of U·threads,
    U·threads − 32U, ..., 32U, 32 (a multiple of 32, so lane l reads bank
    l) whose rows leave room for ``min(T, MIN_STAGED_TREES)`` trees, else
    for one, within ``limits.budget`` (``blocks_per_sm`` blocks an SM), or
    within the block's whole shared memory where not even 32 rows fit the
    budget; no larger than n needs.  TB fills the rest.  Wide entry: one
    record a thread, ``limits.threads`` threads, TB trees within the
    budget.
    """
    tree = tree_bytes(depth)
    if F > max_staged_fields(depth, limits, packed):
        tb = max(1, min(T, limits.budget // tree))
        return EnsembleGeometry(limits.threads, 1, tb, tb * tree, "wide")
    row = 4 * math.ceil(row_bytes(F, packed) / 4)
    U = limits.per_thread
    step = 32 * U
    budget = limits.budget
    if 32 * row + tree > budget:
        budget = limits.block_shared
    top = min(U * limits.threads, step * max(1, math.ceil(n / step)))
    cands = list(range(top, 0, -step)) + [32]
    for need in (min(T, MIN_STAGED_TREES), 1):
        fits = [r for r in cands if r * row + need * tree <= budget]
        if fits:
            R = fits[0]
            break
    tb = min(T, (budget - R * row) // tree)
    return EnsembleGeometry(R, U, tb, R * row + tb * tree, "staged")


def pack_node_table(tree: TreeArrays) -> torch.Tensor:
    """(..., N_int) int32 packed node words
    ``((feature+1) << 16) | (threshold << 8) | (is_cat << 1) | default_left``."""
    return (((tree.feature.to(torch.int32) + 1) << 16)
            | (tree.threshold.to(torch.int32) << 8)
            | (tree.is_cat.to(torch.int32) << 1)
            | tree.default_left.to(torch.int32))


NO_CODE = 0x3FFF            # a decoded node's missing code that none equals


def _int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values of 32 bits as the int32 words that hold them."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def decode_node_table(tables: torch.Tensor, missing_bin: int,
                      records=None, packed: bool = False) -> torch.Tensor:
    """Plain mirror of the kernel's ``decode_node``: each packed node word
    of :func:`pack_node_table` as a hop reads it, two int32 words, so
    (..., N_int, 2).  ``records`` is R, the records of a staged block
    (``None``: the wide entry, which reads the row in global memory).

    Word 0 is (offset << 14) | low.  uint8 codes: field f's code at byte
    offset of the staged rows past 4 x the record's slot ((f >> 2)·R·4 +
    (f & 3)), or of the row (f); low the missing bin where its code would
    go against default_left, else ``NO_CODE``; word 1 a float whose bits
    are the threshold, negative on a numeric node (a pass-through node:
    -256, so every code).  4-bit codes: the word (staged, (f >> 3)·R·4) or
    byte (wide, f >> 1) that holds field f's nibble, low its shift
    (4·(f & 7), 4·(f & 1)); word 1 the codes that go right, code c at bit
    (c + 3) mod 16, in both halves.  :func:`decoded_goes_left` is the
    decision a hop takes from it."""
    p = tables.to(torch.int64)
    f, thr = (p >> 16) - 1, (p >> 8) & 255
    cat, dl, g = (p & 2) != 0, (p & 1) != 0, f.clamp(min=0)
    if packed:
        c = torch.arange(16, device=p.device)
        left = torch.where(cat[..., None], c == thr[..., None],
                           c <= thr[..., None])
        if 0 <= missing_bin < 16:
            left[..., missing_bin] = dl
        left |= (f < 0)[..., None]
        right = ((~left).long() << c).sum(-1)
        mask = ((right << 3) | (right >> 13)) & 0xFFFF
        at = ((((g >> 3) * records * 4) << 14) | ((g & 7) << 2)
              if records else ((g >> 1) << 14) | ((g & 1) << 2))
        return _int32(torch.stack([at, mask | (mask << 16)], -1))
    off = (g >> 2) * records * 4 + (g & 3) if records else g
    inside = torch.where(cat, thr == missing_bin,
                         (0 <= missing_bin) & (missing_bin <= thr))
    flip = (inside != dl) & (0 <= missing_bin < 256)
    node = torch.stack([(off << 14) | torch.where(flip, missing_bin, NO_CODE),
                        torch.where(cat, thr, thr | (1 << 31))], -1)
    through = torch.tensor([NO_CODE, (1 << 31) | 256], device=p.device)
    return _int32(torch.where((f < 0)[..., None], through, node))


def decoded_goes_left(nodes: torch.Tensor, loaded: torch.Tensor,
                      packed: bool = False) -> torch.Tensor:
    """Plain mirror of a hop's decision from nodes of
    :func:`decode_node_table` and what it loaded through them: the code
    byte (uint8) or the code word or byte (4-bit).  uint8: the code c and
    word 1 w read as float32s, left iff (w <= c <= |w|) != (c == the
    missing code); 4-bit: word 1 rotated right by the loaded word shifted
    right by word 0's low 5 bits, left iff its bit 3 is clear."""
    at = nodes[..., 0].long() & 0xFFFFFFFF
    if packed:
        mask = nodes[..., 1].long() & 0xFFFFFFFF
        s = ((loaded.long() & 0xFFFFFFFF) >> (at & 31)) & 31
        rot = ((mask >> s) | (mask << (32 - s))) & 0xFFFFFFFF
        return (rot & 8) == 0
    code = loaded.to(torch.int32)
    c, w = code.view(torch.float32), nodes[..., 1].view(torch.float32)
    miss = (_int32(code.long() << 18 & 0xFFFFFFFF).view(torch.float32)
            == _int32(at << 18 & 0xFFFFFFFF).view(torch.float32))
    return ((c >= w) & (c <= w.abs())) != miss


def traverse_forest_plain(forest: TreeArrays, codes,
                          missing_bin: int) -> torch.Tensor:
    """Plain version of step ⑤: (n, K) leaf values of one round's K class
    trees.  ``PackedCodes`` are read as they lie (each field's nibble),
    as the kernel reads them; a plain (K, n, C) tensor gives each class
    its own codes."""
    if isinstance(codes, PackedCodes):
        return traverse_forest_ref(forest, codes.data, missing_bin,
                                   nibble=True)
    return traverse_forest_ref(forest, codes, missing_bin)


def predict_ensemble_plain(trees: TreeArrays, codes, missing_bin: int,
                           n_classes: int = 1, out=None) -> torch.Tensor:
    """Plain version of the ensemble walk: (n,) sums, or (n, K) for
    ``n_classes`` = K > 1 (tree t into column t % K).  Each record's leaves
    are added one tree at a time, in tree order, onto what ``out`` holds
    ((n, K), or (n,) at K = 1; returned) or onto zeros, as the kernel adds
    them, so the two agree bit for bit.  :func:`ensemble_leaves` walks
    blocks of trees whose (n, trees) node matrix holds at most
    ``PLAIN_ENTRIES`` entries; ``PackedCodes`` are read as they lie."""
    nibble = isinstance(codes, PackedCodes)
    data = (codes.data if nibble else codes).to(torch.int32)
    n, K, T = data.shape[0], n_classes, trees.feature.shape[0]
    if out is None:
        out = torch.zeros((n,) if K == 1 else (n, K),
                          dtype=trees.leaf_value.dtype, device=data.device)
    cols = out.view(n, K).T.contiguous()                        # (K, n)
    step = max(1, PLAIN_ENTRIES // max(n, 1))
    for lo in range(0, T if n else 0, step):
        block = TreeArrays(*[a[lo:lo + step] for a in trees])
        vals = ensemble_leaves(block, data, missing_bin,
                               nibble).T.contiguous()            # (TB, n)
        for t in range(vals.shape[0]):
            cols[(lo + t) % K] += vals[t]
    out.view(n, K).copy_(cols.T)
    return out


def check_fields(tables: torch.Tensor, F: int, what: str) -> None:
    """Refuse trees that split on a field past the code row, which the
    kernel would read out of bounds: one small device->host read."""
    top = int(((tables >> 16) - 1).max()) if tables.numel() else -1
    if top >= F:
        raise ValueError(f"{what}: a tree splits on field {top} but codes "
                         f"have {F} columns")


def _codes_of(codes, what: str):
    """(data, F, packed) of uint8 (n, F) codes or row-major ``PackedCodes``
    (n, F), checked as the kernel takes them."""
    packed = isinstance(codes, PackedCodes)
    data = codes.data if packed else codes
    if data.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {data.device}")
    if data.dtype != torch.uint8 or data.ndim != 2 \
            or not data.is_contiguous():
        raise ValueError(f"{what}: codes must be a contiguous (n, F) uint8 "
                         "tensor or PackedCodes")
    F = codes.shape[1]
    if packed and data.shape[1] != row_bytes(F, True):
        raise ValueError(f"{what}: {data.shape[1]} packed bytes a record do "
                         f"not hold {F} fields")
    if F >= MAX_FIELDS:
        raise ValueError(f"{what}: {F} code columns do not fit the packed "
                         f"node word (< {MAX_FIELDS})")
    return data, F, packed


def node_tables(trees: TreeArrays, what: str):
    """(packed node words (T, N_int) int32, leaves (T, N_leaf) float32,
    depth) of stacked trees, contiguous, as :func:`launch_tables` takes
    them."""
    tables = pack_node_table(trees).contiguous()
    leaves = trees.leaf_value.to(torch.float32).contiguous()
    if tables.ndim != 2:
        raise ValueError(f"{what}: trees must be stacked (T, ...)")
    depth = int(leaves.shape[-1]).bit_length() - 1
    if not 1 <= depth <= 10 or leaves.shape[-1] != 1 << depth \
            or tables.shape[-1] != (1 << depth) - 1:
        raise ValueError(f"{what}: tree tables are not a complete tree of "
                         "depth 1..10")
    return tables, leaves, depth


def launch_tables(tables: torch.Tensor, leaves: torch.Tensor, codes,
                  out: torch.Tensor, n_classes: int, missing_bin: int,
                  counters, what: str) -> None:
    """Walk the trees of :func:`node_tables` over ``codes`` and add each
    record's sums into ``out`` (n, K) float32: one kernel launch on the
    current stream, which allocates nothing and reads nothing back, so a
    CUDA graph can capture it once the kernel has run (the first launch
    builds and loads the library and reads the card's limits).  Field ids
    are not checked here (:func:`check_fields`).  ``counters`` names the
    (staged, wide) launch counts."""
    data, F, packed = _codes_of(codes, what)
    if tables.device != data.device or leaves.device != data.device:
        raise ValueError(f"{what}: trees must lie on {data.device}")
    depth = int(leaves.shape[-1]).bit_length() - 1
    n, T = data.shape[0], tables.shape[0]
    if n == 0 or T == 0:
        return
    geo = ensemble_geometry(n, F, T, depth, ensemble_limits(data.device),
                            packed)
    P, I, I64 = _build.POINTER, _build.INT, _build.INT64
    fn = _build.function("traversal", "ensemble_launch",
                         [P, P, P, P, I64, I, I, I, I, I, I, I, I, I, I, P])
    wide = geo.entry == "wide"
    err = fn(data.data_ptr(), tables.data_ptr(), leaves.data_ptr(),
             out.data_ptr(), n, F, T, n_classes, depth, missing_bin,
             geo.records, geo.trees, geo.smem, int(wide), int(packed),
             torch.cuda.current_stream(data.device).cuda_stream)
    _build.check("traversal", err, what)
    _build.count(counters[1] if wide else counters[0])


def _launch(trees: TreeArrays, codes, out: torch.Tensor, n_classes: int,
            missing_bin: int, check: bool, counters, what: str) -> None:
    """:func:`launch_tables` on ``trees`` (stacked (T, ...), tree t into
    column t % K); ``check``: run :func:`check_fields` first."""
    _, F, _ = _codes_of(codes, what)
    tables, leaves, _ = node_tables(trees, what)
    if check:
        check_fields(tables, F, what)
    launch_tables(tables, leaves, codes, out, n_classes, missing_bin,
                  counters, what)


def _checked_output(out: torch.Tensor, n: int, K: int, device,
                    what: str) -> torch.Tensor:
    """``out`` if the kernel can add into it: contiguous float32 (n, K),
    or (n,) at K = 1, on ``device``."""
    if out.dtype != torch.float32 or not out.is_contiguous() \
            or out.device != device \
            or out.shape not in ((n, K),) + (((n,),) if K == 1 else ()):
        raise ValueError(f"{what} must be a contiguous float32 (n, {K}) "
                         f"tensor on {device}")
    return out


def traverse_forest_cuda(forest: TreeArrays, codes, *, missing_bin: int,
                         margins=None, check_fields: bool = True
                         ) -> torch.Tensor:
    """Step ⑤: one round's K class trees, stacked (K, ...), in one launch.

    codes: (n, F) uint8 or row-major ``PackedCodes`` shared by every class,
    F matching the trees' field ids (on the CPU also a (K, n, C) tensor of
    each class's columns).  Returns (n, K) float32 leaf values; given
    ``margins`` ((n, K) float32, or (n,) at K = 1), adds them into it in
    place instead and returns it.  ``check_fields=False`` skips the
    device->host read of :func:`check_fields`, for trees whose field ids
    are < F by construction.
    """
    K = forest.feature.shape[0]
    if codes.device.type == "cpu":
        delta = traverse_forest_plain(forest, codes, missing_bin)
        return delta if margins is None \
            else margins.add_(delta.reshape(margins.shape))
    if forest.feature.ndim != 2:
        raise ValueError("traversal: trees must be stacked (K, ...)")
    n = codes.shape[0]
    if margins is None:
        # -0.0 + leaf is the leaf bit for bit, a leaf of -0.0 included
        out = torch.full((n, K), -0.0, dtype=torch.float32,
                         device=codes.device)
    else:
        out = _checked_output(margins, n, K, codes.device,
                              "traversal: margins")
    _launch(forest, codes, out, K, missing_bin, check_fields,
            ("traversal", "traversal_wide"), "traversal")
    return out


def traverse_cuda(tree: TreeArrays, codes, *, missing_bin: int
                  ) -> torch.Tensor:
    """One-tree traversal: :func:`traverse_forest_cuda` at K = 1; codes
    (n, C) with C matching tree.feature ids.  Returns (n,) float32 leaf
    values."""
    forest = TreeArrays(*[a[None] for a in tree])
    return traverse_forest_cuda(forest, codes, missing_bin=missing_bin)[:, 0]


def predict_ensemble_cuda(trees: TreeArrays, codes, *, missing_bin: int,
                          n_classes: int = 1, out=None) -> torch.Tensor:
    """Ensemble sums: trees hold stacked (T, ...) arrays; codes (n, F)
    uint8 or row-major ``PackedCodes``.  Returns (n,) float32, or (n, K)
    class margins for ``n_classes`` = K > 1 (trees round-major, tree t
    feeds column t % K).  Given ``out`` ((n, K) float32, or (n,) at
    K = 1, contiguous), each record's leaves are added onto what it holds,
    in tree order, and it is returned."""
    if codes.device.type == "cpu":
        return predict_ensemble_plain(trees, codes, missing_bin, n_classes,
                                      out=out)
    if n_classes < 1:
        raise ValueError(f"predict_ensemble: n_classes {n_classes} < 1")
    n = codes.shape[0]
    if out is None:
        out = torch.zeros((n,) if n_classes == 1 else (n, n_classes),
                          dtype=torch.float32, device=codes.device)
    _launch(trees, codes, _checked_output(out, n, n_classes, codes.device,
                                          "predict_ensemble: out"),
            n_classes, missing_bin, True, ("ensemble", "ensemble_wide"),
            "predict_ensemble")
    return out

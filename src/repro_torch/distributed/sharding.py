"""Distributed GBDT: the paper's parallel decomposition over a device mesh.

The counterpart of :mod:`repro.distributed.sharding`.  Paper §III-B: "the
records can be partitioned among the clusters so that each cluster
generates a set of histograms which are reduced at the end of the step" —
inter-record parallelism over the mesh's data axes.  The group-by-field
mapping (§III-A) lifts to the device level: fields, and their histogram
slabs, shard over ``"model"``.  A level then moves

  * one histogram sum over the data axes (O(nodes·fields·bins) bytes, far
    less than the record stream — the paper's cluster reduction), and
  * one small per-node argmax combine across field shards (step ②).

The port is single-controller, as ``repro`` is: one process holds a
:class:`~repro_torch.launch.mesh.Mesh` of torch devices, each shard's
records live on its device, and a collective is a loop over the shards.
:func:`psum` sums the shards' tensors in a fixed rank order on the group's
first device (its owner) and copies the sum back to each member; between
CUDA devices those copies are device-to-device, so no reduction passes
through host memory, and the fixed order makes every sum deterministic.
A mesh may repeat a device (``[cuda:0] * 4``, ``["cpu"] * 8``): the copies
back are then the sum itself.  :func:`collective_stats` counts the
collectives and their bytes a shard, in the ``{kind: {count, bytes}}``
shape of ``repro``'s ``launch.roofline.parse_collectives`` (an all-reduce
counts its operand twice: reduce and broadcast).

:func:`distributed_histogram`, :func:`distributed_split_combine`,
:func:`distributed_partition_bits` and :func:`distributed_fit_tree` spell
the schedule out on a ``("data", "model")`` mesh; :class:`ShardedRecords`
is the record layout that runs the level loop of ``core.tree``
(:func:`~repro_torch.core.tree.grow_levels`) over data shards, the
histogram sum inserted at step ①, the placement GSPMD infers for
``repro``'s version (:func:`pjit_fit_tree`, ``trainer.train_distributed``).
Growing on field shards unpacks 4-bit codes: a packed field axis cannot be
split mid-byte.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.api.plan import ExecutionPlan, resolve_plan
from repro_torch.core import splits as splits_mod
from repro_torch.core import tree as tree_mod
from repro_torch.core.binning import BinnedDataset, PackedCodes, as_unpacked
from repro_torch.kernels import histogram as hist_k
from repro_torch.kernels import ops
from repro_torch.kernels.ref import TreeArrays
from repro_torch.launch.mesh import Mesh, data_axes, n_data_shards

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
_STATS = {k: {"count": 0, "bytes": 0} for k in COLLECTIVES}
_STATS_LOCK = threading.Lock()


def collective_stats() -> Dict[str, Dict[str, int]]:
    """``{kind: {"count", "bytes"}}`` of the collectives run since the last
    reset: bytes a shard, an all-reduce's operand counted twice."""
    with _STATS_LOCK:
        return copy.deepcopy(_STATS)


def reset_collective_stats() -> Dict[str, Dict[str, int]]:
    """Zero the counters; returns their values before."""
    with _STATS_LOCK:
        before = copy.deepcopy(_STATS)
        for v in _STATS.values():
            v["count"] = v["bytes"] = 0
    return before


def _record(kind: str, n_bytes: int) -> None:
    with _STATS_LOCK:
        _STATS[kind]["count"] += 1
        _STATS[kind]["bytes"] += int(n_bytes)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def on_device(device: torch.device):
    """The CUDA context of ``device`` (kernels launch on the current
    device's stream), or nothing for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def shard_grid(mesh: Mesh) -> np.ndarray:
    """The mesh's devices as a (D, M) grid: the data axes flattened in mesh
    order (D = :func:`n_data_shards`), ``"model"`` last (M = 1 without
    one)."""
    names = mesh.axis_names
    da = [names.index(a) for a in data_axes(mesh)]
    mo = [names.index("model")] if "model" in names else []
    return mesh.devices.transpose(da + mo).reshape(n_data_shards(mesh), -1)


def _sum_in_order(parts: Sequence[torch.Tensor],
                  owner: torch.device) -> torch.Tensor:
    acc = parts[0].to(owner, non_blocking=True)
    for p in parts[1:]:
        acc = acc + p.to(owner, non_blocking=True)
    return acc


def psum_parts(parts: Sequence[torch.Tensor],
               owner: torch.device) -> torch.Tensor:
    """One data-axis all-reduce as the growers take it: the shards' parts
    summed in rank order on ``owner``, where step ② then runs once (the
    decisions, not the sum, go back to the shards)."""
    _record("all-reduce", 2 * _nbytes(parts[0]))
    return _sum_in_order(parts, owner)


def psum(mesh: Mesh, parts, axes) -> List[List[torch.Tensor]]:
    """All-reduce over named axes of a (D, M) grid of per-shard tensors
    (:func:`shard_grid`'s layout): ``axes`` is ``"model"`` or the mesh's
    data axes.  Each group sums in rank order on its first device and every
    member gets the sum on its own device."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    grid = shard_grid(mesh)
    D, M = grid.shape
    if axes == ("model",):
        groups = [[(d, m) for m in range(M)] for d in range(D)]
    elif set(axes) == set(data_axes(mesh)):
        groups = [[(d, m) for d in range(D)] for m in range(M)]
    else:
        raise ValueError(f"psum over {axes}: pass 'model' or every data "
                         f"axis of {mesh.axis_names}")
    out = [[None] * M for _ in range(D)]
    for group in groups:
        owner = grid[group[0]]
        total = _sum_in_order([parts[d][m] for d, m in group], owner)
        for d, m in group:
            out[d][m] = total if grid[d, m] == owner else total.to(grid[d, m])
    _record("all-reduce", 2 * _nbytes(parts[0][0]))
    return out


def all_gather(parts: Sequence[torch.Tensor],
               owner: torch.device) -> torch.Tensor:
    """The shards' parts stacked on ``owner`` (a new leading axis)."""
    out = torch.stack([p.to(owner, non_blocking=True) for p in parts])
    _record("all-gather", _nbytes(out))
    return out


def shard_plan(plan: Optional[ExecutionPlan]) -> ExecutionPlan:
    """The kernels' plan inside a shard: no mesh, no chunking, step ② on
    the device, as ``repro``'s trainer plan.  Unlike ``repro``, which pins
    the reference partition inside ``shard_map``, the CUDA partition
    kernel runs on each shard."""
    return resolve_plan(plan).replace(mesh=None, data_axes=None,
                                      chunk_bytes=None,
                                      host_offload_split=False)


# --------------------------------------------------------------------------
# placement
# --------------------------------------------------------------------------
def padded_record_count(n: int, mesh: Mesh) -> int:
    """Records padded up to a multiple of the data shards (an elastic
    re-mesh can land on a shard count that does not divide n)."""
    d = n_data_shards(mesh)
    return -(-n // d) * d


def pad_edge(x: torch.Tensor, n_pad: int, dim: int) -> torch.Tensor:
    """``x`` padded to ``n_pad`` along ``dim`` by repeating its last
    slice."""
    pad = n_pad - x.shape[dim]
    if pad == 0:
        return x
    edge = x.narrow(dim, x.shape[dim] - 1, 1)
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, edge.expand(shape)], dim=dim)


@dataclasses.dataclass
class ShardedDataset:
    """A binned dataset placed on a mesh's data shards.

    ``shards[d]`` holds padded records ``bounds[d]`` on data shard d's
    device (the model axis holds replicas): row-major codes as they came,
    4-bit packed or not, and a column-major copy, packed where
    ``cm_packed``.  Records ``n_records:n_pad`` replicate the last one;
    trainers give them zero statistics and callers slice their outputs
    off."""

    shards: List[BinnedDataset]
    bounds: List[Tuple[int, int]]
    n_records: int
    n_pad: int
    cm_packed: bool

    @property
    def devices(self) -> List[torch.device]:
        return [s.codes.device for s in self.shards]


def shard_dataset(data: BinnedDataset, mesh: Mesh) -> ShardedDataset:
    """Place ``data`` on the mesh's data shards (see :class:`ShardedDataset`).

    A packed column-major copy ships as its bytes when every shard's record
    count is even (no byte straddles two shards), else unpacked, as
    ``repro``'s trainer places it."""
    n = data.n_records
    n_pad = padded_record_count(n, mesh)
    devices = list(shard_grid(mesh)[:, 0])
    n_l = n_pad // len(devices)
    codes = data.codes
    if isinstance(codes, PackedCodes):
        rm = PackedCodes(pad_edge(codes.data, n_pad, 0), codes.n)
    else:
        rm = pad_edge(codes, n_pad, 0)
    cm_packed = isinstance(data.codes_cm, PackedCodes) and n_l % 2 == 0
    if cm_packed:
        cm_bytes = pad_edge(data.codes_cm.data, n_pad // 2, 1)
    else:
        cm = pad_edge(as_unpacked(data.codes_cm), n_pad, 1)
    shards, bounds = [], []
    for d, dev in enumerate(devices):
        lo, hi = d * n_l, (d + 1) * n_l
        if cm_packed:
            cm_d = PackedCodes(
                cm_bytes[:, lo // 2:hi // 2].to(dev).contiguous(), n_l)
        else:
            cm_d = cm[:, lo:hi].to(dev).contiguous()
        shards.append(dataclasses.replace(
            data, codes=rm[lo:hi].to(dev), codes_cm=cm_d,
            is_categorical=data.is_categorical.to(dev)))
        bounds.append((lo, hi))
    return ShardedDataset(shards, bounds, n, n_pad, cm_packed)


class ShardedRecords:
    """A :class:`ShardedDataset`'s records, each data shard's on its
    device: the record layout of ``core.tree.grow_levels`` over a mesh
    (:func:`pjit_fit_tree`, ``trainer.train_distributed``), the tables and
    step ② on the first shard's device; ``plan`` a :func:`shard_plan`.

    ``g``, ``h``: the (K, n) statistics of all n records, padded with zero
    statistics to ``n_pad`` (+0.0 a histogram cell) and split into each
    shard's (K, n_l) part.  Step ① bins a shard in ``hist_slices`` record
    slices in turn (the device-OOM knob), then sums the shards in rank
    order on the first device.  On the card every shard bins on the
    tree's one fixed-point grid (``core.tree.fixed_point_grid``) and their
    exact int64 sums are summed before one conversion to float32: the
    single-device histogram, bit for bit, at any shard count.  The smaller
    child is picked by record counts summed exactly over the shards, the
    bigger child's statistics masked to zero.  ``node_ids``: each shard's
    (K, n_l) node ids.
    """

    def __init__(self, placed: ShardedDataset, g, h, *, plan: ExecutionPlan,
                 hist_slices: int = 1):
        self.shards = placed.shards
        self.device = placed.devices[0]
        self.n_bins = placed.shards[0].n_bins
        self.plan, self.hist_slices = plan, hist_slices
        self.K = g.shape[0]
        padded = [torch.nn.functional.pad(
            x.to(torch.float32), (0, placed.n_pad - placed.n_records))
            for x in (g, h)]
        self.g, self.h = ([x[:, lo:hi].to(s.codes.device).contiguous()
                           for s, (lo, hi) in zip(placed.shards,
                                                  placed.bounds)]
                          for x in padded)
        self.node_ids = [torch.zeros(g.shape, dtype=torch.int32,
                                     device=g.device) for g in self.g]
        self.scale = tree_mod.fixed_point_grid(list(zip(self.g, self.h)),
                                               plan)
        self.scales = (None if self.scale is None
                       else [self.scale.to(g.device) for g in self.g])

    def _shard_hist(self, i, g, h, nid, n_nodes: int):
        """Shard i's step ①: its int64 sums on the grid (off the grid, the
        float32 histogram), over ``hist_slices`` slices."""
        if self.scales is not None:
            build = functools.partial(hist_k.histogram_sums_cuda,
                                      scale=self.scales[i])
        else:
            build = functools.partial(ops.build_histogram, plan=self.plan)
        codes = self.shards[i].codes
        n_l = g.shape[1]
        size = max(1, -(-n_l // max(self.hist_slices, 1)))
        acc = None
        for lo in range(0, max(n_l, 1), size):
            hi = min(lo + size, n_l)
            part = build(codes[lo:hi], g[:, lo:hi].contiguous(),
                         h[:, lo:hi].contiguous(),
                         nid[:, lo:hi].contiguous(), n_nodes=n_nodes,
                         n_bins=self.n_bins)
            acc = part if acc is None else acc.add_(part)
        return acc

    def histogram(self, n_nodes: int, is_small=None):
        parts = []
        for i, (g, h, nid) in enumerate(zip(self.g, self.h, self.node_ids)):
            with on_device(g.device):
                if is_small is not None:
                    w = torch.gather(is_small.to(g.device), 1,
                                     nid.long()).to(torch.float32)
                    g, h = g * w, h * w
                parts.append(self._shard_hist(i, g, h, nid, n_nodes))
        hist = psum_parts(parts, self.device)
        if self.scale is None:
            return hist
        return hist_k.histogram_from_sums(hist, self.scale)

    def smaller_is_left(self, n_nodes: int):
        counts = psum_parts([tree_mod.node_counts(nid, n_nodes)
                             for nid in self.node_ids], self.device)
        return counts[:, 0::2] <= counts[:, 1::2]

    def partition(self, tables, best, do_split):
        for i, s in enumerate(self.shards):
            dev = self.node_ids[i].device
            with on_device(dev):
                self.node_ids[i] = ops.partition_level_cm(
                    self.node_ids[i], s.codes_cm,
                    *[t if t.device == dev else t.to(dev) for t in tables],
                    missing_bin=self.n_bins - 1, plan=self.plan)

    def bottom_sums(self, n_leaf: int):
        sums = []
        for g, h, nid in zip(self.g, self.h, self.node_ids):
            with on_device(g.device):
                sums.append(tree_mod.bottom_sums(g, h, nid, n_leaf))
        return psum_parts(sums, self.device)


def gbdt_shardings(mesh: Mesh) -> Dict[str, Tuple]:
    """How each training input lies on ``mesh``, as ``repro``'s partition
    specs: ``None`` for a replicated dimension, else the axes that shard
    it."""
    da = data_axes(mesh)
    return {"codes": (da, "model"),        # records x fields
            "codes_cm": ("model", da),     # fields x records
            "per_record": (da,),           # g, h, node ids, y
            "per_field": (None, "model"),
            "replicated": ()}


def _field_blocks(mesh: Mesh, codes, codes_cm, n_fields: int):
    """Row-major and column-major (record block, field block) pieces of a
    (D, M) grid on their devices, and the fields a model shard owns."""
    grid = shard_grid(mesh)
    D, M = grid.shape
    n = codes.shape[0]
    if n % D or n_fields % M:
        raise ValueError(f"{n} records x {n_fields} fields do not divide "
                         f"the ({D}, {M}) data x model grid")
    n_l, f_l = n // D, n_fields // M
    rows = [[codes[d * n_l:(d + 1) * n_l, m * f_l:(m + 1) * f_l]
             .to(grid[d, m]).contiguous() for m in range(M)]
            for d in range(D)]
    cols = None if codes_cm is None else [
        [codes_cm[m * f_l:(m + 1) * f_l, d * n_l:(d + 1) * n_l]
         .to(grid[d, m]).contiguous() for m in range(M)] for d in range(D)]
    return grid, rows, cols, n_l, f_l


def _per_record(grid, x, n_l: int):
    """A per-record tensor's data blocks on every shard of the grid."""
    D, M = grid.shape
    return [[x[..., d * n_l:(d + 1) * n_l].to(grid[d, m]).contiguous()
             for m in range(M)] for d in range(D)]


def _gather_records(grid, parts) -> torch.Tensor:
    """The data blocks of model shard 0 concatenated on the first device."""
    owner = grid[0, 0]
    return torch.cat([parts[d][0].to(owner) for d in range(grid.shape[0])],
                     dim=-1)


# --------------------------------------------------------------------------
# the explicit schedule
# --------------------------------------------------------------------------
def _local_hists(grid, rows, g, h, nid, *, n_nodes: int, n_bins: int,
                 plan: ExecutionPlan, hist_dtype=None):
    D, M = grid.shape
    out = [[None] * M for _ in range(D)]
    for d in range(D):
        for m in range(M):
            with on_device(grid[d, m]):
                hist = ops.build_histogram(rows[d][m], g[d][m], h[d][m],
                                           nid[d][m], n_nodes=n_nodes,
                                           n_bins=n_bins, plan=plan)
            out[d][m] = hist if hist_dtype is None else hist.to(hist_dtype)
    return out


def distributed_histogram(mesh: Mesh, codes, g, h, node_ids, *,
                          n_nodes: int, n_bins: int,
                          plan: Optional[ExecutionPlan] = None,
                          hist_dtype=None) -> torch.Tensor:
    """Step ① with explicit collectives: each (records/D, fields/M) shard
    bins its block, then one sum over the data axes (of the parts cast to
    ``hist_dtype`` when set, as :func:`distributed_fit_tree` sums them).
    Returns the float32 (n_nodes, F, n_bins, 2) histogram (the field blocks
    of model shards side by side) on the mesh's first device."""
    plan = shard_plan(plan)
    codes = as_unpacked(codes)      # the field axis is sharded mid-byte
    grid, rows, _, n_l, _ = _field_blocks(mesh, codes, None, codes.shape[1])
    parts = _local_hists(grid, rows, *(_per_record(grid, x, n_l)
                                       for x in (g, h, node_ids)),
                         n_nodes=n_nodes, n_bins=n_bins, plan=plan,
                         hist_dtype=hist_dtype)
    summed = psum(mesh, parts, data_axes(mesh))
    return torch.cat([p.to(grid[0, 0], torch.float32) for p in summed[0]],
                     dim=-3)


def _combine(grid, hists, is_cat_field, field_mask, lambda_, gamma,
             min_child_weight, f_l: int) -> splits_mod.SplitDecision:
    """Step ② across field shards: each model shard's best split a node
    over its fields, then one all-gather of (NN, 8) candidates and the
    argmax (first shard on ties) on the first device."""
    M = grid.shape[1]
    cands = []
    for m in range(M):
        dev = grid[0, m]
        block = slice(m * f_l, (m + 1) * f_l)
        with on_device(dev):
            best = splits_mod.find_best_splits(
                hists[m], is_cat_field[block].to(dev),
                field_mask[block].to(dev), lambda_, gamma, min_child_weight)
            cands.append(torch.stack([
                best.gain, (best.feature + m * f_l).to(torch.float32),
                best.threshold.to(torch.float32),
                best.is_cat.to(torch.float32),
                best.default_left.to(torch.float32),
                best.node_g, best.node_h, best.left_h], dim=-1))
    allc = all_gather(cands, grid[0, 0])                     # (M, NN, 8)
    win = torch.argmax(allc[..., 0], dim=0)                  # (NN,)
    sel = torch.take_along_dim(allc, win[None, :, None], dim=0)[0]
    i32 = torch.int32
    return splits_mod.SplitDecision(
        gain=sel[:, 0], feature=sel[:, 1].to(i32),
        threshold=sel[:, 2].to(i32), is_cat=sel[:, 3].to(i32),
        default_left=sel[:, 4].to(i32), node_g=sel[:, 5],
        node_h=sel[:, 6], left_h=sel[:, 7])


def distributed_split_combine(mesh: Mesh, hist, is_cat_field, field_mask,
                              lambda_, gamma, min_child_weight,
                              n_fields: int) -> splits_mod.SplitDecision:
    """Step ② across field shards: local best per shard, a small global
    argmax.  ``hist`` is the (NN, F, NB, 2) level histogram."""
    grid = shard_grid(mesh)
    M = grid.shape[1]
    f_l = n_fields // M
    hists = [hist[:, m * f_l:(m + 1) * f_l].to(grid[0, m])
             for m in range(M)]
    return _combine(grid, hists, is_cat_field, field_mask, lambda_, gamma,
                    min_child_weight, f_l)


def _bits_level(mesh: Mesh, grid, cols, nid, feat, thr, cat, dl, *,
                missing_bin: int, f_l: int):
    """Owner-evaluates routing of one level on every shard (see
    :func:`distributed_partition_bits`); returns the new node-id grid."""
    D, M = grid.shape
    verdicts = [[None] * M for _ in range(D)]
    for d in range(D):
        for m in range(M):
            dev = grid[d, m]
            with on_device(dev):
                f, t, c, df = (x.to(dev) for x in (feat, thr, cat, dl))
                owns = (f >= 0) & (torch.div(f, f_l, rounding_mode="floor")
                                   == m)
                local = (f - m * f_l).clamp(0, f_l - 1).long()
                node = nid[d][m].long()
                code = cols[d][m][local].gather(0, node[None])[0].to(
                    torch.int32)
                left = torch.where(c[node] == 1, code == t[node],
                                   code <= t[node])
                left = torch.where(code == missing_bin, df[node] == 1, left)
                verdicts[d][m] = torch.where(
                    owns[node], torch.where(left, 2, 1), 0).to(torch.int8)
    # int8 stays exact: exactly one owner contributes, the total is <= 2
    total = psum(mesh, verdicts, "model")
    return [[(2 * nid[d][m] + (total[d][m] == 1).to(torch.int32))
             for m in range(M)] for d in range(D)]


def distributed_partition_bits(mesh: Mesh, node_ids, codes_cm, feat, thr,
                               cat, dl, *, missing_bin: int,
                               n_fields: int) -> torch.Tensor:
    """Step ③ with owner-evaluates semantics (paper §III-B adapted): the
    model shard that owns a node's split field evaluates the predicate on
    its records and contributes a 2-bit verdict (2 left, 1 right, 0 not the
    owner); one int8 sum over ``"model"`` routes every record.  A node
    without a split (no owner, total 0) passes its records left."""
    codes_cm = as_unpacked(codes_cm)
    grid = shard_grid(mesh)
    D, M = grid.shape
    n_l, f_l = codes_cm.shape[1] // D, n_fields // M
    cols = [[codes_cm[m * f_l:(m + 1) * f_l, d * n_l:(d + 1) * n_l]
             .to(grid[d, m]).contiguous() for m in range(M)]
            for d in range(D)]
    nid = _per_record(grid, node_ids, n_l)
    out = _bits_level(mesh, grid, cols, nid, feat, thr, cat, dl,
                      missing_bin=missing_bin, f_l=f_l)
    return _gather_records(grid, out)


def distributed_fit_tree(mesh: Mesh, codes, codes_cm, g, h, *, depth: int,
                         n_bins: int, missing_bin: int, is_cat_field,
                         field_mask, lambda_: float, gamma: float,
                         min_child_weight: float,
                         plan: Optional[ExecutionPlan] = None,
                         hist_dtype=None, partition_bits: bool = False,
                         return_node_ids: bool = False):
    """The level-wise grower with the paper's explicit schedule on a
    ``("data", "model")`` mesh.

    Per level: each (records, fields) shard's histogram, one sum over the
    data axes (cast to ``hist_dtype`` first when set: ``torch.bfloat16``
    halves the only cross-pod collective), per-shard split search on its
    fields, the small cross-shard argmax, then the partition: with
    ``partition_bits`` the owner-evaluates verdicts
    (:func:`distributed_partition_bits`), else each data shard gathers the
    level's split columns from the model shards that own them (one
    all-gather) and runs ``ops.partition_level``.  Returns the same
    ``TreeArrays`` as ``core.tree.fit_tree``, on the mesh's first device,
    and with ``return_node_ids`` also the records' final leaf slots.
    """
    plan = shard_plan(plan)
    codes, codes_cm = as_unpacked(codes), as_unpacked(codes_cm)
    n, F = codes.shape
    grid, rows, cols, n_l, f_l = _field_blocks(mesh, codes, codes_cm, F)
    D, M = grid.shape
    owner = grid[0, 0]
    is_cat_field = is_cat_field.to(owner)
    field_mask = field_mask.to(owner)
    gs, hs = _per_record(grid, g, n_l), _per_record(grid, h, n_l)
    nid = [[torch.zeros((n_l,), dtype=torch.int32, device=grid[d, m])
            for m in range(M)] for d in range(D)]
    state = tree_mod.tree_tables(1, depth, owner)

    def level_hist(parts):
        summed = psum(mesh, parts, data_axes(mesh))
        return [summed[0][m].to(torch.float32) for m in range(M)]

    for level in range(depth):
        nn = 2 ** level
        hists = level_hist(_local_hists(grid, rows, gs, hs, nid,
                                        n_nodes=nn, n_bins=n_bins, plan=plan,
                                        hist_dtype=hist_dtype))
        cand = _combine(grid, hists, is_cat_field, field_mask, lambda_,
                        gamma, min_child_weight, f_l)
        # fold the combined decision into the tree tables as fit_forest
        # does (only the histogram's node axis and device are read there)
        state, best, do_split = tree_mod.decide_level(
            hists[0][None], level, depth, state, is_cat_field, field_mask,
            lambda_, gamma, min_child_weight, find=lambda *a: cand)
        feat = torch.where(do_split[0], best.feature[0], -1)
        thr, cat, dl = best.threshold[0], best.is_cat[0], best.default_left[0]
        if partition_bits:
            nid = _bits_level(mesh, grid, cols, nid, feat, thr, cat, dl,
                              missing_bin=missing_bin, f_l=f_l)
            continue
        sel = torch.where(do_split[0], best.feature[0], 0)
        col_ids = torch.where(do_split[0],
                              torch.arange(nn, dtype=torch.int32,
                                           device=owner), -1)
        for d in range(D):
            dev = grid[d, 0]
            with on_device(dev):
                s = sel.to(dev)
                owner_m = torch.div(s, f_l, rounding_mode="floor")
                lvl = None
                for m in range(M):
                    piece = cols[d][m][(s - m * f_l).clamp(0, f_l - 1)
                                       .long()].to(dev)
                    lvl = piece if lvl is None else torch.where(
                        (owner_m == m)[:, None], piece, lvl)
                new = ops.partition_level(
                    nid[d][0], lvl.T.contiguous(), col_ids.to(dev),
                    thr.to(dev), cat.to(dev), dl.to(dev),
                    missing_bin=missing_bin, plan=plan)
            nid[d] = [new if m == 0 else new.to(grid[d, m])
                      for m in range(M)]
        if M > 1:       # one gather a card: its (nn, n_l) split columns
            _record("all-gather", _nbytes(lvl))

    # the bottom leaves from per-shard G, H sums, one sum over the data axes
    sums = []
    for d in range(D):
        with on_device(grid[d, 0]):
            sums.append(tree_mod.bottom_sums(gs[d][0][None], hs[d][0][None],
                                             nid[d][0][None], 2 ** depth))
    tree = TreeArrays(*[a[0] for a in tree_mod.settle_leaves(
        state, psum_parts(sums, owner), lambda_)])
    if return_node_ids:
        return tree, _gather_records(grid, nid)
    return tree


def pjit_fit_tree(mesh: Mesh, *, depth: int, n_bins: int, missing_bin: int,
                  lambda_: float, gamma: float, min_child_weight: float,
                  plan: Optional[ExecutionPlan] = None):
    """The level loop of ``core.tree`` on ``mesh`` (:class:`ShardedRecords`),
    with the histogram sum over the data axes inserted at step ①: where
    GSPMD places ``repro``'s collectives.  Records shard over the data
    axes; the model axis holds replicas (step ② runs once, on the first
    device).  Returns ``fn(codes, codes_cm, g, h, is_cat_field,
    field_mask) -> TreeArrays``."""
    plan = shard_plan(plan)

    def fn(codes, codes_cm, g, h, is_cat_field, field_mask):
        data = BinnedDataset(codes, codes_cm, is_cat_field, n_bins,
                             None, None)
        records = ShardedRecords(shard_dataset(data, mesh), g[None], h[None],
                                 plan=plan)
        owner = records.device
        tree = tree_mod.grow_levels(
            records, depth=depth, is_cat_field=is_cat_field.to(owner),
            field_mask=field_mask.to(owner), lambda_=lambda_, gamma=gamma,
            min_child_weight=min_child_weight)
        return TreeArrays(*[a[0] for a in tree])

    return fn

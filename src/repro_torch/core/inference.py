"""Batch inference (paper §III-D) and the serving engine.

The counterpart of :mod:`repro.core.inference`.

* ``predict_margin_cached`` — the compile-once predict engine.  A
  :class:`PredictCache` holds one step per (plan, depth, K, missing bin);
  a request's rows are padded to a power-of-two row bucket (at least
  ``ROW_BUCKET_FLOOR``) and the ensemble to its :func:`bucket_trees`
  bucket, so a stream of varying batch sizes, and a still-growing
  ensemble, meet few shapes.  On the card each (row bucket, tree bucket,
  F) shape is one CUDA graph: it resets a static output buffer from the
  base margin and replays the ensemble kernel's launch
  (``kernels/traversal.py`` :func:`launch_tables`) on static code, node
  table and leaf buffers.  A request copies its codes in (and the trees,
  when another model version last used the graph), replays, and takes a
  copy of its rows.  That is the analogue of ``repro``'s one jitted
  executable per shape: ``stats()["traces"]`` counts captures, and trees
  are arguments, not constants, so a hot-swapped version of the same
  buckets captures nothing.  On the CPU there is no graph: the step runs
  the plain version and counts one trace per new shape, as ``repro``'s jit
  shape cache does.  Padding never changes a result: padded rows are
  dropped, and padded trees (feature -1, leaves 0) add exactly 0.0 to a
  sum taken in tree order, so cached margins equal the direct ones.
* ``sharded_predict`` — "the case of too many trees ... can be addressed
  by distributing the trees to multiple Booster chips (in a simple
  round-robin manner)": trees shard over a mesh's ``"model"`` axis and
  records over its data axes; each shard walks its resident trees over
  its record block (one ensemble launch) and one sum over ``"model"``
  combines the margins.
* ``feature_importance`` — split / gain / cover importances from the tree
  arrays.
* ``GBDTPipeline`` — binner + model: raw float (NaN = missing) matrices
  in, binned on the model's device and predicted through the engine.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.api.plan import ExecutionPlan, resolve_device, resolve_plan
from repro_torch.core.binning import BinnedDataset, Binner, PackedCodes
from repro_torch.core.gbdt import GBDTModel, base_margin_tensor
from repro_torch.kernels import ops
from repro_torch.kernels import traversal as trav_k
from repro_torch.kernels.ref import TreeArrays

ROW_BUCKET_FLOOR = 128      # smallest row-padding bucket (pow2 above this)
_COUNTERS = ("ensemble", "ensemble_wide")
_WHAT = "predict_margin_cached"
# one capture at a time in the process; replays of other graphs go on
_CAPTURE_LOCK = threading.Lock()


def bucket_pow2(x: int, floor: int = 1) -> int:
    """The next power of two >= max(x, floor): the row pad bucket."""
    return max(floor, 1 << max(0, int(x) - 1).bit_length())


def bucket_trees(T: int) -> int:
    """Tree-count pad bucket: the next multiple of 1/16th of T's power of
    two.  Padded trees cost real walk work on every request, so the
    granule caps the padding at T/8 while a growing ensemble meets at most
    16 buckets a doubling."""
    g = max(1, bucket_pow2(T) // 16)
    return -(-int(T) // g) * g


def _inference_plan_key(plan: ExecutionPlan) -> ExecutionPlan:
    """Collapse a plan to the field ensemble inference reads (the traversal
    strategy), so plans that differ only in training-side choices share
    one step."""
    return ExecutionPlan(traversal_strategy=plan.traversal_strategy
                         ).resolved()


class _Tables(NamedTuple):
    """A model's padded ensemble as a graph step reads it."""
    trees: TreeArrays       # padded (TB, ...) trees (the plain version's)
    tables: torch.Tensor    # (TB, N_int) int32 packed node words
    leaves: torch.Tensor    # (TB, N_leaf) float32
    base: torch.Tensor      # (K,) float32 base margin
    top: int                # largest field id a tree splits on, -1 if none


def _model_tables(model: GBDTModel, n_total: int) -> _Tables:
    """``model``'s trees padded to ``n_total``, packed, with the base margin
    and the largest field id (one host read), cached on the model instance
    so repeated requests reuse them."""
    cache = model.__dict__.setdefault("_pad_tree_cache", {})
    entry = cache.get(n_total)
    if entry is None:
        trees = pad_trees(model, n_total).trees if n_total else model.trees
        tables, leaves, _ = trav_k.node_tables(trees, _WHAT)
        base = base_margin_tensor(model.base_margin,
                                  tables.device).reshape(-1)
        top = int(trees.feature.max()) if trees.feature.numel() else -1
        cache[n_total] = entry = _Tables(trees, tables, leaves, base, top)
    return entry


class _Graph:
    """One captured (row bucket, tree bucket, F) shape: static buffers, the
    graph that reads and writes them, the model tables they hold, and a
    lock around copy-in, replay and copy-out (a graph's buffers are not
    reentrant, where a jitted step is)."""

    def __init__(self, rows: int, F: int, tables: _Tables, K: int,
                 missing_bin: int):
        dev = tables.tables.device
        self.codes = torch.zeros((rows, F), dtype=torch.uint8, device=dev)
        self.tables = tables.tables.clone()
        self.leaves = tables.leaves.clone()
        self.base = tables.base.clone()       # a hot swap changes it too
        self.out = torch.empty((rows, K), dtype=torch.float32, device=dev)
        self.K, self.missing_bin = K, missing_bin
        self.loaded = tables
        self.lock = threading.Lock()
        self.graph = None

    def _body(self) -> None:
        # the kernel adds into its output: reset it from the base margin
        # first, or every replay would add onto the last one's sums
        self.out.copy_(self.base.expand_as(self.out))
        trav_k.launch_tables(self.tables, self.leaves, self.codes, self.out,
                             self.K, self.missing_bin, _COUNTERS, _WHAT)

    def capture(self) -> None:
        """Run the step once eagerly on a side stream (the kernel's first
        use builds and loads its library and reads the card's limits,
        which a capture may not), then capture it there.  Thread-local
        capture mode lets other threads replay meanwhile."""
        dev = self.out.device
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            self._body()
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                self._body()
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass        # the capture is already invalid
                raise
            graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(stream)
        self.graph = graph

    def run(self, tables: _Tables, codes: torch.Tensor,
            n: int) -> torch.Tensor:
        """Copy ``codes`` (m <= rows rows) in, and ``tables`` where another
        model version last ran here, replay, and return a copy of the
        first ``n`` rows of the output.  Rows past m keep an earlier
        request's codes: they are walked and dropped."""
        with self.lock:
            if self.loaded is not tables:
                self.tables.copy_(tables.tables)
                self.leaves.copy_(tables.leaves)
                self.base.copy_(tables.base)
                self.loaded = tables
            self.codes[:codes.shape[0]].copy_(codes)
            self.graph.replay()
            return self.out[:n].clone()


class _PredictStep:
    """One (plan, depth, K, missing bin) step of a :class:`PredictCache`:
    a CUDA graph per shape on the card, the plain version on the CPU (and
    under the ``"reference"`` plan)."""

    def __init__(self, cache: "PredictCache", plan: ExecutionPlan,
                 depth: int, n_classes: int, missing_bin: int):
        self._cache = cache
        self.plan = plan
        self.depth, self.K, self.missing_bin = depth, n_classes, missing_bin
        self._graphs: Dict[tuple, _Graph] = {}

    def __call__(self, model: GBDTModel, codes: torch.Tensor, rows: int,
                 n_total: int, n: int) -> torch.Tensor:
        tables = _model_tables(model, n_total)
        F = codes.shape[1]
        if tables.top >= F:
            # checked once per model, where its tables are loaded; a field
            # id past the row would read out of bounds inside the graph
            raise ValueError(f"{_WHAT}: a tree splits on field {tables.top}"
                             f" but codes have {F} columns")
        key = (rows, n_total, F)
        if codes.device.type == "cuda" \
                and self.plan.traversal_strategy == "cuda":
            graph = self._graphs.get(key) or self._capture(key, tables)
            out = graph.run(tables, codes, n)
        else:
            # the trace counts the bucket shape; only the real rows are
            # walked, since padded rows are dropped and no graph needs them
            self._cache._count_trace(self, key)
            out = tables.base.expand(codes.shape[0], self.K).clone()
            ops.predict_ensemble(tables.trees, codes,
                                 missing_bin=self.missing_bin,
                                 depth=self.depth, plan=self.plan,
                                 n_classes=self.K, out=out)
            out = out[:n]
        self._cache._count_replay()
        return out

    def _capture(self, key: tuple, tables: _Tables) -> _Graph:
        with _CAPTURE_LOCK:
            graph = self._graphs.get(key)
            if graph is None:
                rows, _, F = key
                graph = _Graph(rows, F, tables, self.K, self.missing_bin)
                graph.capture()
                self._graphs[key] = graph
                self._cache._count_trace(self, key)
        return graph


class PredictCache:
    """A namespace of predict steps (the serving engine's graph cache).

    Each instance holds its own ``(plan, depth, K, missing bin) -> step``
    table and counters, so multi-tenant serving keys captured graphs per
    model name: two resident models never share a graph, a hot-swapped
    version inherits its predecessor's graphs, and
    ``ModelRegistry.unpublish`` frees exactly one model's.  The
    module-level default instance backs :func:`predict_margin_cached` when
    no ``cache=`` is passed.  Thread-safe: serving threads and an off-path
    warm-up may use one instance at once.
    """

    def __init__(self):
        self._steps: Dict[tuple, _PredictStep] = {}
        self._shapes = set()          # (step, shape) pairs traced
        self._lock = threading.Lock()
        self._hits = self._misses = self._traces = self._replays = 0

    def step(self, plan: ExecutionPlan, depth: int, n_classes: int,
             missing_bin: int) -> _PredictStep:
        key = (plan, depth, n_classes, missing_bin)
        with self._lock:
            step = self._steps.get(key)
            if step is not None:
                self._hits += 1
                return step
            self._misses += 1
            return self._steps.setdefault(
                key, _PredictStep(self, plan, depth, n_classes, missing_bin))

    def _count_trace(self, step: _PredictStep, shape: tuple) -> None:
        """A capture, or on the CPU a shape this step meets first."""
        with self._lock:
            if (id(step), shape) not in self._shapes:
                self._shapes.add((id(step), shape))
                self._traces += 1

    def _count_replay(self) -> None:
        with self._lock:
            self._replays += 1

    def stats(self) -> Dict[str, int]:
        """``entries`` steps, ``traces`` shapes captured (on the CPU: met
        first), ``replays`` step runs (one a request)."""
        with self._lock:
            return {"entries": len(self._steps), "hits": self._hits,
                    "misses": self._misses, "traces": self._traces,
                    "replays": self._replays}

    def clear(self) -> None:
        """Drop every step and its graphs, and zero the counters."""
        with self._lock:
            self._steps.clear()
            self._shapes.clear()
            self._hits = self._misses = self._traces = self._replays = 0


_DEFAULT_CACHE = PredictCache()


def predict_margin_cached(model: GBDTModel, codes, *,
                          plan: Optional[ExecutionPlan] = None,
                          n_rows: Optional[int] = None,
                          cache: Optional[PredictCache] = None
                          ) -> torch.Tensor:
    """Ensemble margins through the compile-once engine: (n,), or (n, K)
    for a K-class model.

    ``codes`` ((m, F) uint8 on the model's device, ``PackedCodes`` or a
    :class:`BinnedDataset`) go into the power-of-two row bucket of m (at
    least ``ROW_BUCKET_FLOOR``) and the ensemble into its
    :func:`bucket_trees` bucket; ``n_rows`` marks the real row count when
    the caller already padded.  ``cache`` selects the step namespace
    (``None``: the process-wide default).  On the card, a new shape is
    captured as a CUDA graph (or the call raises); it never runs eagerly
    instead.
    """
    cache = cache if cache is not None else _DEFAULT_CACHE
    plan = _inference_plan_key(resolve_plan(plan))
    codes = codes.codes if isinstance(codes, BinnedDataset) else codes
    if isinstance(codes, PackedCodes):
        codes = codes.unpack()      # row buckets key on the uint8 layout
    if codes.device != model.trees.feature.device:
        raise ValueError(f"{_WHAT}: codes on {codes.device}, trees on "
                         f"{model.trees.feature.device}")
    m = int(codes.shape[0])
    n = m if n_rows is None else int(n_rows)
    step = cache.step(plan, model.max_depth, model.n_classes,
                      model.missing_bin)
    out = step(model, codes, bucket_pow2(m, ROW_BUCKET_FLOOR),
               bucket_trees(model.n_trees), n)
    return out[:, 0] if model.n_classes == 1 else out


def predict_cache_stats(cache: Optional[PredictCache] = None
                        ) -> Dict[str, int]:
    """Counters of a predict cache (the process-wide default when
    ``cache`` is None); see :meth:`PredictCache.stats`."""
    return (cache if cache is not None else _DEFAULT_CACHE).stats()


def predict_cache_clear(cache: Optional[PredictCache] = None) -> None:
    (cache if cache is not None else _DEFAULT_CACHE).clear()


def pad_trees(model: GBDTModel, multiple: int) -> GBDTModel:
    """Append zero-output pass-through trees (feature -1, leaves 0) until
    the tree count is a multiple of ``multiple``."""
    T = model.n_trees
    pad = -T % multiple
    if pad == 0:
        return model
    t = model.trees

    def pad0(a):
        return torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])

    padded = TreeArrays(
        feature=torch.cat([t.feature, torch.full(
            (pad,) + tuple(t.feature.shape[1:]), -1, dtype=t.feature.dtype,
            device=t.feature.device)]),
        threshold=pad0(t.threshold), is_cat=pad0(t.is_cat),
        default_left=pad0(t.default_left), leaf_value=pad0(t.leaf_value))
    return dataclasses.replace(model, trees=padded)


def sharded_predict(mesh, model: GBDTModel, codes, *,
                    plan: Optional[ExecutionPlan] = None) -> torch.Tensor:
    """Tree-parallel x record-parallel ensemble inference on ``mesh``.

    Needs ``n_trees % mesh.shape["model"] == 0`` and, for a multi-class
    model, a tree count a shard that is a multiple of K, so that tree t
    still feeds class t % K inside a shard (:func:`pad_trees` first).
    Records are padded to divide the data shards (the padding is sliced
    off).  Each (data, model) shard launches ``ops.predict_ensemble`` once
    over its records and its contiguous block of trees; the shards' sums
    are added over ``"model"`` in rank order, and the base margin last.
    Returns (n,), or (n, K) for K classes, on the mesh's first device.
    ``plan`` selects the walk (its own ``mesh`` is ignored: this is the
    mesh dispatch).
    """
    from repro_torch.distributed.sharding import (on_device, pad_edge,
                                                  psum, shard_grid)

    grid = shard_grid(mesh)
    D, M = grid.shape
    T, K = model.n_trees, model.n_classes
    if T % M:
        raise ValueError(f"{T} trees do not divide the model axis ({M}); "
                         "use pad_trees() first")
    if K > 1 and (T // M) % K:
        raise ValueError(
            f"{T} trees over {M} shards leave {T // M} trees a shard, not a "
            f"multiple of n_classes={K}; use pad_trees(model, {M * K}) so "
            "that class routing survives sharding")
    plan = resolve_plan(plan).replace(mesh=None, data_axes=None)
    codes = codes.codes if isinstance(codes, BinnedDataset) else codes
    n = codes.shape[0]
    n_l = -(-n // D)
    if isinstance(codes, PackedCodes):
        codes = PackedCodes(pad_edge(codes.data, n_l * D, 0), codes.n)
    else:
        codes = pad_edge(codes, n_l * D, 0)
    t_l = T // M
    parts = [[None] * M for _ in range(D)]
    for d in range(D):
        for m in range(M):
            dev = grid[d, m]
            trees = TreeArrays(*[a[m * t_l:(m + 1) * t_l].to(dev)
                                 for a in model.trees])
            with on_device(dev):
                parts[d][m] = ops.predict_ensemble(
                    trees, codes[d * n_l:(d + 1) * n_l].to(dev),
                    missing_bin=model.missing_bin, depth=model.max_depth,
                    plan=plan, n_classes=K)
    summed = psum(mesh, parts, "model")          # paper §III-D's combine
    owner = grid[0, 0]
    out = torch.cat([summed[d][0].to(owner) for d in range(D)])[:n]
    return out + base_margin_tensor(model.base_margin, owner)


def feature_importance(model: GBDTModel, kind: str = "gain") -> np.ndarray:
    """Per-field importance over the ensemble, normalized to sum 1.

    kind: "split" (split counts), "gain" (the variance of the leaves under
    each split stands in for its gain, which the tree arrays do not keep),
    or "cover" (that variance weighted by the subtree's width).
    """
    feats = model.trees.feature.cpu().numpy()                  # (T, n_int)
    leaves = model.trees.leaf_value.cpu().numpy().astype(np.float64)
    F = model.n_fields
    imp = np.zeros((F,), np.float64)
    T = feats.shape[0]
    depth = model.max_depth
    if kind == "split":
        valid = feats >= 0
        np.add.at(imp, feats[valid], 1.0)
    else:
        # the heap positions at ``level`` cover the bottom row in runs of
        # reps = 2**(depth - level) leaves: one reshape per level
        for level in range(depth):
            nn = 2 ** level
            reps = 2 ** (depth - level)
            f_lvl = feats[:, nn - 1:2 * nn - 1]                # (T, nn)
            var = leaves.reshape(T, nn, reps).var(axis=2)      # (T, nn)
            w = float(reps) if kind == "cover" else 1.0
            valid = f_lvl >= 0
            np.add.at(imp, f_lvl[valid], w * var[valid])
    s = imp.sum()
    return imp / s if s > 0 else imp


@dataclasses.dataclass
class GBDTPipeline:
    """Binner + model: raw float (NaN = missing) matrices in, predictions
    out, on the model's device.

    ``predict``/``predict_margin`` are the serving path: the raw batch is
    binned on the device (``Binner.transform_codes_device``) and goes
    through :func:`predict_margin_cached`.
    """

    binner: Binner
    model: GBDTModel

    @property
    def device(self) -> torch.device:
        return self.model.trees.feature.device

    def predict_margin(self, X, *, plan: Optional[ExecutionPlan] = None,
                       mode: str = "cached",
                       cache: Optional[PredictCache] = None) -> torch.Tensor:
        """Raw margins for a raw feature matrix.  ``mode="cached"`` (the
        serving default) goes through the engine; ``mode="direct"`` walks
        the exact request shape (one-off calls that should not populate a
        cache)."""
        if mode not in ("cached", "direct"):
            raise ValueError(f"unknown predict mode {mode!r}; choose "
                             "'cached' or 'direct'")
        codes = self.binner.transform_codes_device(
            np.asarray(X, dtype=np.float32), device=self.device)
        if mode == "direct":
            return self.model.predict_margin(codes, plan=plan)
        return predict_margin_cached(self.model, codes, plan=plan,
                                     cache=cache)

    def predict(self, X, *, plan: Optional[ExecutionPlan] = None,
                mode: str = "cached",
                cache: Optional[PredictCache] = None) -> torch.Tensor:
        return self.model.loss.transform(
            self.predict_margin(X, plan=plan, mode=mode, cache=cache))

    def to_state(self) -> Dict:
        """Numpy state in the layout of ``repro``'s
        ``GBDTPipeline.to_state``."""
        return {
            "model": self.model.to_state(),
            "binner": {
                "max_bins": self.binner.max_bins,
                "categorical": sorted(self.binner.categorical_fields),
                "edges": self.binner._edges,
                "is_cat": self.binner._is_cat,
                "n_value_bins": self.binner._n_value_bins,
            },
        }

    @classmethod
    def from_state(cls, state: Dict, device=None) -> "GBDTPipeline":
        """Rebuild from either package's ``to_state`` (trees on ``device``,
        CUDA by default)."""
        b = state["binner"]
        binner = Binner.from_arrays(int(b["max_bins"]), b["edges"],
                                    b["is_cat"], b["n_value_bins"])
        return cls(binner=binner,
                   model=GBDTModel.from_state(state["model"],
                                              device=resolve_device(device)))

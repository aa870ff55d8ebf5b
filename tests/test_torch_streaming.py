"""The port's out-of-core path against the JAX package, on the CPU.

Identical numpy inputs (from a seed) go to ``repro`` (CPU, ``scatter``
histograms, its host-loop ``train_streaming``) and to the port (CPU, the
kernels' plain versions):

* the quantile sketch and ``StreamingBinner``: edges equal to ``repro``'s,
  below the sketch's capacity and beyond it; below it equal to ``Binner``;
* the device binning of a streamed chunk (``Binner.transform_chunk``), run
  here on the CPU: bit-equal to the host's ``transform_codes`` at values
  on the edges and their float32 roundings, NaN, ±inf, −0.0 and
  categorical values out of range;
* the sources and shards (npz and binned, crc32 manifests), read across
  packages both ways, and ``SyntheticSource``;
* the chunked grower: ``accumulate_histogram`` over padded chunks, and
  ``fit_forest_chunked`` against ``repro``'s at K = 1 and K = 3, uint8 and
  packed, with and without ``hist_subtraction``, on dyadic statistics;
* ``train_streaming`` against ``repro``'s (warm start, eval set, early
  stopping), the packed stream against the uint8 one, the stream against
  the port's in-memory ``train``;
* the estimators' ``fit(data=...)`` on every input form.

Where the port differs from ``repro`` on purpose, the test says so.
"""
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import BoosterClassifier as JaxClassifier
from repro.api import BoosterRegressor as JaxRegressor
from repro.api import ExecutionPlan as JaxPlan
from repro.core import binning as jax_binning
from repro.core import gbdt as jax_gbdt
from repro.core import tree as jax_tree
from repro.data import pipeline as jax_pipeline
from repro.data import synthetic as jax_synthetic
from repro.kernels import ops as jax_ops

from repro_torch.api import (ArraySource, BoosterClassifier,
                             BoosterRegressor, DataSource, ExecutionPlan,
                             NpzShardSource, SyntheticSource,
                             write_npz_shards)
from repro_torch.core import binning, gbdt, tree
from repro_torch.core.binning import Binner, PackedCodes, StreamingBinner
from repro_torch.data import make_tabular, pipeline
from repro_torch.distributed import sharding
from repro_torch.kernels import ops
from repro_torch.kernels.ref import TreeArrays
from repro_torch.launch.mesh import make_mesh
from repro_torch.resilience import ShardCorruptionError, corrupt_file

SCATTER = JaxPlan(hist_strategy="scatter")


def _materialize(src, n):
    xs, ys = zip(*src.chunks(n))
    return np.concatenate(xs), np.concatenate(ys)


def _assert_trees(a, b, leaf_rtol=None, jax=False):
    """Tree tables equal; leaves bit-equal, or within ``leaf_rtol`` plus
    1e-6.  Against ``jax`` the split fields are compared where a node
    splits: a pass-through node's threshold is read by no record and may
    differ (ROADMAP Queue 3)."""
    live = np.asarray(a.feature) >= 0
    for field in ("feature", "threshold", "is_cat", "default_left",
                  "leaf_value"):
        u = np.asarray(getattr(a, field))
        v = np.asarray(getattr(b, field))
        if jax and field in ("threshold", "is_cat", "default_left"):
            u, v = u[live], v[live]
        if field == "leaf_value" and leaf_rtol is not None:
            np.testing.assert_allclose(u, v, rtol=leaf_rtol, atol=1e-6,
                                       err_msg=field)
        else:
            np.testing.assert_array_equal(u, v, err_msg=field)


# --------------------------------------------------------------------------
# the sketch binner
# --------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["below_capacity", "beyond_capacity"])
def test_sketch_edges_match_jax(case):
    """The port's ``StreamingBinner`` is ``repro``'s numpy code: the same
    chunks give the same edges, exact below the sketch's capacity (and then
    equal to ``Binner.fit``) and compressed beyond it."""
    rng = np.random.default_rng(0)
    if case == "below_capacity":
        X = rng.normal(size=(1500, 7))
        X[rng.uniform(size=X.shape) < 0.05] = np.nan
        X[:, 5] = rng.integers(0, 9, size=1500)        # categorical field
        kw, step = dict(max_bins=32, categorical_fields=[5],
                        sketch_size=2000), 311
    else:
        X = np.concatenate([rng.normal(size=(4000, 3)),
                            rng.exponential(size=(4000, 3))])
        kw, step = dict(max_bins=64, sketch_size=512), 1000
    ours, theirs = StreamingBinner(**kw), jax_binning.StreamingBinner(**kw)
    for lo in range(0, X.shape[0], step):             # ragged chunking
        ours.partial_fit(X[lo:lo + step])
        theirs.partial_fit(X[lo:lo + step])
    ours.finalize()
    theirs.finalize()
    for name in ("_edges", "_is_cat", "_n_value_bins"):
        np.testing.assert_array_equal(getattr(ours, name),
                                      getattr(theirs, name), err_msg=name)
    assert ours.n_rows_seen == theirs.n_rows_seen == X.shape[0]
    exact = Binner(kw["max_bins"], kw.get("categorical_fields")).fit(X)
    if case == "below_capacity":
        np.testing.assert_array_equal(exact._edges, ours._edges)
        np.testing.assert_array_equal(exact.transform_codes(X),
                                      ours.transform_codes(X))
    else:
        agree = np.mean(exact.transform_codes(X) == ours.transform_codes(X))
        assert 0.95 < agree < 1.0


def test_streaming_binner_refit_and_refusals():
    """``fit`` recomputes from scratch (``Binner`` semantics); a chunk of
    another width and a finalize before any chunk raise."""
    rng = np.random.default_rng(4)
    X1 = rng.normal(size=(300, 2))
    X2 = rng.normal(size=(300, 2)) + 5.0
    b = StreamingBinner(max_bins=16)
    b.fit(X1)
    b.fit(X2)
    fresh = StreamingBinner(max_bins=16).fit(X2)
    np.testing.assert_array_equal(b._edges, fresh._edges)
    assert b.n_rows_seen == 300
    src = ArraySource(X2, np.zeros(300))
    np.testing.assert_array_equal(
        StreamingBinner(max_bins=16).fit_source(src, 77)._edges,
        fresh._edges)
    sk = StreamingBinner(max_bins=16).partial_fit(np.zeros((4, 3)))
    with pytest.raises(ValueError, match="fields"):
        sk.partial_fit(np.zeros((4, 5)))
    with pytest.raises(RuntimeError, match="finalize"):
        StreamingBinner(max_bins=16).finalize()
    with pytest.raises(ValueError, match="capacity"):
        binning._QuantileSketch(4)


# --------------------------------------------------------------------------
# device binning of a streamed chunk (run here on the CPU)
# --------------------------------------------------------------------------
def _edge_fixture(max_bins, seed=0):
    """200,000 values a field: normals, the float32 roundings of the fitted
    edges (the values a float32 edge table misplaces), NaN, ±inf, ±0.0,
    huge values, and (where the bins hold its 12 categories) a categorical
    field with negative, fractional and out-of-range categories."""
    rng = np.random.default_rng(seed)
    n = 200_000
    X = rng.normal(size=(n, 4))
    X[:, 3] = rng.integers(-3, 12, size=n) + rng.uniform(-0.9, 0.9, size=n)
    binner = Binner(max_bins, [3] if max_bins >= 16 else []).fit(X)
    e = binner._edges[0][np.isfinite(binner._edges[0])]
    if e.size:
        f32 = e.astype(np.float32).astype(np.float64)
        X[:254, 0] = np.resize(np.concatenate([f32, e]), 254)
        X[300:300 + e.size, 2] = np.nextafter(e, -np.inf)
    X[254:262, 0] = [np.nan, np.inf, -np.inf, -0.0, 0.0, 1e300, -1e300,
                     5e-324]
    X[262:274, 3] = [np.nan, np.inf, -np.inf, -0.0, 1e19, -1e19, 9e18,
                     -0.5, 3.99, 200, 2.0 ** 63, -2.0 ** 63]
    X[274:290, 1] = np.nan
    return binner, X


@pytest.mark.parametrize("max_bins", [2, 16, 256])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_transform_chunk_bit_equal_to_host(max_bins, dtype, monkeypatch):
    """The streamed chunk's binning casts the source's floats to float64
    and searches float64 edges: bit-equal to ``transform_codes`` on every
    value, in blocks of rows or all at once (the float32 tables of
    ``transform_codes_device`` miss some of these values)."""
    binner, X = _edge_fixture(max_bins)
    with warnings.catch_warnings():
        # 1e300 overflows float32; inf casts to int64 as INT64_MIN
        warnings.simplefilter("ignore", RuntimeWarning)
        X = X.astype(dtype)
        want = binner.transform_codes(X)
    for block in (1 << 12, 1 << 25):
        monkeypatch.setattr(binning, "_BIN_BLOCK_BYTES", block)
        got = binner.transform_chunk(torch.from_numpy(X))
        assert got.dtype == torch.uint8 and got.shape == X.shape
        np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------
# sources and shards
# --------------------------------------------------------------------------
def test_synthetic_source_chunk_invariant_and_equal_to_jax():
    src = SyntheticSource(5000, 6, seed=11)
    big = _materialize(src, 5000)
    small = _materialize(src, 613)
    theirs = _materialize(jax_synthetic.SyntheticSource(5000, 6, seed=11),
                          997)
    for a, b, c in zip(big, small, theirs):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    Xb, yb = _materialize(SyntheticSource(3000, 4, task="binary",
                                          missing_rate=0.1, seed=3), 700)
    assert set(np.unique(yb)) <= {0.0, 1.0} and np.isnan(Xb).any()
    with pytest.raises(ValueError, match="task"):
        SyntheticSource(10, 2, task="ranking")


def test_npz_shards_roundtrip_and_clear_stale(tmp_path):
    src = SyntheticSource(3000, 4, seed=13)
    paths = write_npz_shards(str(tmp_path), src, rows_per_shard=700)
    assert len(paths) == 5 and os.path.exists(tmp_path / "manifest.json")
    back = NpzShardSource(str(tmp_path))
    assert back.n_fields == 4
    for a, b in zip(_materialize(src, 997), _materialize(back, 997)):
        np.testing.assert_array_equal(a, b)             # shard-crossing
    write_npz_shards(str(tmp_path), SyntheticSource(500, 4, seed=2),
                     rows_per_shard=400)
    assert sum(x.shape[0] for x, _ in
               NpzShardSource(str(tmp_path)).chunks(1000)) == 500


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_shards_cross_read(writer, tmp_path):
    """npz shards, binned shards and their manifests are one format: what
    either package writes, the other reads (and verifies) alike."""
    X, y = _materialize(SyntheticSource(900, 5, seed=5), 900)
    ours_b = Binner(16).fit(X)
    theirs_b = jax_binning.Binner(16).fit(X)
    w_pipe = pipeline if writer == "port" else jax_pipeline
    w_bin = ours_b if writer == "port" else theirs_b
    src = (ArraySource if writer == "port" else jax_pipeline.ArraySource)(
        X, y)
    w_pipe.write_npz_shards(str(tmp_path / "raw"), src, rows_per_shard=400)
    w_pipe.write_binned_shards(str(tmp_path / "bin"), src, w_bin,
                               rows_per_shard=400)
    for read in (pipeline, jax_pipeline):
        for a, b in zip(_materialize(
                read.NpzShardSource(str(tmp_path / "raw")), 250), (X, y)):
            np.testing.assert_array_equal(a, b)
        bsrc = read.BinnedShardSource(str(tmp_path / "bin"))
        assert bsrc.packed and bsrc.n_fields == 5
        codes = np.concatenate([np.asarray(c) for c, _ in bsrc.chunks(128)])
        np.testing.assert_array_equal(codes, ours_b.transform_codes(X))


@pytest.mark.parametrize("packed", [True, False])
def test_binned_shards_and_corruption(packed, tmp_path):
    """Binned shards read back as the host's codes (``PackedCodes`` sliced
    without unpacking when packed); a corrupt shard raises at open and on
    read, and a file the manifest does not list is refused."""
    X, y = _materialize(SyntheticSource(500, 4, seed=5), 500)
    binner = StreamingBinner(max_bins=16, sketch_size=1024).fit(X)
    paths = pipeline.write_binned_shards(str(tmp_path), ArraySource(X, y),
                                         binner, rows_per_shard=200,
                                         packed=packed)
    src = pipeline.BinnedShardSource(str(tmp_path))
    chunks = list(src.chunks(128))
    assert all(isinstance(c, PackedCodes) == packed for c, _ in chunks)
    np.testing.assert_array_equal(
        np.concatenate([np.asarray(c) for c, _ in chunks]),
        binner.transform_codes(X))
    np.testing.assert_array_equal(np.concatenate([v for _, v in chunks]), y)
    corrupt_file(paths[-1], seed=2)
    with pytest.raises(ShardCorruptionError, match="crc32"):
        list(pipeline.BinnedShardSource(str(tmp_path)).chunks(128))
    corrupt_file(paths[0], seed=1)
    with pytest.raises(ShardCorruptionError, match="crc32"):
        pipeline.BinnedShardSource(str(tmp_path))
    with pytest.raises(ValueError, match="max_bins"):
        pipeline.write_binned_shards(str(tmp_path / "w"), ArraySource(X, y),
                                     Binner(32).fit(X), packed=True)


def test_as_source_coercions(tmp_path):
    X, y = np.zeros((10, 2)), np.zeros(10)
    assert isinstance(pipeline.as_source((X, y)), ArraySource)
    src = ArraySource(X, y)
    assert pipeline.as_source(src) is src and isinstance(src, DataSource)
    write_npz_shards(str(tmp_path), src, rows_per_shard=5)
    assert isinstance(pipeline.as_source(str(tmp_path)), NpzShardSource)
    with pytest.raises(TypeError, match="DataSource"):
        pipeline.as_source(42)
    with pytest.raises(ValueError, match="2-D"):
        ArraySource(np.zeros(4))
    with pytest.raises(ValueError, match="rows"):
        ArraySource(X, np.zeros(9))


@pytest.mark.parametrize("case", ["mixed_widths", "misaligned_labels",
                                  "no_shards"])
def test_npz_shard_source_refusals(case, tmp_path):
    """``chunks`` names the shard whose width or labels are off (a silent
    width change would bin garbage mid-pass)."""
    if case == "no_shards":
        with pytest.raises(FileNotFoundError):
            NpzShardSource(str(tmp_path))
        return
    if case == "mixed_widths":
        np.savez(tmp_path / "a.npz", X=np.zeros((4, 3), np.float32))
        np.savez(tmp_path / "b.npz", X=np.zeros((4, 5), np.float32))
        bad = "b.npz"
    else:
        np.savez(tmp_path / "a.npz", X=np.zeros((4, 3), np.float32),
                 y=np.zeros((3,), np.float32))
        bad = "a.npz"
    with pytest.raises(ValueError, match=bad):
        list(NpzShardSource(str(tmp_path)).chunks(10))


@pytest.mark.parametrize("device", [None, "cpu"])
def test_prefetch_iterator_close_releases_worker(device):
    """Abandoning the stream early must not leave the put-blocked worker
    parked: ``close`` runs the generator's ``finally``.  The port's
    iterator takes a ``device`` where ``repro``'s takes ``shardings``: on
    the CPU numpy leaves become tensors, without it they pass through."""
    cleaned = []

    def gen():
        try:
            for i in range(1000):
                yield {"i": np.array([i], np.int32), "tag": "x"}
        finally:
            cleaned.append(True)

    with pipeline.PrefetchIterator(gen(), device=device, depth=2) as it:
        first = next(it)
    kind = torch.Tensor if device == "cpu" else np.ndarray
    assert isinstance(first["i"], kind) and first["tag"] == "x"
    assert cleaned == [True] and not it._thread.is_alive()
    it.close()                                           # idempotent
    got = [int(b[0][0]) for b in pipeline.PrefetchIterator(
        ((np.array([i]),) for i in range(7)), device=device, depth=3)]
    assert got == list(range(7))
    with pytest.raises(ValueError, match="depth"):
        pipeline.PrefetchIterator(iter(()), depth=0)


def test_prefetch_iterator_surfaces_worker_errors():
    def gen():
        yield np.zeros(2)
        raise OSError("flaky read")

    it = pipeline.PrefetchIterator(gen(), device="cpu")
    next(it)
    with pytest.raises(OSError, match="flaky"):
        next(it)
    it.close()


def test_record_shards_and_degradation_stats():
    """``record_shards`` streams record blocks; the port's kernels never
    demote, so the degradation counters ``repro`` exports stay empty."""
    codes = np.arange(20, dtype=np.uint8).reshape(10, 2)
    g, h = np.arange(10.0), np.ones(10)
    blocks = list(pipeline.record_shards(codes, g, h, 4))
    assert [b["codes"].shape[0] for b in blocks] == [4, 4, 2]
    np.testing.assert_array_equal(np.concatenate([b["g"] for b in blocks]),
                                  g)
    assert ops.degradation_stats() == {} == ops.reset_degradation_stats()
    assert isinstance(jax_ops.degradation_stats(), dict)


# --------------------------------------------------------------------------
# the chunked grower
# --------------------------------------------------------------------------
def _grower_inputs(n, F, K, n_bins, seed):
    """Codes (10 % missing, one categorical field of 3 categories) and
    dyadic (K, n) statistics: every sum is exact in any order."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, n_bins - 1, (n, F)).astype(np.uint8)
    codes[:, 1] = rng.integers(0, 3, n)
    codes[rng.uniform(size=codes.shape) < 0.1] = n_bins - 1
    is_cat = np.zeros(F, bool)
    is_cat[1] = True
    g = (rng.integers(-64, 65, (K, n)) / 64).astype(np.float32)
    h = (rng.integers(1, 65, (K, n)) / 64).astype(np.float32)
    return codes, is_cat, g, h


def _chunk_stream(codes, rows, packed, port):
    """``(lo, hi, codes)`` chunks of ``rows`` records, the last one padded
    with zero codes, as ``repro``'s trainer pads them."""
    n = codes.shape[0]
    pack = PackedCodes.pack_np if port else jax_binning.PackedCodes.pack_np

    def chunks():
        for lo in range(0, n, rows):
            hi = min(lo + rows, n)
            c = np.pad(codes[lo:hi], ((0, rows - (hi - lo)), (0, 0)))
            if packed:
                c = pack(c)
            elif port:
                c = torch.from_numpy(c)
            yield lo, hi, c
    return chunks


@pytest.mark.parametrize("K", [1, 3])
def test_accumulate_histogram_over_padded_chunks(K):
    """The chunked step ① over padded chunks is bit-equal to the whole
    histogram on dyadic statistics: a zero-statistic pad adds +0.0."""
    codes, _, g, h = _grower_inputs(700, 5, K, 16, 2)
    nid = np.random.default_rng(3).integers(0, 4, (K, 700)).astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    full = ops.build_histogram(t(codes), t(g), t(h), t(nid), n_nodes=4,
                               n_bins=16)
    acc = torch.zeros_like(full)
    for lo in range(0, 700, 256):
        hi = min(lo + 256, 700)
        pad = 256 - (hi - lo)
        acc = ops.accumulate_histogram(
            acc, t(np.pad(codes[lo:hi], ((0, pad), (0, 0)))),
            t(np.pad(g[:, lo:hi], ((0, 0), (0, pad)))),
            t(np.pad(h[:, lo:hi], ((0, 0), (0, pad)))),
            t(np.pad(nid[:, lo:hi], ((0, 0), (0, pad)))), n_nodes=4,
            n_bins=16)
    assert torch.equal(full, acc)


def _port_chunked(codes, is_cat, g, h, rows, packed, sub, depth=3,
                  n_bins=16):
    F = codes.shape[1]
    return tree.fit_forest_chunked(
        _chunk_stream(codes, rows, packed, True), g, h, depth=depth,
        n_bins=n_bins, missing_bin=n_bins - 1,
        is_cat_field=torch.as_tensor(is_cat),
        field_mask=torch.ones(F, dtype=torch.bool), lambda_=1.0, gamma=0.0,
        min_child_weight=1.0, plan=ExecutionPlan(hist_subtraction=sub))


@pytest.mark.parametrize("sub", [False, True], ids=["direct", "subtraction"])
@pytest.mark.parametrize("packed", [False, True], ids=["uint8", "packed"])
@pytest.mark.parametrize("K", [1, 3])
def test_fit_forest_chunked_matches_jax(K, packed, sub):
    """Trees and final node ids bit-equal to ``repro``'s chunked grower;
    leaves within ROADMAP's rtol 1e-5 (bit-equal here: dyadic stats)."""
    codes, is_cat, g, h = _grower_inputs(500, 6, K, 16, 10 + K)
    ours, ids = _port_chunked(codes, is_cat, g, h, 96, packed, sub)
    theirs, jids = jax_tree.fit_forest_chunked(
        _chunk_stream(codes, 96, packed, False), g, h, depth=3, n_bins=16,
        missing_bin=15, is_cat_field=jnp.asarray(is_cat),
        field_mask=jnp.ones(6, bool), lambda_=1.0, gamma=0.0,
        min_child_weight=1.0,
        plan=JaxPlan(hist_strategy="scatter", hist_subtraction=sub))
    _assert_trees(ours, theirs, leaf_rtol=1e-5, jax=True)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert ids.shape == (K, 500) and ids.dtype == torch.int32


@pytest.mark.parametrize("sub", [False, True], ids=["direct", "subtraction"])
@pytest.mark.parametrize("K", [1, 3])
def test_fit_forest_chunked_equals_fit_forest(K, sub):
    """On exact-grid statistics the three record layouts of the level loop
    grow one tree: chunked, in memory and sharded over a 2-shard mesh give
    the same trees and the same final node ids, with and without
    histogram subtraction, though each picks the smaller child by its own
    rule (on the card the first two are phase 7's gate (a))."""
    codes, is_cat, g, h = _grower_inputs(600, 5, K, 32, 20 + K)
    chunked, ids = _port_chunked(codes, is_cat, g, h, 128, False, sub,
                                 depth=4, n_bins=32)
    data = binning.dataset_from_codes(codes, is_cat, n_bins=32,
                                      packed=False, device="cpu")
    plan = ExecutionPlan(hist_subtraction=sub).resolved()
    grow = dict(depth=4, is_cat_field=data.is_categorical,
                field_mask=torch.ones(5, dtype=torch.bool), lambda_=1.0,
                gamma=0.0, min_child_weight=1.0)
    seen = []
    real = ops.partition_level_cm

    def spy(*a, **kw):
        seen.append(real(*a, **kw))
        return seen[-1]

    ops.partition_level_cm = spy
    try:
        whole = tree.fit_forest(
            data.codes, data.codes_cm, torch.from_numpy(g),
            torch.from_numpy(h), n_bins=32, missing_bin=31, plan=plan,
            **grow)
    finally:
        ops.partition_level_cm = real
    _assert_trees(chunked, whole)
    assert torch.equal(ids, seen[-1])
    mesh = make_mesh((2,), ("data",), devices=["cpu"] * 2)
    sharded = sharding.ShardedRecords(
        sharding.shard_dataset(data, mesh), torch.from_numpy(g),
        torch.from_numpy(h), plan=plan)
    _assert_trees(chunked, tree.grow_levels(sharded, **grow))
    assert torch.equal(ids, torch.cat(sharded.node_ids, dim=1))
    if K == 1:
        pjit = sharding.pjit_fit_tree(
            mesh, depth=4, n_bins=32, missing_bin=31, lambda_=1.0,
            gamma=0.0, min_child_weight=1.0, plan=plan)(
                data.codes, data.codes_cm, torch.from_numpy(g[0]),
                torch.from_numpy(h[0]), data.is_categorical,
                torch.ones(5, dtype=torch.bool))
        _assert_trees(chunked, TreeArrays(*[a[None] for a in pjit]))


# --------------------------------------------------------------------------
# train_streaming
# --------------------------------------------------------------------------
def _labels(y, objective):
    if objective == "binary:logistic":
        return (y > np.median(y)).astype(np.float64)
    if objective == "multi:softmax":
        return np.digitize(y, np.quantile(y, [0.3, 0.7])).astype(np.float64)
    return y


@pytest.mark.parametrize("objective", ["binary:logistic", "multi:softmax"])
def test_train_streaming_matches_jax(objective):
    """A streamed fit with an eval set and early stopping, then a warm
    start of 2 more rounds: trees and losses agree with ``repro``'s host
    loop (``scatter`` histograms) to rtol 1e-6.  The fixture has no
    near-tied gains, as ROADMAP's contract asks of structure equality: at
    seed 7 one node of the binary fit has two mirror splits (the missing
    records alone on one side or the other) whose gains differ by an ulp
    of the summation order, and the side taken differs (ROADMAP Queue 3)."""
    X, y = _materialize(SyntheticSource(1400, 6, missing_rate=0.05, seed=8),
                        1400)
    y = _labels(y, objective)
    Xv, yv = X[1100:], y[1100:]
    X, y = X[:1100], y[:1100]
    K = 3 if objective == "multi:softmax" else None
    kw = dict(max_depth=3, learning_rate=0.3, objective=objective,
              n_classes=K, early_stopping_rounds=2)
    ours_b = StreamingBinner(max_bins=32, sketch_size=4096).fit(X)
    theirs_b = jax_binning.StreamingBinner(max_bins=32,
                                           sketch_size=4096).fit(X)
    src, jsrc = ArraySource(X, y), jax_pipeline.ArraySource(X, y)
    ev = (ours_b.transform(Xv, device="cpu"), yv)
    jev = (theirs_b.transform(Xv), yv)
    ours = gbdt.train_streaming(gbdt.GBDTConfig(n_trees=5, **kw), src,
                                ours_b, y, eval_set=ev, chunk_rows=256,
                                device="cpu")
    theirs = jax_gbdt.train_streaming(jax_gbdt.GBDTConfig(n_trees=5, **kw),
                                      jsrc, theirs_b, y, eval_set=jev,
                                      chunk_rows=256, plan=SCATTER)
    warm = gbdt.train_streaming(gbdt.GBDTConfig(n_trees=2, **kw), src,
                                ours_b, y, eval_set=ev, chunk_rows=300,
                                init_model=ours.model, device="cpu")
    jwarm = jax_gbdt.train_streaming(jax_gbdt.GBDTConfig(n_trees=2, **kw),
                                     jsrc, theirs_b, y, eval_set=jev,
                                     chunk_rows=300,
                                     init_model=theirs.model, plan=SCATTER)
    for a, b in ((ours, theirs), (warm, jwarm)):
        _assert_trees(a.model.trees, b.model.trees, leaf_rtol=1e-6,
                      jax=True)
        for key in ("train_loss", "eval_loss"):
            np.testing.assert_allclose(a.history[key], b.history[key],
                                       rtol=1e-6, err_msg=key)
        assert a.stats == b.stats
    assert ours.stats["n_chunks"] == 5 and ours.stats["passes_per_round"] \
        == 4 and warm.model.n_rounds == ours.model.n_rounds + 2
    # the warm start's replayed margins equal the direct predict
    data = ours_b.transform(X, device="cpu")
    torch.testing.assert_close(
        gbdt._streamed_margins(ours.model, _chunk_stream(
            ours_b.transform_codes(X), 333, False, True), 1100,
            ExecutionPlan(), torch.device("cpu")),
        ours.model.predict_margin(data), rtol=0, atol=0)


@pytest.mark.parametrize("objective", ["binary:logistic", "multi:softmax"])
def test_packed_stream_bit_equal_and_equal_to_in_memory(objective):
    """At 16 bins the packed stream is bit-equal to the uint8 stream, and
    both equal the port's in-memory ``train`` in trees (leaves to rtol
    1e-5) and losses (rtol 1e-6): the oracle for ``repro``'s
    ``test_packed_codes.py::test_train_streaming_bit_equal_packed``, which
    holds the stream to the in-memory fit bit for bit and fails there by
    one ulp of round 0's loss."""
    rng = np.random.default_rng(13)
    X = rng.normal(size=(600, 7)).astype(np.float32)
    K = 3 if objective == "multi:softmax" else None
    y = ((X[:, 0] - X[:, 3] > 0).astype(np.float32) if K is None
         else np.digitize(X[:, 0] - X[:, 3], [-0.7, 0.7]).astype(np.float32))
    src = ArraySource(X, y)
    b = Binner(max_bins=16).fit(X)
    cfg = gbdt.GBDTConfig(n_trees=3, max_depth=3, objective=objective,
                          n_classes=K)
    rp = gbdt.train_streaming(cfg, src, b, y, chunk_rows=144, device="cpu")
    ru = gbdt.train_streaming(cfg, src, b, y, chunk_rows=144,
                              plan=ExecutionPlan(packed_codes=False),
                              device="cpu")
    rm = gbdt.train(cfg, b.transform(X, device="cpu"), y, device="cpu")
    assert rp.history["train_loss"] == ru.history["train_loss"]
    _assert_trees(rp.model.trees, ru.model.trees)
    assert torch.equal(rp.margins, ru.margins)
    _assert_trees(rp.model.trees, rm.model.trees, leaf_rtol=1e-5)
    np.testing.assert_allclose(rp.history["train_loss"],
                               rm.history["train_loss"], rtol=1e-6)


def test_streaming_draws_as_train_draws():
    """GOSS, subsample and colsample are drawn from the round's stream as
    ``train`` draws them, so the stream grows the in-memory fit's trees."""
    X, y = _materialize(SyntheticSource(900, 6, seed=3), 900)
    b = Binner(max_bins=32).fit(X)
    cfg = gbdt.GBDTConfig(n_trees=4, max_depth=3, learning_rate=0.3,
                          goss_top_rate=0.2, goss_other_rate=0.3,
                          subsample=0.8, colsample_bytree=0.7, seed=5)
    rs = gbdt.train_streaming(cfg, ArraySource(X, y), b, y, chunk_rows=200,
                              device="cpu")
    rm = gbdt.train(cfg, b.transform(X, device="cpu"), y, device="cpu")
    _assert_trees(rs.model.trees, rm.model.trees, leaf_rtol=1e-5)
    np.testing.assert_allclose(rs.history["train_loss"],
                               rm.history["train_loss"], rtol=1e-6)


@pytest.mark.parametrize("case", ["packed_wide_bins", "lossguide",
                                  "short_source"])
def test_train_streaming_refusals(case):
    rng = np.random.default_rng(17)
    X = rng.normal(size=(300, 5)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    b = Binner(max_bins=32).fit(X)
    cfg, plan, yy = gbdt.GBDTConfig(n_trees=1, max_depth=2), None, y
    if case == "packed_wide_bins":
        plan, match = ExecutionPlan(packed_codes=True), "max_bins"
    elif case == "lossguide":
        cfg, match = gbdt.GBDTConfig(n_trees=1, grow_policy="lossguide"), \
            "depthwise"
    else:
        yy, match = np.concatenate([y, y[:10]]), "len"
    with pytest.raises(ValueError, match=match):
        gbdt.train_streaming(cfg, ArraySource(X, y), b, yy, plan=plan,
                             chunk_rows=128, device="cpu")


def test_plan_chunking_matches_jax():
    """``chunk_rows`` is ``repro``'s formula bit for bit, so a stream's
    ``stats["chunk_rows"]`` agrees between packages."""
    for kw in (dict(), dict(chunk_bytes=12_800), dict(packed_codes=True),
               dict(chunk_bytes=1 << 20, packed_codes=False)):
        for F, K in ((28, 1), (54, 7), (115, 1), (3, 2)):
            assert ExecutionPlan(**kw).chunk_rows(F, K) == \
                JaxPlan(**kw).chunk_rows(F, K)
    assert ExecutionPlan().DEFAULT_CHUNK_BYTES == 1 << 26
    plan = ExecutionPlan(chunk_bytes=4096, packed_codes=True)
    assert plan.without_chunking().chunk_bytes is None
    assert ExecutionPlan().without_chunking() == ExecutionPlan()
    assert "packed=True" in plan.resolved().describe()
    with pytest.raises(ValueError, match="chunk_bytes"):
        ExecutionPlan(chunk_bytes=0)


# --------------------------------------------------------------------------
# the estimators
# --------------------------------------------------------------------------
def _rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


def test_streaming_estimator_matches_in_memory_fit():
    """``repro``'s fixture: a chunk-capped streamed fit keeps at most an
    eighth of the records resident, and with an exact sketch its loss
    trajectory is the in-memory fit's (and ``repro``'s)."""
    src = SyntheticSource(4000, 10, seed=21)
    X, y = _materialize(src, 4000)
    Xv, yv = next(iter(SyntheticSource(1000, 10, seed=22).chunks(1000)))
    kw = dict(n_trees=8, max_depth=4, learning_rate=0.3, max_bins=64,
              sketch_size=4096)
    plan = ExecutionPlan(chunk_bytes=12_800)
    mem = BoosterRegressor(device="cpu", **kw).fit(X, y)
    stream = BoosterRegressor(device="cpu", **kw).fit(data=src, plan=plan)
    theirs = JaxRegressor(**kw).fit(
        data=jax_synthetic.SyntheticSource(4000, 10, seed=21),
        plan=JaxPlan(chunk_bytes=12_800, hist_strategy="scatter"))
    stats = stream.stats_
    assert stats["chunk_rows"] * 8 <= stats["n_rows"]
    assert stats["n_chunks"] >= 8 and stats == theirs.stats_
    assert _rmse(stream.predict(Xv), yv) <= _rmse(mem.predict(Xv), yv) \
        * 1.02 + 1e-9
    np.testing.assert_allclose(mem.history_["train_loss"],
                               stream.history_["train_loss"], rtol=1e-5)
    np.testing.assert_allclose(theirs.history_["train_loss"],
                               stream.history_["train_loss"], rtol=1e-6)
    _assert_trees(stream.model_.trees, theirs.model_.trees, leaf_rtol=1e-5,
                  jax=True)


@pytest.mark.parametrize("form", ["tuple", "array_source", "npz_dir",
                                  "chunk_bytes_arrays"])
@pytest.mark.parametrize("kind", ["regressor", "multiclass"])
def test_fit_data_input_forms(kind, form, tmp_path):
    """Every input form of ``fit(data=...)`` (and arrays under a
    ``chunk_bytes`` plan) streams the same chunks, so every form fits the
    same model."""
    X, y, _ = make_tabular(1200, 6, 0, task="multiclass" if kind ==
                           "multiclass" else "regression", n_classes=3,
                           seed=31)
    Est = BoosterClassifier if kind == "multiclass" else BoosterRegressor
    kw = dict(n_trees=3, max_depth=3, learning_rate=0.5, max_bins=32,
              device="cpu")
    plan = ExecutionPlan(chunk_bytes=9_000)
    ref = Est(**kw).fit(data=ArraySource(X, y), plan=plan)
    if form == "tuple":
        est = Est(**kw).fit(data=(X, y), plan=plan)
    elif form == "array_source":
        est = Est(**kw).fit(data=ArraySource(X, y), plan=plan)
    elif form == "npz_dir":
        write_npz_shards(str(tmp_path), ArraySource(X, y),
                         rows_per_shard=1200)             # one shard
        est = Est(**kw).fit(data=str(tmp_path), plan=plan)
    else:
        est = Est(**kw).fit(X, y, plan=plan)
    assert est.stats_["n_chunks"] >= 3 and est.stats_ == ref.stats_
    _assert_trees(est.model_.trees, ref.model_.trees)
    if kind == "multiclass":
        assert est.model_.n_classes == 3
        np.testing.assert_allclose(est.predict_proba(X).sum(axis=1), 1.0,
                                   atol=1e-5)
        assert np.mean(est.predict(X) == y) > 0.6
    else:
        assert _rmse(est.predict(X), y) < np.std(y)


def test_streaming_classifier_matches_jax():
    X, y, _ = make_tabular(1500, 6, 0, task="multiclass", n_classes=3,
                           seed=31)
    kw = dict(n_trees=3, max_depth=3, learning_rate=0.5, max_bins=32)
    ours = BoosterClassifier(device="cpu", **kw).fit(
        data=(X, y.astype(int)), plan=ExecutionPlan(chunk_bytes=16_000))
    theirs = JaxClassifier(**kw).fit(
        data=(X, y.astype(int)),
        plan=JaxPlan(chunk_bytes=16_000, hist_strategy="scatter"))
    _assert_trees(ours.model_.trees, theirs.model_.trees, leaf_rtol=1e-5,
                  jax=True)
    np.testing.assert_allclose(ours.history_["train_loss"],
                               theirs.history_["train_loss"], rtol=1e-6)
    np.testing.assert_allclose(ours.predict_proba(X),
                               theirs.predict_proba(X), rtol=1e-5,
                               atol=1e-6)


def test_streaming_warm_start_checkpoint_and_eval(tmp_path):
    src = SyntheticSource(2000, 6, seed=51)
    X, y = _materialize(src, 2000)
    plan = ExecutionPlan(chunk_bytes=15_000)
    ck = str(tmp_path / "ck")
    kw = dict(max_depth=3, max_bins=32, device="cpu")
    first = BoosterRegressor(n_trees=4, **kw)
    first.fit(data=src, plan=plan, checkpoint_dir=ck, checkpoint_every=2)
    assert first.n_trees_ == 4
    resumed = BoosterRegressor(n_trees=6, **kw).fit(data=src, plan=plan,
                                                    checkpoint_dir=ck)
    assert resumed.n_trees_ == 6
    warm = BoosterRegressor(n_trees=2, **kw).fit(data=src, plan=plan,
                                                 xgb_model=first)
    assert warm.n_trees_ == 6                          # 4 warm + 2 new
    _assert_trees(warm.model_.trees, resumed.model_.trees)
    est = BoosterRegressor(n_trees=5, **kw).fit(
        data=src, plan=plan, eval_set=(X[:300], y[:300]))
    assert len(est.history_["eval_loss"]) == 5


def test_streaming_rejects_mixed_inputs():
    src = SyntheticSource(100, 3, seed=0)
    X = np.zeros((10, 3))
    with pytest.raises(ValueError, match="not both"):
        BoosterRegressor(n_trees=1, device="cpu").fit(X, np.zeros(10),
                                                      data=src)
    with pytest.raises(TypeError, match="fit needs"):
        BoosterRegressor(n_trees=1, device="cpu").fit()
    with pytest.raises(ValueError, match="labeled"):
        BoosterRegressor(n_trees=1, device="cpu").fit(
            data=ArraySource(X), plan=ExecutionPlan(chunk_bytes=2_000))

"""The port's kernel modules against the JAX package, module by module.

Each plain PyTorch version (what the CUDA wrappers run for CPU tensors) is
held against ``repro.kernels.ref`` and against the Pallas kernels in
interpret mode, on the same numpy inputs.  Integer outputs must be
bit-equal; histograms bit-equal on dyadic statistics and rtol 1e-5
otherwise; ensemble sums rtol 1e-5 (the tree sum is taken in another
order).  The kernels themselves are held against their plain versions on
the card by ``tests/test_torch_cuda.py``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import tree as jax_tree
from repro.kernels import histogram as jax_hist
from repro.kernels import partition as jax_part
from repro.kernels import ref as jax_ref
from repro.kernels import traversal as jax_trav

from repro_torch.api.plan import ExecutionPlan
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import histogram as hist_k
from repro_torch.kernels import partition as part_k
from repro_torch.kernels import traversal as trav_k


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _hist_inputs(n, F, NB, NN, seed, dyadic):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, NB, (n, F)).astype(np.uint8)
    codes[:, -1] = NB - 1                      # an all-missing column
    if dyadic:
        g = (rng.integers(-64, 64, n) / 64).astype(np.float32)
        h = (rng.integers(1, 64, n) / 64).astype(np.float32)
    else:
        g = rng.normal(size=n).astype(np.float32)
        h = rng.uniform(0.1, 1.0, n).astype(np.float32)
    nid = rng.integers(0, NN, n).astype(np.int32)
    return codes, g, h, nid


def _hist_close(got, want, g, h, codes, nid, NN, NB):
    """rtol 1e-5 plus atol 1e-5 times the bin's sum of |g| (|h|): the
    float error of a reordered sum scales with the magnitudes summed."""
    mag = np.asarray(jax_ref.histogram_ref(
        jnp.asarray(codes), jnp.abs(jnp.asarray(g)), jnp.abs(jnp.asarray(h)),
        jnp.asarray(nid), NN, NB))
    got, want = np.asarray(got), np.asarray(want)
    assert np.all(np.abs(got - want) <= 1e-5 * np.abs(want) + 1e-5 * mag)


HIST_CASES = [(64, 3, 8, 1), (777, 13, 16, 4), (515, 9, 256, 2),
              (300, 1, 4, 2)]


@pytest.mark.parametrize("dyadic", [True, False])
@pytest.mark.parametrize("n,F,NB,NN", HIST_CASES)
def test_histogram_plain_matches_jax(n, F, NB, NN, dyadic):
    codes, g, h, nid = _hist_inputs(n, F, NB, NN, seed=n + F, dyadic=dyadic)
    got = ref.histogram_ref(_t(codes), _t(g), _t(h), _t(nid), NN, NB)
    assert got.shape == (NN, F, NB, 2) and got.dtype == torch.float32
    want_ref = jax_ref.histogram_ref(jnp.asarray(codes), jnp.asarray(g),
                                     jnp.asarray(h), jnp.asarray(nid), NN, NB)
    want_pallas = jax_hist.histogram_pallas(
        jnp.asarray(codes), jnp.asarray(g), jnp.asarray(h),
        jnp.asarray(nid), n_nodes=NN, n_bins=NB, interpret=True)
    for want in (want_ref, want_pallas):
        if dyadic:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            _hist_close(got.numpy(), want, g, h, codes, nid, NN, NB)


def test_histogram_wrapper_takes_plain_version_on_cpu():
    codes, g, h, nid = _hist_inputs(333, 5, 16, 4, seed=1, dyadic=False)
    _build.reset_launch_counts()
    got = hist_k.histogram_cuda(_t(codes), _t(g), _t(h), _t(nid),
                                n_nodes=4, n_bins=16)
    want = hist_k.histogram_plain(_t(codes), _t(g), _t(h), _t(nid), 4, 16)
    assert torch.equal(got, want)
    assert _build.launch_counts()["histogram"] == 0


@pytest.mark.parametrize("n_nodes,n_fields,n_bins", [
    (1, 28, 256), (32, 28, 256), (512, 28, 256), (4, 9, 16), (1, 1, 2),
    # the naive twin's class-batched slots (K x NN): 7 x 32 and 3 x 512
    # slots of 256 bins pass the budget, 3 x 4 of 16 bins do not
    (7 * 32, 54, 256), (3 * 512, 3, 256), (3 * 4, 5, 16), (96, 1, 256)])
def test_histogram_tiles_fit_shared_memory(n_nodes, n_fields, n_bins):
    nt, ft = hist_k.tile_shape(n_nodes, n_fields, n_bins)
    assert 1 <= nt <= n_nodes and 1 <= ft <= n_fields
    assert nt * ft * n_bins * 2 * 4 <= hist_k.SMEM_BUDGET
    # slots are tiled exactly when one field's bins of every slot do not fit
    assert (nt < n_nodes) == (n_nodes * n_bins * 8 > hist_k.SMEM_BUDGET)


# What csrc/histogram.cu's launch bounds and an H100 SXM give
# (hist_grouped_limits): 3 blocks an SM, 12 sort bytes a node, 132 SMs,
# 228 KB an SM, 1 KB of it kept a block, 227 KB a block at most.
H100 = hist_k.GroupedLimits(blocks_per_sm=3, sort_node_bytes=12, sms=132,
                            sm_shared=233_472, block_reserved=1_024,
                            block_shared=232_448)


def test_grouped_limits_budget():
    """Two blocks' bins an SM; a sort block's counters for 19,370 nodes."""
    assert H100.budget == 233_472 // 2 - 1_024
    assert H100.max_sort_nodes == 232_448 // 12
    small = H100._replace(sm_shared=100_000, block_shared=40_000)
    assert small.budget == 40_000


@pytest.mark.parametrize("n,K,NN,F,NB", [
    (10_000_000, 1, 1, 28, 256), (10_000_000, 1, 32, 28, 256),
    (581_012, 7, 32, 54, 256), (581_012, 7, 1, 54, 256),
    (2_000_000, 1, 32, 115, 16), (3000, 1, 8, 115, 256),
    (3000, 3, 512, 3, 256), (1, 1, 1, 1, 2), (777, 2, 3, 13, 15)])
def test_grouped_geometry_covers_every_slot_and_field(n, K, NN, F, NB):
    geo = hist_k.grouped_geometry(n, K, NN, F, NB, H100)
    # bins [bin][field], a tile's fields padded to a multiple of 32 (lane l
    # always on bank l), g and h; within 227 KB
    assert geo.row % 32 == 0 and geo.field_tile <= geo.row < \
        geo.field_tile + 32
    assert geo.smem == 8 * NB * geo.row
    assert geo.smem <= 227 * 1024
    assert 2 * (geo.smem + H100.block_reserved) <= H100.sm_shared \
        or geo.n_ftiles == 1
    # the field tiles cover every field once, none empty
    assert (geo.n_ftiles - 1) * geo.field_tile < F <= \
        geo.n_ftiles * geo.field_tile
    assert geo.n_ftiles == 1 or geo.smem <= H100.budget
    # the blocks' shares cover every sorted (class, record) position, and
    # the blocks fit the card at once
    assert geo.blocks * geo.per_block >= K * n
    assert (geo.blocks - 1) * geo.per_block < K * n
    assert geo.blocks * geo.n_ftiles <= H100.blocks_per_sm * H100.sms
    # the sort's blocks cover every record of a class; none at one slot
    if K * NN == 1:
        assert geo.sort_blocks == geo.sort_chunk == 0
    else:
        assert geo.sort_blocks * geo.sort_chunk >= n
        assert (geo.sort_blocks - 1) * geo.sort_chunk < n
        assert NN <= H100.max_sort_nodes
        assert NN * H100.sort_node_bytes <= H100.block_shared


def test_grouped_geometry_at_the_paths_shapes():
    """Higgs's 28 fields of 256 bins sit in one block (64 KB, three blocks
    an SM); Covertype's 54 pad to 64 and would pass the budget, so they
    take two tiles of 27; IoT's 115 fields of 16 bins one; 115 fields of
    256 bins four tiles of 29."""
    higgs = hist_k.grouped_geometry(10_000_000, 1, 32, 28, 256, H100)
    cover = hist_k.grouped_geometry(581_012, 7, 32, 54, 256, H100)
    iot = hist_k.grouped_geometry(2_000_000, 1, 32, 115, 16, H100)
    wide = hist_k.grouped_geometry(3000, 1, 8, 115, 256, H100)
    assert (higgs.n_ftiles, higgs.row, higgs.smem) == (1, 32, 65536)
    assert higgs.blocks == 3 * 132                  # one wave
    assert (cover.n_ftiles, cover.field_tile, cover.row) == (2, 27, 32)
    assert cover.blocks == 3 * 132 // 2
    assert (iot.n_ftiles, iot.row, iot.smem) == (1, 128, 16384)
    assert (wide.n_ftiles, wide.field_tile) == (4, 29)


def _splits(nn, n_cols, n_bins, rng, passthrough=True):
    f = rng.integers(-1 if passthrough else 0, n_cols, nn).astype(np.int32)
    thr = rng.integers(0, n_bins, nn).astype(np.int32)
    cat = rng.integers(0, 2, nn).astype(np.int32)
    dl = rng.integers(0, 2, nn).astype(np.int32)
    return f, thr, cat, dl


@pytest.mark.parametrize("n,nn,n_cols,n_bins", [
    (100, 1, 1, 8), (1000, 8, 8, 16), (1777, 16, 20, 256), (4096, 4, 3, 4)])
def test_partition_plain_matches_jax(n, nn, n_cols, n_bins):
    rng = np.random.default_rng(n)
    nid = rng.integers(0, nn, n).astype(np.int32)
    codes = rng.integers(0, n_bins, (n, n_cols)).astype(np.uint8)
    codes[rng.uniform(size=codes.shape) < 0.2] = n_bins - 1   # missing
    f, thr, cat, dl = _splits(nn, n_cols, n_bins, rng)
    got = ref.partition_ref(_t(nid), _t(codes), _t(f), _t(thr), _t(cat),
                            _t(dl), n_bins - 1)
    assert got.dtype == torch.int32
    args = [jnp.asarray(a) for a in (nid, codes, f, thr, cat, dl)]
    want_ref = jax_ref.partition_ref(*args, n_bins - 1)
    want_pallas = jax_part.partition_pallas(*args, missing_bin=n_bins - 1,
                                            interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_ref))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_pallas))
    for fn in (part_k.partition_cuda, ops.partition_level):
        out = fn(_t(nid), _t(codes), _t(f), _t(thr), _t(cat), _t(dl),
                 missing_bin=n_bins - 1)
        assert torch.equal(out, got)


@pytest.mark.parametrize("n,nn,F,n_bins", [(513, 4, 6, 16), (2000, 16, 28, 256)])
def test_partition_cm_plain_matches_jax_gather(n, nn, F, n_bins):
    """The column-major entry equals the grower's JAX step ③:
    ``_gather_fields`` of the split fields + ``partition_ref`` on the
    renumbered columns."""
    rng = np.random.default_rng(nn)
    nid = rng.integers(0, nn, n).astype(np.int32)
    codes_cm = rng.integers(0, n_bins, (F, n)).astype(np.uint8)
    codes_cm[0] = n_bins - 1                          # all-missing field
    f, thr, cat, dl = _splits(nn, F, n_bins, rng)
    got = part_k.partition_cm_plain(_t(nid), _t(codes_cm), _t(f), _t(thr),
                                    _t(cat), _t(dl), n_bins - 1)
    do_split = jnp.asarray(f >= 0)
    lvl = jax_tree._gather_fields(jnp.asarray(codes_cm),
                                  jnp.where(do_split, jnp.asarray(f), 0))
    want = jax_ref.partition_ref(
        jnp.asarray(nid), lvl.T,
        jnp.where(do_split, jnp.arange(nn, dtype=jnp.int32), -1),
        jnp.asarray(thr), jnp.asarray(cat), jnp.asarray(dl), n_bins - 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for fn in (part_k.partition_cm_cuda, ops.partition_level_cm):
        out = fn(_t(nid), _t(codes_cm), _t(f), _t(thr), _t(cat), _t(dl),
                 missing_bin=n_bins - 1)
        assert torch.equal(out, got)


def _random_trees(T, depth, n_cols, n_bins, seed):
    """Stacked (T, ...) numpy trees with pass-through nodes, categorical
    splits and both missing directions."""
    rng = np.random.default_rng(seed)
    n_int = 2 ** depth - 1
    return dict(
        feature=rng.integers(-1, n_cols, (T, n_int)).astype(np.int32),
        threshold=rng.integers(0, n_bins - 1, (T, n_int)).astype(np.int32),
        is_cat=rng.integers(0, 2, (T, n_int)).astype(np.int32),
        default_left=rng.integers(0, 2, (T, n_int)).astype(np.int32),
        leaf_value=rng.normal(size=(T, 2 ** depth)).astype(np.float32))


def _codes(n, C, n_bins, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, n_bins, (n, C)).astype(np.uint8)
    codes[rng.uniform(size=codes.shape) < 0.1] = n_bins - 1
    return codes


def _as(trees, mod, conv, index=None):
    pick = (lambda a: a) if index is None else (lambda a: a[index])
    return mod.TreeArrays(**{k: conv(pick(v)) for k, v in trees.items()})


def test_pack_node_table_matches_jax():
    trees = _random_trees(5, 4, 30, 256, seed=0)
    got = trav_k.pack_node_table(_as(trees, ref, _t))
    want = jax_trav.pack_node_table(_as(trees, jax_ref, jnp.asarray))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,depth,C,n_bins", [
    (1, 1, 1, 4), (777, 3, 5, 16), (2048, 6, 28, 256), (300, 4, 7, 8)])
def test_traverse_plain_matches_jax(n, depth, C, n_bins):
    trees = _random_trees(1, depth, C, n_bins, seed=depth)
    codes = _codes(n, C, n_bins, seed=n)
    got = ref.traverse_ref(_as(trees, ref, _t, 0), _t(codes), n_bins - 1)
    jt = _as(trees, jax_ref, jnp.asarray, 0)
    want_ref = jax_ref.traverse_ref(jt, jnp.asarray(codes), n_bins - 1)
    want_pallas = jax_trav.traverse_pallas(jt, jnp.asarray(codes),
                                           missing_bin=n_bins - 1,
                                           interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_ref))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_pallas))
    for fn in (trav_k.traverse_cuda, ops.traverse_tree):
        assert torch.equal(fn(_as(trees, ref, _t, 0), _t(codes),
                              missing_bin=n_bins - 1), got)


@pytest.mark.parametrize("n,T,depth,F,n_bins", [
    (513, 7, 3, 6, 16), (64, 1, 2, 3, 4), (1500, 13, 6, 28, 256)])
def test_ensemble_plain_matches_jax(n, T, depth, F, n_bins):
    trees = _random_trees(T, depth, F, n_bins, seed=T)
    trees["feature"][0] = -1                   # a pass-through tree
    codes = _codes(n, F, n_bins, seed=T + n)
    got = trav_k.predict_ensemble_plain(_as(trees, ref, _t), _t(codes),
                                        n_bins - 1)
    jt = _as(trees, jax_ref, jnp.asarray)
    want_ref = jax_ref.predict_ensemble_batched(jt, jnp.asarray(codes),
                                                n_bins - 1)
    # trees_per_block 4 does not divide T: the Pallas path pads the ensemble
    want_pallas = jax_trav.predict_ensemble_pallas(
        jt, jnp.asarray(codes), missing_bin=n_bins - 1, depth=depth,
        interpret=True, trees_per_block=4)
    for want in (want_ref, want_pallas):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    out = ops.predict_ensemble(_as(trees, ref, _t), _t(codes),
                               missing_bin=n_bins - 1, depth=depth)
    assert torch.equal(out, got)


def test_ensemble_plain_walks_in_record_blocks(monkeypatch):
    trees = _random_trees(5, 3, 4, 8, seed=2)
    codes = _codes(1000, 4, 8, seed=3)
    whole = trav_k.predict_ensemble_plain(_as(trees, ref, _t), _t(codes), 7)
    monkeypatch.setattr(trav_k, "PLAIN_ROWS", 64)
    blocks = trav_k.predict_ensemble_plain(_as(trees, ref, _t), _t(codes), 7)
    assert torch.equal(whole, blocks)


def test_ensemble_leaf_choice_matches_per_tree_walk():
    """Integer leaves make the sum exact: the batched walk picks the same
    leaf as a one-tree walk, tree by tree."""
    trees = _random_trees(9, 4, 6, 16, seed=5)
    trees["leaf_value"] = np.round(trees["leaf_value"] * 4).astype(np.float32)
    codes = _t(_codes(700, 6, 16, seed=6))
    got = trav_k.predict_ensemble_plain(_as(trees, ref, _t), codes, 15)
    want = sum(ref.traverse_ref(_as(trees, ref, _t, i), codes, 15)
               for i in range(9))
    assert torch.equal(got, want)


def test_reference_plan_selects_plain_versions():
    codes, g, h, nid = _hist_inputs(200, 4, 8, 2, seed=9, dyadic=True)
    args = (_t(codes), _t(g), _t(h), _t(nid))
    a = ops.build_histogram(*args, n_nodes=2, n_bins=8,
                            plan=ExecutionPlan(hist_strategy="reference"))
    b = ops.build_histogram(*args, n_nodes=2, n_bins=8)
    assert torch.equal(a, b)


def test_plan_resolution_and_refusals():
    plan = ExecutionPlan().resolved()
    assert (plan.hist_strategy, plan.partition_strategy,
            plan.traversal_strategy) == ("cuda", "cuda", "cuda")
    assert ExecutionPlan(traversal_strategy="reference").resolved() \
        .traversal_strategy == "reference"
    with pytest.raises(ValueError):
        ExecutionPlan(hist_strategy="pallas_grouped")
    with pytest.raises(NotImplementedError):
        ExecutionPlan(mesh=object())
    # class-batched statistics and multi-class ensembles are ported
    hist = ops.build_histogram(torch.zeros((8, 2), dtype=torch.uint8),
                               torch.ones((2, 8)), torch.ones((2, 8)),
                               torch.zeros((2, 8), dtype=torch.int32),
                               n_nodes=1, n_bins=4)
    assert hist.shape == (2, 1, 2, 4, 2) and float(hist[..., 0].sum()) \
        == 2 * 2 * 8
    margins = ops.predict_ensemble(_as(_random_trees(2, 2, 3, 4, 0), ref, _t),
                                   _t(_codes(8, 3, 4, 0)), missing_bin=3,
                                   depth=2, n_classes=3)
    assert margins.shape == (8, 3) and torch.all(margins[:, 2] == 0)


def test_library_names_carry_source_hash():
    paths = {name: _build._library_path(name) for name in _build.SOURCES}
    assert all(p.parent == _build.BUILD_DIR for p in paths.values())
    assert len({p.name for p in paths.values()}) == len(_build.SOURCES)
    assert all((_build.CSRC / f"{name}.cu").exists() for name in paths)

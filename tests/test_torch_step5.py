"""Step ⑤ (a round's margin update) and the partition's split handoff in
the port against the JAX package.

Step ⑤ walks one round's K class trees through the traversal kernel's
staged body at T = K, over the row-major codes as they lie, 4-bit packed
or not.  ``repro`` gathers each tree's renumbered columns from the
column-major copy where F > 2^D - 1 (its TPU's layout); the decisions are
integer-exact either way.  Same numpy inputs, made from a seed, feed both
packages (plain versions on the CPU).  Tolerances:

* a round's leaves through ``_predict_forest`` on dyadic leaf values:
  bit-equal, and added into margins bit-equal to ``margins + leaf``;
* ``train``: tree structure bit-equal; leaves, losses and margins within
  rtol 1e-5 plus 1e-5 of the largest |value| (XLA's CPU ``log``/``exp``
  and torch's differ in the last ulp, ROADMAP Queue 3).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ExecutionPlan as JaxPlan
from repro.core import binning as jax_binning
from repro.core import gbdt as jax_gbdt
from repro.kernels import ref as jax_ref

from repro_torch.core import binning, gbdt
from repro_torch.core import tree as tree_mod
from repro_torch.core.binning import PackedCodes
from repro_torch.kernels import ops, ref
from repro_torch.kernels import partition as part_k
from repro_torch.kernels import traversal as trav_k

JAX_REFERENCE = JaxPlan(hist_strategy="scatter",
                        partition_strategy="reference",
                        traversal_strategy="reference")
# one H100 SXM as the ensemble kernel reports it (ensemble_limits)
H100 = trav_k.EnsembleLimits(threads=256, per_thread=2, blocks_per_sm=4,
                             sm_shared=233_472, block_reserved=1_024,
                             block_shared=232_448)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, rtol=1e-5):
    """rtol plus ``rtol`` of the largest |want|."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _forest(K, depth, F, NB, seed):
    """K random trees over F fields: pass-through nodes, numeric and
    categorical splits, dyadic leaves (every sum is exact)."""
    rng = np.random.default_rng(seed)
    n_int = 2 ** depth - 1
    return {"feature": rng.integers(-1, F, (K, n_int)).astype(np.int32),
            "threshold": rng.integers(0, NB - 1, (K, n_int)).astype(np.int32),
            "is_cat": rng.integers(0, 2, (K, n_int)).astype(np.int32),
            "default_left": rng.integers(0, 2, (K, n_int)).astype(np.int32),
            "leaf_value": (rng.integers(-64, 65, (K, 2 ** depth))
                           / 64).astype(np.float32)}


def _as(forest, mod, conv, k=None):
    return mod.TreeArrays(**{f: conv(v if k is None else v[k])
                             for f, v in forest.items()})


def _codes(n, F, NB, seed):
    codes = np.random.default_rng(seed).integers(0, NB, (n, F))
    codes.flat[::7] = NB - 1                       # the missing bin
    return codes.astype(np.uint8)


CASES = [(K, NB) for K in (1, 3) for NB in (16, 64)]   # 16 bins: packed


@pytest.mark.parametrize("K,NB", CASES)
def test_predict_forest_matches_jax_past_the_tree_width(K, NB):
    """F = 21 > 2^3 - 1 and n = 901, both odd: ``repro`` gathers renumbered
    columns (from the packed column-major copy at 16 bins); the port walks
    the row-major codes, packed rows read in place.  Leaves bit-equal."""
    n, F, depth = 901, 21, 3
    forest = _forest(K, depth, F, NB, seed=K + NB)
    codes = _codes(n, F, NB, seed=NB)
    jdata = jax_binning.dataset_from_codes(codes, None, NB)
    tdata = binning.dataset_from_codes(codes, None, NB, device="cpu")
    assert isinstance(tdata.codes, PackedCodes) == (NB == 16)
    assert isinstance(jdata.codes, jax_binning.PackedCodes) == (NB == 16)
    plan = JAX_REFERENCE.resolved()
    if K == 1:
        got = gbdt._predict_one_tree(_as(forest, ref, _t, 0), tdata, None)
        want = jax_gbdt._predict_one_tree(_as(forest, jax_ref, jnp.asarray,
                                              0), jdata, plan)
    else:
        got = gbdt._predict_forest(_as(forest, ref, _t), tdata, None)
        want = jax_gbdt._predict_forest(_as(forest, jax_ref, jnp.asarray),
                                        jdata, plan)
    assert got.shape == ((n,) if K == 1 else (n, K))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # into the margins, in place: margins + leaf, bit for bit
    margins = _t(np.random.default_rng(5).normal(size=got.shape)
                 .astype(np.float32))
    expect = margins + got
    predict = gbdt._predict_one_tree if K == 1 else gbdt._predict_forest
    out = predict(_as(forest, ref, _t, 0 if K == 1 else None), tdata, None,
                  margins)
    assert out is margins and torch.equal(out, expect)


@pytest.mark.parametrize("K,NB", CASES)
def test_train_matches_jax_past_the_tree_width(K, NB):
    """A fit at F = 21 > 2^3 - 1 with an eval set: step ⑤ of every round
    (training and held-out margins) through the row-major codes."""
    rng = np.random.default_rng(K + NB)
    X = rng.normal(size=(601, 21)).astype(np.float32)
    X[rng.random(X.shape) < 0.04] = np.nan
    if K == 1:
        # no label noise: with it, round 3's node 6 at 64 bins splits on
        # field 15 in the port and 4 in repro, a near tie that the parent
        # tree's fit shows alike (XLA's and torch's log differ in the last
        # ulp, ROADMAP Queue 3)
        y = X[:, 0] - X[:, 9] > 0
        kw = dict(objective="binary:logistic")
    else:
        y = rng.integers(0, K, size=601)
        y[X[:, 12] > 0.5] = 0
        kw = dict(objective="multi:softmax", n_classes=K)
    y = y.astype(np.float32)
    n_tr = 500
    jb = jax_binning.Binner(NB).fit(X[:n_tr])
    tb = binning.Binner.from_arrays(NB, jb._edges, jb._is_cat,
                                    jb._n_value_bins)
    jtr, jev = jb.transform(X[:n_tr]), jb.transform(X[n_tr:])
    ttr, tev = (tb.transform(X[:n_tr], device="cpu"),
                tb.transform(X[n_tr:], device="cpu"))
    assert isinstance(ttr.codes, PackedCodes) == (NB == 16)
    kw.update(n_trees=3, max_depth=3, learning_rate=0.5)
    theirs = jax_gbdt.train(jax_gbdt.GBDTConfig(**kw), jtr, y[:n_tr],
                            eval_set=(jev, y[n_tr:]), plan=JAX_REFERENCE)
    ours = gbdt.train(gbdt.GBDTConfig(**kw), ttr, y[:n_tr],
                      eval_set=(tev, y[n_tr:]), device="cpu")
    m, j = ours.model, theirs.model
    feature = m.trees.feature.numpy()
    np.testing.assert_array_equal(feature, np.asarray(j.trees.feature))
    split = feature >= 0      # pass-through thresholds: ROADMAP Queue 3
    for field in ("threshold", "is_cat", "default_left"):
        np.testing.assert_array_equal(
            getattr(m.trees, field).numpy()[split],
            np.asarray(getattr(j.trees, field))[split], err_msg=field)
    _close(m.trees.leaf_value.numpy(), j.trees.leaf_value)
    for key in ("train_loss", "eval_loss"):
        np.testing.assert_allclose(ours.history[key], theirs.history[key],
                                   rtol=1e-5)
    _close(ours.margins.numpy(), j.predict_margin(jtr.codes))
    _close(m.predict_margin(ttr).numpy(), ours.margins.numpy())


@pytest.mark.parametrize("K,NB", CASES)
def test_round_step5_makes_no_gather_unpack_or_host_read(monkeypatch, K, NB):
    """Step ⑤ of a round reads neither the column-major copy (poisoned
    here) nor unpacks the packed codes, and makes no device->host read:
    no field check, no ``item``, ``int``, ``float``, ``bool``, ``tolist``,
    ``cpu`` or ``numpy`` of a tensor."""
    n, F, depth = 333, 21, 3
    forest = _as(_forest(K, depth, F, NB, seed=K), ref, _t)
    data = binning.dataset_from_codes(_codes(n, F, NB, seed=3), None, NB,
                                      device="cpu")
    want = trav_k.traverse_forest_plain(
        forest, binning.as_unpacked(data.codes), data.missing_bin)
    margins = _t(np.random.default_rng(K).normal(size=(n, K))
                 .astype(np.float32))
    expect = margins + want

    class Poison:
        def __getattr__(self, name):
            raise AssertionError(f"step ⑤ read the column-major copy "
                                 f"({name})")

    def refuse(*args, **kwargs):
        raise AssertionError("step ⑤ made a forbidden call")

    poisoned = dataclasses.replace(data, codes_cm=Poison())
    monkeypatch.setattr(PackedCodes, "unpack", refuse)
    monkeypatch.setattr(PackedCodes, "__getitem__", refuse)
    monkeypatch.setattr(ops, "unpack_codes", refuse)
    monkeypatch.setattr(trav_k, "check_fields", refuse)
    for name in ("item", "tolist", "cpu", "numpy", "__int__", "__float__",
                 "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    got = gbdt._predict_forest(forest, poisoned, None)
    out = gbdt._predict_forest(forest, poisoned, None, margins)
    monkeypatch.undo()
    assert torch.equal(got, want)
    assert out is margins and torch.equal(out, expect)


@pytest.mark.parametrize("name,n,F,K,packed", [
    ("higgs", 10_000_000, 28, 1, False),
    ("covertype", 581_012, 54, 7, False),
    ("iot", 2_000_000, 115, 1, True),
    ("iot eval set", 200_000, 115, 1, True)])
def test_staged_geometry_at_t_equals_k(name, n, F, K, packed):
    """Step ⑤ at the paths' shapes (T = K trees of depth 6) takes the
    staged entry with 512 records a block (256 threads of 2), all K trees
    in one staged block and four blocks an SM; packed rows stage
    ceil(F/2) bytes, padded to 4."""
    geo = trav_k.ensemble_geometry(n, F, K, 6, H100, packed=packed)
    row = 4 * -(-(-(-F // 2) if packed else F) // 4)
    assert geo.entry == "staged"
    assert (geo.records, geo.per_thread, geo.threads) == (512, 2, 256)
    assert geo.trees == K
    assert geo.smem == 512 * row + K * trav_k.tree_bytes(6)
    assert H100.sm_shared // (geo.smem + H100.block_reserved) >= 4


def test_packed_staged_limit_counts_bytes():
    """Packed rows hold two fields a byte, so the staged entry takes twice
    the fields; one field past it takes the wide entry."""
    top = trav_k.max_staged_fields(6, H100)
    assert trav_k.max_staged_fields(6, H100, packed=True) == 2 * top
    assert trav_k.ensemble_geometry(100, 2 * top, 1, 6, H100,
                                    packed=True).entry == "staged"
    assert trav_k.ensemble_geometry(100, 2 * top + 1, 1, 6, H100,
                                    packed=True).entry == "wide"
    assert trav_k.row_bytes(115, True) == 58
    assert trav_k.row_bytes(115, False) == 115


def test_plain_nibble_walk_reads_packed_rows_in_place():
    """The plain versions of the traversal and the ensemble read a packed
    row's nibbles as the kernel does: the walk over the unpacked codes."""
    n, F, NB, depth = 257, 13, 16, 4
    codes = _t(_codes(n, F, NB, seed=8))
    packed = PackedCodes.pack(codes)
    forest = _as(_forest(5, depth, F, NB, seed=8), ref, _t)
    assert torch.equal(trav_k.traverse_forest_plain(forest, packed, NB - 1),
                       trav_k.traverse_forest_plain(forest, codes, NB - 1))
    for K in (1, 5):
        assert torch.equal(
            trav_k.predict_ensemble_plain(forest, packed, NB - 1, K),
            trav_k.predict_ensemble_plain(forest, codes, NB - 1, K))


@pytest.mark.parametrize("K", [1, 3])
def test_grower_hands_the_partition_views_of_its_tables(monkeypatch, K):
    """Each level's four split arrays reach the partition as views of the
    (K, 2^D - 1) tree tables, which the kernel reads as they lie (int32,
    unit stride, one class stride): no stack, no cast, no copy."""
    n, F, NB, depth = 400, 9, 32, 3
    rng = np.random.default_rng(K)
    codes = _codes(n, F, NB, seed=K)
    data = binning.dataset_from_codes(codes, None, NB, device="cpu")
    g = _t((rng.integers(-64, 64, (K, n)) / 64).astype(np.float32))
    h = _t((rng.integers(1, 64, (K, n)) / 64).astype(np.float32))
    seen = []
    real = ops.partition_level_cm

    def spy(node_ids, codes_cm, *splits, **kw):
        parts, stride = part_k.split_arrays(
            *splits, node_ids.shape[:-1] + (splits[0].shape[-1],),
            node_ids.device, "spy")
        seen.append((splits, parts, stride))
        return real(node_ids, codes_cm, *splits, **kw)

    monkeypatch.setattr(ops, "partition_level_cm", spy)
    forest = tree_mod.fit_forest(
        data.codes, data.codes_cm, g, h, depth=depth, n_bins=NB,
        missing_bin=NB - 1, is_cat_field=data.is_categorical,
        field_mask=torch.ones(F, dtype=torch.bool), lambda_=1.0, gamma=0.0,
        min_child_weight=0.0)
    assert len(seen) == depth
    for level, (splits, parts, stride) in enumerate(seen):
        off, nn = 2 ** level - 1, 2 ** level
        for table, given, part in zip(forest[:4], splits, parts):
            assert given.shape == (K, nn) and given.dtype == torch.int32
            assert part.data_ptr() == given.data_ptr() \
                == table[:, off].data_ptr()
        assert stride == 2 ** depth - 1


def test_split_arrays_pass_views_and_copy_only_what_they_must():
    table = torch.arange(3 * 15, dtype=torch.int32).reshape(3, 15)
    views = [table[:, 3:7]] * 4
    parts, stride = part_k.split_arrays(*views, (3, 4), table.device, "t")
    assert stride == 15 and all(p.data_ptr() == views[0].data_ptr()
                                for p in parts)
    # mixed strides or dtypes: cast or made contiguous, one class stride
    mixed = [table[:, 3:7], table[:, 3:7].contiguous(),
             table[:, 3:7].to(torch.int64), table[:, 3:7].to(torch.bool)]
    parts, stride = part_k.split_arrays(*mixed, (3, 4), table.device, "t")
    assert stride == 4
    for part, given in zip(parts, mixed):
        assert part.dtype == torch.int32 and part.is_contiguous()
        assert torch.equal(part, given.to(torch.int32))
    one = [torch.arange(4, dtype=torch.int32)] * 4
    assert part_k.split_arrays(*one, (4,), table.device, "t")[1] == 0
    with pytest.raises(ValueError, match="split tables"):
        part_k.split_arrays(*views, (3, 5), table.device, "t")

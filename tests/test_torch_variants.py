"""The port's training variants against the JAX package, on the CPU.

Identical numpy inputs (from a seed) go to ``repro`` (CPU; its software
strategies, its Pallas histogram in interpret mode) and to the port (CPU,
plain versions):

* the plain histogram strategies (``scatter``, ``scatter_private``,
  ``sort``, ``onehot``) and ``accumulate_histogram``: bit-equal on dyadic
  g, h (every order of summation is exact);
* histogram subtraction: ``subtract_level_hist`` bit-equal to ``repro``'s
  and to the direct pass on dyadic stats, within rtol 1e-4 plus 1e-5 of
  the parent's largest bin on real stats; the subtraction grower's trees;
* the lossguide grower (``max_leaves``), the host split offload, the
  ``"scan"`` ensemble and GOSS;
* the legacy strategy fields and keywords, which warn and lift into the
  plan;
* within the port, fused rounds bit-equal to the host loop (trees, losses,
  margins) with every option.

Stochastic draws differ from ``repro``'s (JAX's threefry streams cannot be
reproduced): the GOSS fits inject ``repro``'s weights into both growers.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ExecutionPlan as JaxPlan
from repro.core import binning as jax_binning
from repro.core import gbdt as jax_gbdt
from repro.core import splits as jax_splits
from repro.core import tree as jax_tree
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref

from repro_torch.api.plan import ExecutionPlan
from repro_torch.core import binning, gbdt, splits, tree
from repro_torch.data import make_tabular
from repro_torch.kernels import ops, ref

PLAIN = ("scatter", "scatter_private", "sort", "onehot")
# the port's step-① strategy -> repro's that takes the same route
JAX_HIST = {"reference": "scatter", "scatter": "scatter",
            "cuda": "pallas_grouped"}


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _inputs(n, F, n_bins, NN, K, seed, dyadic=True):
    """Codes (10 % missing), stats (K, n) (K = None: (n,)) and node ids."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, n_bins, (n, F)).astype(np.uint8)
    codes[rng.uniform(size=codes.shape) < 0.1] = n_bins - 1
    shape = (n,) if K is None else (K, n)
    if dyadic:
        g = rng.integers(-64, 65, shape).astype(np.float32) / 64
        h = rng.integers(1, 65, shape).astype(np.float32) / 64
    else:
        g = rng.normal(size=shape).astype(np.float32)
        h = rng.uniform(0.1, 1.0, shape).astype(np.float32)
    nid = rng.integers(0, NN, shape).astype(np.int32)
    return codes, g, h, nid


def _fields(F, rng):
    is_cat = np.zeros(F, bool)
    is_cat[-1] = True
    mask = np.ones(F, bool)
    mask[rng.integers(0, F)] = False
    return is_cat, mask


def _assert_trees(ours, theirs, rtol=1e-5):
    for field in ("feature", "threshold", "is_cat", "default_left"):
        np.testing.assert_array_equal(_np(getattr(ours, field)),
                                      _np(getattr(theirs, field)),
                                      err_msg=field)
    np.testing.assert_allclose(_np(ours.leaf_value), _np(theirs.leaf_value),
                               rtol=rtol, atol=1e-7)


def _assert_bit_equal_trees(a, b):
    for field, u, v in zip(a._fields, a, b):
        assert torch.equal(u, v), field


# --------------------------------------------------------------------------
# step ① — the plain strategies and the accumulator
# --------------------------------------------------------------------------
@pytest.mark.parametrize("K", [None, 3])
@pytest.mark.parametrize("strategy", PLAIN)
def test_plain_hist_strategies_match_jax(strategy, K):
    codes, g, h, nid = _inputs(2100, 5, 16, 4, K, seed=3)
    ours = ops.build_histogram(torch.from_numpy(codes), torch.from_numpy(g),
                               torch.from_numpy(h), torch.from_numpy(nid),
                               n_nodes=4, n_bins=16,
                               plan=ExecutionPlan(hist_strategy=strategy))
    theirs = jax_ops.build_histogram(
        jnp.asarray(codes), jnp.asarray(g), jnp.asarray(h), jnp.asarray(nid),
        n_nodes=4, n_bins=16, plan=JaxPlan(hist_strategy=strategy))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    # the same sums from 4-bit packed codes, which the strategy unpacks
    packed = ops.build_histogram(
        binning.PackedCodes.pack(torch.from_numpy(codes)),
        torch.from_numpy(g), torch.from_numpy(h), torch.from_numpy(nid),
        n_nodes=4, n_bins=16, plan=ExecutionPlan(hist_strategy=strategy))
    assert torch.equal(packed, ours)


def test_accumulate_histogram_matches_jax():
    codes, g, h, nid = _inputs(1000, 4, 8, 2, 2, seed=5)
    plan, jplan = ExecutionPlan(hist_strategy="sort"), JaxPlan(
        hist_strategy="sort")
    acc = torch.zeros((2, 2, 4, 8, 2))
    jacc = jnp.zeros((2, 2, 4, 8, 2))
    for lo in range(0, 1000, 300):
        sl = slice(lo, lo + 300)
        out = ops.accumulate_histogram(
            acc, torch.from_numpy(codes[sl]), torch.from_numpy(g[:, sl]),
            torch.from_numpy(h[:, sl]), torch.from_numpy(nid[:, sl]),
            n_nodes=2, n_bins=8, plan=plan)
        assert out is acc                       # in place
        jacc = jax_ops.accumulate_histogram(
            jacc, jnp.asarray(codes[sl]), jnp.asarray(g[:, sl]),
            jnp.asarray(h[:, sl]), jnp.asarray(nid[:, sl]), n_nodes=2,
            n_bins=8, plan=jplan)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    whole = ops.build_histogram(torch.from_numpy(codes), torch.from_numpy(g),
                                torch.from_numpy(h), torch.from_numpy(nid),
                                n_nodes=2, n_bins=8, plan=plan)
    assert torch.equal(acc, whole)


# --------------------------------------------------------------------------
# histogram subtraction
# --------------------------------------------------------------------------
def _level_inputs(K, seed, dyadic):
    """A level-2 split of every class's records and its parent level's
    direct histogram: (codes, g, h, parent ids, child ids)."""
    codes, g, h, parent = _inputs(900, 4, 16, 2, K, seed, dyadic)
    rng = np.random.default_rng(seed + 1)
    child = (2 * parent + rng.integers(0, 2, parent.shape)).astype(np.int32)
    return codes, g, h, parent, child


def _resident(codes, g, h, node_ids, plan, n_bins=16):
    """The in-memory record layout with its records at ``node_ids``."""
    records = tree.ResidentRecords(codes, None, g, h, n_bins=n_bins,
                                   missing_bin=n_bins - 1, plan=plan)
    records.node_ids = node_ids
    return records


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("strategy", ["reference", "scatter", "cuda"])
def test_subtract_level_hist_matches_jax(strategy, K):
    for dyadic in (True, False):
        codes, g, h, parent, child = _level_inputs(K, 11 + K, dyadic)
        plan = ExecutionPlan(hist_strategy=strategy).resolved()
        t = [torch.from_numpy(a) for a in (codes, g, h, parent, child)]
        parent_hist = ops.build_histogram(t[0], t[1], t[2], t[3], n_nodes=2,
                                          n_bins=16, plan=plan)
        ours = tree.subtract_level_hist(
            _resident(t[0], t[1], t[2], t[4], plan), parent_hist, 4)
        direct = ops.build_histogram(t[0], t[1], t[2], t[4], n_nodes=4,
                                     n_bins=16, plan=plan)
        if not dyadic:
            mag = float(parent_hist.abs().max())
            np.testing.assert_allclose(ours.numpy(), direct.numpy(),
                                       rtol=1e-4, atol=1e-5 * mag)
            continue
        assert torch.equal(ours, direct)
        jplan = JaxPlan(hist_strategy=JAX_HIST[strategy]).resolved()
        j = [jnp.asarray(a) for a in (codes, g, h, parent, child)]
        jparent = jax_ops.build_histogram(j[0], j[1], j[2], j[3], n_nodes=2,
                                          n_bins=16, plan=jplan)
        theirs = jax_tree._subtract_level_hist(j[0], j[1], j[2], j[4],
                                               jparent, n_nodes=4, n_bins=16,
                                               plan=jplan)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


def test_compaction_carries_half_the_records():
    """K = 1 compacts the smaller children into an n // 2 buffer: what the
    histogram launch is given."""
    codes, g, h, _, child = _level_inputs(1, 4, True)
    seen = []
    real = ops.build_histogram

    def spy(codes, g, *a, **kw):
        seen.append((codes.shape[0], g.shape))
        return real(codes, g, *a, **kw)

    t = [torch.from_numpy(a) for a in (codes, g, h, child)]
    ops.build_histogram = spy
    try:
        tree.subtract_level_hist(
            _resident(t[0], t[1], t[2], t[3], ExecutionPlan().resolved()),
            torch.zeros((1, 2, 4, 16, 2)), 4)
    finally:
        ops.build_histogram = real
    assert seen == [(450, (450,))]


def _grower_inputs(K, seed, n=1500, F=6, n_bins=16):
    X, _, _ = make_tabular(n, F - 1, 1, n_cats=3, missing_rate=0.05,
                           seed=seed)
    codes = jax_binning.Binner(n_bins, [F - 1]).fit(X).transform_codes(X)
    rng = np.random.default_rng(seed)
    shape = (n,) if K is None else (K, n)
    g = rng.integers(-64, 65, shape).astype(np.float32) / 64
    h = rng.integers(1, 65, shape).astype(np.float32) / 64
    is_cat = np.arange(F) == F - 1
    return codes, g, h, is_cat


def _common(n_bins, is_cat, F, lib):
    mask = np.ones(F, bool)
    if lib is jnp:
        is_cat_t, mask_t = jnp.asarray(is_cat), jnp.asarray(mask)
    else:
        is_cat_t, mask_t = torch.from_numpy(is_cat), torch.from_numpy(mask)
    return dict(n_bins=n_bins, missing_bin=n_bins - 1, is_cat_field=is_cat_t,
                field_mask=mask_t, lambda_=1.0, gamma=0.0,
                min_child_weight=0.5)


@pytest.mark.parametrize("K", [1, 3])
def test_subtraction_fit_forest_matches_jax(K):
    codes, g, h, is_cat = _grower_inputs(K, seed=7)
    F = codes.shape[1]
    ds = binning.dataset_from_codes(codes, is_cat, 16, packed=False,
                                    device="cpu")
    jds = jax_binning.dataset_from_codes(codes, jnp.asarray(is_cat), 16,
                                         packed=False)
    ours = tree.fit_forest(ds.codes, ds.codes_cm, torch.from_numpy(g),
                           torch.from_numpy(h), depth=4,
                           plan=ExecutionPlan(hist_subtraction=True),
                           **_common(16, is_cat, F, torch))
    theirs = jax_tree.fit_forest(
        jds.codes, jds.codes_cm, jnp.asarray(g), jnp.asarray(h), depth=4,
        plan=JaxPlan(hist_strategy="scatter", partition_strategy="reference",
                     hist_subtraction=True), **_common(16, is_cat, F, jnp))
    _assert_trees(ours, theirs)
    direct = tree.fit_forest(ds.codes, ds.codes_cm, torch.from_numpy(g),
                             torch.from_numpy(h), depth=4,
                             **_common(16, is_cat, F, torch))
    _assert_bit_equal_trees(ours, direct)       # dyadic stats: exact


# --------------------------------------------------------------------------
# the lossguide grower
# --------------------------------------------------------------------------
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("max_leaves", [None, 8, 13])
def test_lossguide_matches_jax(max_leaves, packed):
    codes, g, h, is_cat = _grower_inputs(None, seed=9)
    F = codes.shape[1]
    ds = binning.dataset_from_codes(codes, is_cat, 16, packed=packed,
                                    device="cpu")
    jds = jax_binning.dataset_from_codes(codes, jnp.asarray(is_cat), 16,
                                         packed=packed)
    ours = tree.fit_tree_lossguide(
        ds.codes, ds.codes_cm, torch.from_numpy(g), torch.from_numpy(h),
        depth=4, max_leaves=max_leaves, **_common(16, is_cat, F, torch))
    theirs = jax_tree.fit_tree_lossguide(
        jds.codes, jds.codes_cm, jnp.asarray(g), jnp.asarray(h), depth=4,
        max_leaves=max_leaves, plan=JaxPlan(hist_strategy="scatter"),
        **_common(16, is_cat, F, jnp))
    _assert_trees(ours, theirs)
    splits_made = int((ours.feature >= 0).sum())
    assert splits_made + 1 <= (max_leaves or 16)


def test_lossguide_histograms_one_a_node():
    """The root and the smaller child of every split: 1 + splits launches,
    each at one node."""
    codes, g, h, is_cat = _grower_inputs(None, seed=10)
    ds = binning.dataset_from_codes(codes, is_cat, 16, device="cpu")
    calls = []
    real = ops.build_histogram

    def spy(*a, n_nodes, **kw):
        calls.append(n_nodes)
        return real(*a, n_nodes=n_nodes, **kw)

    ops.build_histogram = spy
    try:
        out = tree.fit_tree_lossguide(
            ds.codes, ds.codes_cm, torch.from_numpy(g), torch.from_numpy(h),
            depth=4, max_leaves=6, **_common(16, is_cat, codes.shape[1],
                                             torch))
    finally:
        ops.build_histogram = real
    assert calls == [1] * (1 + int((out.feature >= 0).sum()))


# --------------------------------------------------------------------------
# step ② on the host
# --------------------------------------------------------------------------
def _dyadic_hist(NN, F, NB, seed):
    rng = np.random.default_rng(seed)
    hist = np.stack([rng.integers(-64, 65, (NN, F, NB)) / 64,
                     rng.integers(0, 65, (NN, F, NB)) / 64], -1)
    # every record carries every field: the node's sums agree across fields
    hist[:, :, -1] += hist[:, :1].sum(2) - hist.sum(2)
    hist[:, :, -1, 1] = np.abs(hist[:, :, -1, 1])
    return hist.astype(np.float32)


def test_np_best_splits_matches_jax():
    hist = _dyadic_hist(6, 5, 8, seed=2)
    is_cat, mask = _fields(5, np.random.default_rng(2))
    ours = splits._np_best_splits(hist, is_cat, mask, 1.0, 0.0, 0.5)
    theirs = jax_splits._np_best_splits(hist, is_cat, mask, 1.0, 0.0, 0.5)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_find_best_splits_host_matches_device():
    hist = torch.from_numpy(_dyadic_hist(8, 6, 16, seed=4))
    is_cat, mask = (torch.from_numpy(a) for a in
                    _fields(6, np.random.default_rng(4)))
    host = splits.find_best_splits_host(hist, is_cat, mask, 1.0, 0.0, 0.5)
    dev = splits.find_best_splits(hist, is_cat, mask, 1.0, 0.0, 0.5)
    for name, a, b in zip(dev._fields, host, dev):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_host_offload_fit_matches_device_fit():
    codes, g, h, is_cat = _grower_inputs(2, seed=12)
    ds = binning.dataset_from_codes(codes, is_cat, 16, device="cpu")
    kw = dict(depth=4, **_common(16, is_cat, codes.shape[1], torch))
    args = (ds.codes, ds.codes_cm, torch.from_numpy(g), torch.from_numpy(h))
    host = tree.fit_forest(*args, plan=ExecutionPlan(host_offload_split=True),
                           **kw)
    _assert_bit_equal_trees(host, tree.fit_forest(*args, **kw))


# --------------------------------------------------------------------------
# the "scan" ensemble
# --------------------------------------------------------------------------
@pytest.mark.parametrize("K", [1, 3])
def test_scan_ensemble_matches_jax(K):
    rng = np.random.default_rng(K)
    T, depth, F, NB = 6 * K, 3, 5, 16
    arrays = [rng.integers(-1, F, (T, 7)), rng.integers(0, NB - 1, (T, 7)),
              rng.integers(0, 2, (T, 7)), rng.integers(0, 2, (T, 7))]
    arrays = [a.astype(np.int32) for a in arrays] + [
        rng.normal(size=(T, 8)).astype(np.float32)]
    codes = rng.integers(0, NB, (300, F)).astype(np.uint8)
    trees = ref.TreeArrays(*[torch.from_numpy(a) for a in arrays])
    ours = ops.predict_ensemble(trees, torch.from_numpy(codes),
                                missing_bin=NB - 1, depth=depth,
                                plan=ExecutionPlan(traversal_strategy="scan"),
                                n_classes=K)
    theirs = jax_ref.predict_ensemble_ref(
        jax_ref.TreeArrays(*[jnp.asarray(a) for a in arrays]),
        jnp.asarray(codes), NB - 1, n_classes=K)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-5,
                               atol=1e-6)
    # tree order, as the plain ensemble adds: bit for bit
    plain = ops.predict_ensemble(
        trees, torch.from_numpy(codes), missing_bin=NB - 1, depth=depth,
        plan=ExecutionPlan(traversal_strategy="reference"), n_classes=K)
    assert torch.equal(ours, plain)


# --------------------------------------------------------------------------
# GOSS
# --------------------------------------------------------------------------
@pytest.mark.parametrize("K", [None, 3])
def test_goss_weights_match_jax(K):
    rng = np.random.default_rng(5)
    shape = (1000,) if K is None else (1000, K)
    # coarse values: many ties, which the stable sort orders by position
    g = (rng.integers(-20, 21, shape) / 8).astype(np.float32)
    top, other = 0.2, 0.1
    theirs = np.asarray(jax_gbdt.goss_weights(jnp.asarray(g),
                                              jax.random.PRNGKey(0), top,
                                              other))
    gen = torch.Generator().manual_seed(0)
    ours = gbdt.goss_weights(torch.from_numpy(g), gen, top, other).numpy()
    np.testing.assert_array_equal(ours == 1.0, theirs == 1.0)   # top set
    amp = np.float32((1.0 - top) / other)
    assert set(np.unique(ours)) == set(np.unique(theirs)) == {0.0, 1.0, amp}
    assert (ours == amp).sum() == (theirs == amp).sum() == 100
    # the sample lies outside the top set, drawn from the given pick
    n_top, n_other = gbdt.goss_sizes(1000, top, other)
    order = np.argsort(-(np.abs(g) if K is None else np.abs(g).sum(-1)),
                       kind="stable")
    pick = torch.arange(n_other) * 3
    picked = gbdt.goss_weights(torch.from_numpy(g), None, top, other,
                               pick=pick).numpy()
    assert set(np.flatnonzero(picked == amp)) == set(
        order[n_top:][pick.numpy()])


@pytest.mark.parametrize("K", [1, 3])
def test_goss_fit_matches_jax(K):
    """``repro``'s GOSS weights injected into both growers give the same
    trees."""
    codes, g, h, is_cat = _grower_inputs(K, seed=13)
    w = np.asarray(jax_gbdt.goss_weights(jnp.asarray(g.T),
                                         jax.random.PRNGKey(3), 0.2, 0.1))
    gw, hw = g * w, h * w
    F = codes.shape[1]
    ds = binning.dataset_from_codes(codes, is_cat, 16, device="cpu")
    jds = jax_binning.dataset_from_codes(codes, jnp.asarray(is_cat), 16)
    ours = tree.fit_forest(ds.codes, ds.codes_cm, torch.from_numpy(gw),
                           torch.from_numpy(hw), depth=4,
                           **_common(16, is_cat, F, torch))
    theirs = jax_tree.fit_forest(
        jds.codes, jds.codes_cm, jnp.asarray(gw), jnp.asarray(hw), depth=4,
        plan=JaxPlan(hist_strategy="scatter", partition_strategy="reference"),
        **_common(16, is_cat, F, jnp))
    _assert_trees(ours, theirs)


# --------------------------------------------------------------------------
# the legacy strategy fields and keywords
# --------------------------------------------------------------------------
@pytest.mark.parametrize("field,value,lifted", [
    ("hist_strategy", "pallas_grouped", "cuda"),
    ("hist_strategy", "pallas_packed", "cuda_packed"),
    ("hist_strategy", "scatter", "scatter"),
    ("partition_strategy", "pallas", "cuda"),
    ("traversal_strategy", "scan", "scan"),
    ("host_offload_split", True, True)])
def test_legacy_config_fields_warn_and_lift(field, value, lifted):
    with pytest.warns(DeprecationWarning, match="deprecated"):
        config = gbdt.GBDTConfig(n_trees=2, max_depth=2, **{field: value})
    plan = ExecutionPlan.from_config(config)
    assert getattr(plan, field) == lifted
    assert plan == ExecutionPlan(**{field: lifted}).resolved()
    # train lifts them itself when no plan is given
    X, y, _ = make_tabular(300, 3, 0, seed=1)
    codes = binning.Binner(8).fit(X).transform_codes(X)
    data = binning.dataset_from_codes(codes, None, 8, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        got = gbdt.train(config, data, y, device="cpu")
        want = gbdt.train(gbdt.GBDTConfig(n_trees=2, max_depth=2), data, y,
                          plan=plan, device="cpu")
    _assert_bit_equal_trees(got.model.trees, want.model.trees)


def test_legacy_grower_keywords_warn_and_lift():
    codes, g, h, is_cat = _grower_inputs(None, seed=14)
    ds = binning.dataset_from_codes(codes, is_cat, 16, device="cpu")
    args = (ds.codes, ds.codes_cm, torch.from_numpy(g), torch.from_numpy(h))
    kw = dict(depth=3, **_common(16, is_cat, codes.shape[1], torch))
    with pytest.warns(DeprecationWarning, match="hist_strategy"):
        a = tree.fit_tree(*args, hist_strategy="pallas_grouped",
                          partition_strategy="pallas", **kw)
    with pytest.warns(DeprecationWarning, match="host_offload_split"):
        b = tree.fit_tree(*args, host_offload_split=True, **kw)
    with pytest.warns(DeprecationWarning, match="hist_strategy"):
        c = tree.fit_tree_lossguide(*args, hist_strategy="scatter", **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        d = tree.fit_tree(*args, **kw)
        e = tree.fit_tree_lossguide(*args, **kw)
    _assert_bit_equal_trees(a, d)
    _assert_bit_equal_trees(b, d)
    _assert_bit_equal_trees(c, e)


def test_plan_variants_resolve_and_describe():
    plan = ExecutionPlan().resolved()
    assert plan.hist_subtraction is False and not plan.host_offload_split
    sub = ExecutionPlan(hist_subtraction=True, host_offload_split=True,
                        hist_strategy="onehot").resolved()
    assert sub.describe() == ("ExecutionPlan(hist=onehot+sub, split=host, "
                              "partition=cuda, traversal=cuda, "
                              "single-device)")
    for bad in (dict(hist_strategy="pallas_grouped"),
                dict(partition_strategy="pallas"),
                dict(traversal_strategy="pallas")):
        with pytest.raises(ValueError):
            ExecutionPlan(**bad)


# --------------------------------------------------------------------------
# fused rounds: bit-equal to the host loop
# --------------------------------------------------------------------------
FUSED_CASES = {
    "squared": dict(objective="reg:squarederror"),
    "logistic": dict(objective="binary:logistic"),
    "stochastic": dict(objective="binary:logistic", subsample=0.7,
                       colsample_bytree=0.6),
    "goss": dict(objective="reg:squarederror", goss_top_rate=0.2,
                 goss_other_rate=0.1),
    "softmax": dict(objective="multi:softmax", n_classes=3, subsample=0.8),
    "early_stop": dict(objective="binary:logistic", learning_rate=2.0,
                       early_stopping_rounds=1),
    "subtraction": dict(objective="multi:softmax", n_classes=3),
}


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_rounds_bit_equal_host_loop(case):
    kw = dict(FUSED_CASES[case])
    task = ("multiclass" if "n_classes" in kw else
            "binary" if kw["objective"] == "binary:logistic" else
            "regression")
    X, y, cats = make_tabular(1800, 5, 1, n_cats=3, task=task, n_classes=3,
                              missing_rate=0.05, seed=21)
    binner = binning.Binner(16, cats).fit(X[:1500])
    data = binner.transform(X[:1500], device="cpu")
    ev = (binner.transform(X[1500:], device="cpu"), y[1500:])
    plan = ExecutionPlan(hist_subtraction=case == "subtraction")
    config = gbdt.GBDTConfig(n_trees=6, max_depth=3, seed=5, **kw)
    host = gbdt.train(config, data, y[:1500], eval_set=ev, plan=plan,
                      device="cpu")
    fused = gbdt.train(dataclasses.replace(config, fused_rounds=True), data,
                       y[:1500], eval_set=ev, plan=plan, device="cpu")
    _assert_bit_equal_trees(host.model.trees, fused.model.trees)
    assert host.history == fused.history
    assert torch.equal(host.margins, fused.margins)
    rounds = host.model.n_rounds
    if case == "early_stop":
        assert rounds < 6
    assert fused.stats["graph_captures"] + fused.stats["graph_replays"] \
        == rounds


def test_fused_warm_start_bit_equal_host_loop():
    """A fused fit continued from a model replays its margins and grows on
    as the host loop does, bit for bit."""
    X, y, _ = make_tabular(900, 5, 0, task="binary", seed=6)
    data = binning.Binner(32).fit(X).transform(X, device="cpu")
    config = gbdt.GBDTConfig(n_trees=3, max_depth=3,
                             objective="binary:logistic", subsample=0.8)
    first = gbdt.train(config, data, y, device="cpu").model
    host = gbdt.train(config, data, y, init_model=first, device="cpu")
    fused = gbdt.train(dataclasses.replace(config, fused_rounds=True), data,
                       y, init_model=first, device="cpu")
    assert fused.model.n_trees == 6
    _assert_bit_equal_trees(host.model.trees, fused.model.trees)
    assert host.history == fused.history
    assert torch.equal(host.margins, fused.margins)


def test_fused_step_is_cached_across_fits():
    """A second fit of the same step key (another seed) traces nothing."""
    X, y, _ = make_tabular(500, 4, 0, seed=2)
    data = binning.Binner(16).fit(X).transform(X, device="cpu")
    gbdt.round_step_cache_clear()
    config = gbdt.GBDTConfig(n_trees=3, max_depth=3, fused_rounds=True,
                             subsample=0.8)
    first = gbdt.train(config, data, y, device="cpu").stats
    again = gbdt.train(dataclasses.replace(config, seed=9), data, y,
                       device="cpu").stats
    assert (first["graph_captures"], first["graph_replays"]) == (1, 2)
    assert (again["graph_captures"], again["graph_replays"]) == (0, 3)

"""Multi-class (``multi:softmax``) in the port against the JAX package.

Each case feeds the same numpy inputs, made from a seed, to ``repro`` and
``repro_torch`` (plain versions on the CPU; Pallas kernels in interpret
mode at tiny shapes).  Tolerances:

* softmax value, grad, hess and base margin: rtol 1e-6;
* class-batched histograms: bit-equal on dyadic g, h;
* class-batched partition and traversal: bit-equal (integer decisions);
* multi-class ensembles: rtol 1e-5, exact on dyadic leaves;
* ``fit_forest``: integer tables bit-equal, leaves rtol 1e-5;
* ``train``: tree structure identical, leaves and (n, K) margins within
  rtol 1e-5 plus 1e-5 of the largest |value| (XLA's CPU ``exp`` and
  torch's differ in the last ulp, and a leaf's G = Σg cancels).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ExecutionPlan as JaxPlan
from repro.core import binning as jax_binning
from repro.core import gbdt as jax_gbdt
from repro.core import losses as jax_losses
from repro.core import splits as jax_splits
from repro.core import tree as jax_tree
from repro.kernels import histogram as jax_hist
from repro.kernels import ops as jax_ops
from repro.kernels import partition as jax_part
from repro.kernels import ref as jax_ref
from repro.kernels import traversal as jax_trav

from repro_torch.core import binning, gbdt, losses, tree
from repro_torch.data import make_tabular
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import histogram as hist_k
from repro_torch.kernels import partition as part_k
from repro_torch.kernels import traversal as trav_k

JAX_REFERENCE = JaxPlan(hist_strategy="scatter",
                        partition_strategy="reference",
                        traversal_strategy="reference")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, rtol=1e-5):
    """rtol plus ``rtol`` of the largest |want|."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _base_margin_close(got, want, y, K):
    """The base margin is log p minus its mean: an ulp of log p (XLA's CPU
    log against torch's) is judged against |log p|, which centring
    cancels — rtol 1e-6 plus 1e-6 of the largest |log p|."""
    p = np.clip(np.bincount(np.asarray(y).astype(int), minlength=K)
                / len(y), 1e-6, 1)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6,
                               atol=1e-6 * np.abs(np.log(p)).max())


# -- losses ----------------------------------------------------------------
@pytest.mark.parametrize("K,seed", [(2, 0), (3, 1), (7, 2)])
def test_softmax_matches_jax(K, seed):
    rng = np.random.default_rng(seed)
    n = 1001
    margin = (rng.normal(size=(n, K)) * 3).astype(np.float32)
    margin[0] = 40.0 * (np.arange(K) == 0)        # saturated probabilities
    y = rng.integers(0, K, n).astype(np.float32)
    y[:5] = 0                                      # class 0 most frequent
    ours, theirs = losses.get_loss("multi:softmax", K), \
        jax_losses.get_loss("multi:softmax", K)
    assert ours.n_outputs == theirs.n_outputs == K
    m, yt, jm, jy = _t(margin), _t(y), jnp.asarray(margin), jnp.asarray(y)
    for a, b in zip(ours.grad_hess(m, yt), theirs.grad_hess(jm, jy)):
        assert a.shape == (n, K)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    assert float(ours.grad_hess(m, yt)[1].min()) >= 1e-16   # floored h
    np.testing.assert_allclose(ours.value(m, yt).numpy(),
                               np.asarray(theirs.value(jm, jy)), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(ours.transform(m).numpy(),
                               np.asarray(theirs.transform(jm)), rtol=1e-6,
                               atol=1e-7)
    # one class absent: its prior clamps at 1e-6
    y_gap = np.where(y == K - 1, 0, y).astype(np.float32)
    for labels in (y, y_gap):
        _base_margin_close(ours.base_margin(_t(labels)).numpy(),
                           theirs.base_margin(jnp.asarray(labels)), labels, K)


# -- step ① ----------------------------------------------------------------
def _class_stats(K, n, NN, seed, dyadic=True):
    rng = np.random.default_rng(seed)
    if dyadic:
        g = (rng.integers(-64, 64, (K, n)) / 64).astype(np.float32)
        h = (rng.integers(1, 64, (K, n)) / 64).astype(np.float32)
    else:
        g = rng.normal(size=(K, n)).astype(np.float32)
        h = rng.uniform(0.1, 1.0, (K, n)).astype(np.float32)
    nid = rng.integers(0, NN, (K, n)).astype(np.int32)
    return g, h, nid


@pytest.mark.parametrize("n,F,NB,NN,K", [(200, 3, 8, 2, 3), (515, 6, 16, 4, 4),
                                         (300, 2, 256, 1, 2)])
def test_class_batched_histogram_matches_jax(n, F, NB, NN, K):
    rng = np.random.default_rng(n)
    codes = rng.integers(0, NB, (n, F)).astype(np.uint8)
    codes[:, -1] = NB - 1                          # an all-missing column
    g, h, nid = _class_stats(K, n, NN, seed=F)
    got = ref.histogram_ref(_t(codes), _t(g), _t(h), _t(nid), NN, NB)
    assert got.shape == (K, NN, F, NB, 2) and got.dtype == torch.float32
    args = [jnp.asarray(a) for a in (codes, g, h, nid)]
    want_scatter = jax_ops.build_histogram(
        *args, n_nodes=NN, n_bins=NB, plan=JaxPlan(hist_strategy="scatter"))
    want_pallas = jax_hist.histogram_pallas(*args, n_nodes=NN, n_bins=NB,
                                            interpret=True)
    for want in (want_scatter, want_pallas):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # every class is its own single-class histogram
    for k in range(K):
        assert torch.equal(got[k], ref.histogram_ref(
            _t(codes), _t(g[k]), _t(h[k]), _t(nid[k]), NN, NB))
    _build.reset_launch_counts()
    for out in (ops.build_histogram(_t(codes), _t(g), _t(h), _t(nid),
                                    n_nodes=NN, n_bins=NB),
                hist_k.histogram_cuda(_t(codes), _t(g), _t(h), _t(nid),
                                      n_nodes=NN, n_bins=NB)):
        assert torch.equal(out, got)
    assert _build.launch_counts()["histogram"] == 0     # CPU: plain version


@pytest.mark.parametrize("K,NN,F,NB", [(7, 32, 54, 256), (3, 64, 10, 128),
                                       (1, 32, 28, 256), (2, 3000, 2, 256)])
def test_class_slot_naive_geometry(K, NN, F, NB):
    """The naive-packing kernel takes the class-major K·NN slots as the
    grouped kernel does: one slot's bins at a time, whatever K·NN, so its
    shared memory holds one slot's fields and K only lengthens the sorted
    list that the blocks share."""
    # what csrc/histogram.cu's kernels and an H100 SXM give
    limits = hist_k.GroupedLimits(blocks_per_sm=1, naive_blocks_per_sm=3,
                                  sort_node_bytes=12, sms=132,
                                  sm_shared=233_472, block_reserved=1_024,
                                  block_shared=232_448)
    n = 581_012
    geo = hist_k.grouped_geometry(n, K, NN, F, NB, limits, naive=True)
    one = hist_k.grouped_geometry(n, 1, 1, F, NB, limits, naive=True)
    assert geo.smem == one.smem == 8 * NB * geo.field_tile <= limits.budget
    assert (geo.field_tile, geo.n_ftiles) == (one.field_tile, one.n_ftiles)
    assert geo.blocks * geo.per_block >= K * n > \
        (geo.blocks - 1) * geo.per_block
    assert NN <= limits.max_sort_nodes
    assert geo.sort_blocks * geo.sort_chunk >= n


# -- step ③ ----------------------------------------------------------------
def _class_splits(K, nn, F, NB, rng):
    return (rng.integers(-1, F, (K, nn)).astype(np.int32),
            rng.integers(0, NB, (K, nn)).astype(np.int32),
            rng.integers(0, 2, (K, nn)).astype(np.int32),
            rng.integers(0, 2, (K, nn)).astype(np.int32))


@pytest.mark.parametrize("n,K,nn,F,NB", [(513, 3, 4, 6, 16),
                                         (1200, 4, 8, 28, 256)])
def test_class_batched_partition_matches_jax_vmap(n, K, nn, F, NB):
    """The grower's step ③ as ``repro.core.tree._fit_forest_jit`` runs it:
    a per-class gather of the split columns, then ``partition_pallas``
    (and ``partition_ref``) vmapped over the class axis."""
    rng = np.random.default_rng(n + K)
    nid = rng.integers(0, nn, (K, n)).astype(np.int32)
    codes_cm = rng.integers(0, NB, (F, n)).astype(np.uint8)
    codes_cm[rng.uniform(size=codes_cm.shape) < 0.2] = NB - 1
    f, thr, cat, dl = _class_splits(K, nn, F, NB, rng)
    got = ref.partition_cm_ref(_t(nid), _t(codes_cm), _t(f), _t(thr),
                               _t(cat), _t(dl), NB - 1)
    assert got.shape == (K, n) and got.dtype == torch.int32
    do_split = jnp.asarray(f >= 0)
    lvl = jax_tree._gather_fields(jnp.asarray(codes_cm),
                                  jnp.where(do_split, jnp.asarray(f), 0))
    renum = jnp.where(do_split, jnp.broadcast_to(
        jnp.arange(nn, dtype=jnp.int32), (K, nn)), -1)
    args = (jnp.asarray(nid), lvl.transpose(0, 2, 1), renum,
            jnp.asarray(thr), jnp.asarray(cat), jnp.asarray(dl))
    want_pallas = jax.vmap(functools.partial(
        jax_part.partition_pallas, missing_bin=NB - 1, interpret=True))(*args)
    want_ref = jax.vmap(functools.partial(jax_ref.partition_ref,
                                          missing_bin=NB - 1))(*args)
    for want in (want_pallas, want_ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for fn in (part_k.partition_cm_cuda, ops.partition_level_cm):
        out = fn(_t(nid), _t(codes_cm), _t(f), _t(thr), _t(cat), _t(dl),
                 missing_bin=NB - 1)
        assert torch.equal(out, got)
    # K = 1 of the class-batched entry is the single-class entry
    one = part_k.partition_cm_plain(_t(nid[0]), _t(codes_cm), _t(f[0]),
                                    _t(thr[0]), _t(cat[0]), _t(dl[0]), NB - 1)
    assert torch.equal(one, got[0])


# -- step ⑤ and batch inference ---------------------------------------------
def _random_forest(K, depth, n_cols, NB, seed, dyadic=False):
    rng = np.random.default_rng(seed)
    n_int = 2 ** depth - 1
    leaves = (rng.integers(-64, 65, (K, 2 ** depth)) / 64 if dyadic
              else rng.normal(size=(K, 2 ** depth)))
    return dict(
        feature=rng.integers(-1, n_cols, (K, n_int)).astype(np.int32),
        threshold=rng.integers(0, NB - 1, (K, n_int)).astype(np.int32),
        is_cat=rng.integers(0, 2, (K, n_int)).astype(np.int32),
        default_left=rng.integers(0, 2, (K, n_int)).astype(np.int32),
        leaf_value=leaves.astype(np.float32))


def _codes(n, C, NB, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, NB, (n, C)).astype(np.uint8)
    codes[rng.uniform(size=codes.shape) < 0.1] = NB - 1
    return codes


def _as(trees, mod, conv):
    return mod.TreeArrays(**{k: conv(v) for k, v in trees.items()})


@pytest.mark.parametrize("n,K,depth,C,NB", [(777, 3, 3, 5, 16),
                                            (1024, 7, 6, 54, 256)])
def test_class_batched_traversal_matches_jax_vmap(n, K, depth, C, NB):
    forest = _random_forest(K, depth, C, NB, seed=K)
    codes = _codes(n, C, NB, seed=n)
    got = ref.traverse_forest_ref(_as(forest, ref, _t), _t(codes), NB - 1)
    assert got.shape == (n, K) and got.dtype == torch.float32
    jf = _as(forest, jax_ref, jnp.asarray)
    want = jax.vmap(lambda t: jax_trav.traverse_pallas(
        t, jnp.asarray(codes), missing_bin=NB - 1, interpret=True))(jf).T
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for fn in (trav_k.traverse_forest_cuda, ops.traverse_forest):
        assert torch.equal(fn(_as(forest, ref, _t), _t(codes),
                              missing_bin=NB - 1), got)
    # per-class code blocks: class k reads its own (n, C) columns
    per_class = np.stack([_codes(n, C, NB, seed=n + k) for k in range(K)])
    got = trav_k.traverse_forest_cuda(_as(forest, ref, _t), _t(per_class),
                                      missing_bin=NB - 1)
    want = jax.vmap(lambda t, c: jax_ref.traverse_ref(t, c, NB - 1))(
        jf, jnp.asarray(per_class)).T
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n_fields", [6, 20])
def test_predict_forest_matches_jax(n_fields):
    """Step ⑤ of one multi-class round through the dataset: F = 6 walks
    the row-major codes, F = 20 > 2^3 - 1 the per-class renumbered
    columns."""
    K, depth, NB, n = 4, 3, 32, 900
    forest = _random_forest(K, depth, n_fields, NB, seed=n_fields)
    codes = _codes(n, n_fields, NB, seed=1)
    jdata = jax_binning.dataset_from_codes(codes, None, NB, packed=False)
    tdata = binning.dataset_from_codes(codes, None, NB, device="cpu")
    got = gbdt._predict_forest(_as(forest, ref, _t), tdata, None)
    want = jax_gbdt._predict_forest(_as(forest, jax_ref, jnp.asarray), jdata,
                                    JAX_REFERENCE.resolved())
    assert got.shape == (n, K)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    one = gbdt._predict_one_tree(_as({k: v[1] for k, v in forest.items()},
                                     ref, _t), tdata, None)
    assert torch.equal(one, got[:, 1])


@pytest.mark.parametrize("dyadic", [True, False])
@pytest.mark.parametrize("n,T,K,depth,F,NB", [(513, 9, 3, 3, 6, 16),
                                              (700, 28, 7, 6, 54, 256)])
def test_multiclass_ensemble_matches_jax(n, T, K, depth, F, NB, dyadic):
    trees = _random_forest(T, depth, F, NB, seed=T, dyadic=dyadic)
    trees["feature"][1] = -1                       # a pass-through tree
    codes = _codes(n, F, NB, seed=T + n)
    got = trav_k.predict_ensemble_plain(_as(trees, ref, _t), _t(codes),
                                        NB - 1, n_classes=K)
    assert got.shape == (n, K)
    jt = _as(trees, jax_ref, jnp.asarray)
    want_ref = jax_ref.predict_ensemble_batched(jt, jnp.asarray(codes),
                                                NB - 1, n_classes=K)
    # trees_per_block 4 divides neither T nor K: blocks straddle classes
    want_pallas = jax_trav.predict_ensemble_pallas(
        jt, jnp.asarray(codes), missing_bin=NB - 1, depth=depth,
        interpret=True, n_classes=K, trees_per_block=4)
    for want in (want_ref, want_pallas):
        if dyadic:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)
    # column k sums the trees t with t % K == k, one tree at a time
    for k in range(K):
        col = sum(ref.traverse_ref(_as({a: v[t] for a, v in trees.items()},
                                       ref, _t), _t(codes), NB - 1)
                  for t in range(k, T, K))
        torch.testing.assert_close(got[:, k], col, rtol=1e-5, atol=1e-5)
    for out in (ops.predict_ensemble(_as(trees, ref, _t), _t(codes),
                                     missing_bin=NB - 1, depth=depth,
                                     n_classes=K),
                trav_k.predict_ensemble_cuda(_as(trees, ref, _t), _t(codes),
                                             missing_bin=NB - 1,
                                             n_classes=K)):
        assert torch.equal(out, got)


# -- steps ② and ①–④ --------------------------------------------------------
def test_decide_level_folds_classes_into_nodes_like_jax():
    """``find_best_splits`` takes the K·NN nodes folded into its node axis;
    the class-batched step ② matches ``repro``'s, resolved leaves
    included."""
    K, nn, F, NB, depth, level = 3, 2, 5, 16, 3, 1
    rng = np.random.default_rng(0)
    codes = rng.integers(0, NB, (600, F)).astype(np.uint8)
    g, h, nid = _class_stats(K, 600, nn, seed=5, dyadic=False)
    hist = np.array(jax_ops.build_histogram(
        *[jnp.asarray(a) for a in (codes, g, h, nid)], n_nodes=nn, n_bins=NB,
        plan=JaxPlan(hist_strategy="scatter")))
    n_int, n_leaf = 2 ** depth - 1, 2 ** depth
    value_set = np.zeros((K, n_leaf), bool)
    value_set[1, 4:] = True                        # class 1, node 1 settled
    state = (np.full((K, n_int), -1, np.int32), np.zeros((K, n_int), np.int32),
             np.zeros((K, n_int), np.int32), np.zeros((K, n_int), np.int32),
             rng.normal(size=(K, n_leaf)).astype(np.float32), value_set)
    is_cat = np.array([0, 1, 0, 0, 1], bool)
    mask = np.ones(F, bool)
    kw = dict(lambda_=1.0, gamma=0.0, min_child_weight=1.0)
    got_state, got_best, got_split = tree.decide_level(
        _t(hist), level, depth, tuple(_t(a.copy()) for a in state),
        _t(is_cat), _t(mask), **kw)
    want_state, want_best, want_split = jax_tree._decide_level(
        jnp.asarray(hist), level, depth, tuple(jnp.asarray(a) for a in state),
        jnp.asarray(is_cat), jnp.asarray(mask), find=jax_splits.find_best_splits,
        **kw)
    np.testing.assert_array_equal(got_split.numpy(), np.asarray(want_split))
    assert got_best.feature.shape == (K, nn)
    for field in ("feature", "threshold", "is_cat", "default_left"):
        np.testing.assert_array_equal(getattr(got_best, field).numpy(),
                                      np.asarray(getattr(want_best, field)))
    for a, b in zip(got_state[:4] + got_state[5:],
                    want_state[:4] + want_state[5:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(got_state[4].numpy(),
                               np.asarray(want_state[4]), rtol=1e-5)


@pytest.mark.parametrize("K,depth,F", [(3, 3, 6), (4, 2, 11)])
def test_fit_forest_matches_jax(K, depth, F):
    X, _, cats = make_tabular(2000, F - 2, 2, n_cats=5, missing_rate=0.05,
                              seed=K)
    jb = jax_binning.Binner(32, cats).fit(X)
    codes = jb.transform_codes(X)
    g, h, _ = _class_stats(K, len(X), 1, seed=K, dyadic=False)
    h = np.abs(h) + 0.5
    is_cat, mask = np.asarray(jb._is_cat), np.ones(F, bool)
    kw = dict(depth=depth, n_bins=32, missing_bin=31, lambda_=1.0,
              gamma=0.0, min_child_weight=1.0)
    want = jax_tree.fit_forest(jnp.asarray(codes), jnp.asarray(codes.T.copy()),
                               jnp.asarray(g), jnp.asarray(h),
                               is_cat_field=jnp.asarray(is_cat),
                               field_mask=jnp.asarray(mask),
                               plan=JAX_REFERENCE, **kw)
    got = tree.fit_forest(_t(codes), _t(codes.T), _t(g), _t(h),
                          is_cat_field=_t(is_cat), field_mask=_t(mask), **kw)
    assert got.feature.shape == (K, 2 ** depth - 1)
    for field in ("feature", "threshold", "is_cat", "default_left"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)))
    np.testing.assert_allclose(got.leaf_value.numpy(),
                               np.asarray(want.leaf_value), rtol=1e-5,
                               atol=1e-6)
    # the classes grow independently: class k is fit_tree on (g[k], h[k])
    for k in range(K):
        one = tree.fit_tree(_t(codes), _t(codes.T), _t(g[k]), _t(h[k]),
                            is_cat_field=_t(is_cat), field_mask=_t(mask),
                            **kw)
        for a, b in zip(one, got):
            assert torch.equal(a, b[k])


# -- the multi-class fit as a whole -------------------------------------------
MULTI_CASES = {
    # F = 6 <= 2^3 - 1: step ⑤ walks the row-major codes
    "narrow": dict(n=1500, n_num=4, n_cat=2, K=3, seed=1, n_bins=32, depth=3,
                   rounds=4, early=None),
    # F = 12 > 2^3 - 1: the renumbered per-class column fetch; categorical
    # fields (the is_cat split branch) and early stopping
    "wide": dict(n=2000, n_num=4, n_cat=8, K=4, seed=2, n_bins=64, depth=3,
                 rounds=6, early=2),
}


def _multi_fixture(c):
    # 3 categories, not 2: a 2-category field offers two mirror splits,
    # (== 0, missing right) and (== 1, missing left), whose gains tie in
    # real arithmetic, and an ulp of g picks the winner (ROADMAP Queue 3)
    X, y, cats = make_tabular(c["n"], c["n_num"], c["n_cat"], n_cats=3,
                              task="multiclass", n_classes=c["K"],
                              missing_rate=0.05, seed=c["seed"])
    codes = jax_binning.Binner(c["n_bins"], cats).fit(X).transform_codes(X)
    is_cat = np.isin(np.arange(X.shape[1]), cats)
    return codes, is_cat, y


def _both(codes, is_cat, n_bins):
    return (jax_binning.dataset_from_codes(codes, jnp.asarray(is_cat), n_bins,
                                           packed=False),
            binning.dataset_from_codes(codes, is_cat, n_bins, device="cpu"))


@pytest.mark.parametrize("case", sorted(MULTI_CASES))
def test_multiclass_train_and_predict_match_jax(case):
    c = MULTI_CASES[case]
    codes, is_cat, y = _multi_fixture(c)
    n_tr = c["n"] * 4 // 5
    (jtr, ttr), (jev, tev) = (_both(codes[:n_tr], is_cat, c["n_bins"]),
                              _both(codes[n_tr:], is_cat, c["n_bins"]))
    kw = dict(n_trees=c["rounds"], max_depth=c["depth"], learning_rate=0.5,
              objective="multi:softmax", n_classes=c["K"],
              early_stopping_rounds=c["early"])
    theirs = jax_gbdt.train(jax_gbdt.GBDTConfig(**kw), jtr, y[:n_tr],
                            eval_set=(jev, y[n_tr:]), plan=JAX_REFERENCE)
    ours = gbdt.train(gbdt.GBDTConfig(**kw), ttr, y[:n_tr],
                      eval_set=(tev, y[n_tr:]), device="cpu")
    m, j = ours.model, theirs.model
    assert (m.n_classes, m.n_rounds, m.n_trees) == \
        (j.n_classes, j.n_rounds, j.n_trees)
    for field in ("feature", "threshold", "is_cat", "default_left"):
        np.testing.assert_array_equal(getattr(m.trees, field).numpy(),
                                      np.asarray(getattr(j.trees, field)),
                                      err_msg=field)
    assert bool((m.trees.is_cat == 1).any())     # categorical splits taken
    _close(m.trees.leaf_value.numpy(), j.trees.leaf_value)
    assert m.base_margin.shape == (c["K"],)
    _base_margin_close(m.base_margin, j.base_margin, y[:n_tr], c["K"])
    for key in ("train_loss", "eval_loss"):
        np.testing.assert_allclose(ours.history[key], theirs.history[key],
                                   rtol=1e-5)
    for data_t, data_j in ((ttr, jtr), (tev, jev)):
        got = m.predict_margin(data_t)
        assert got.shape == (data_t.n_records, c["K"])
        _close(got.numpy(), j.predict_margin(data_j))
        prob = m.predict(data_t)
        _close(prob.numpy(), j.predict(data_j))
        torch.testing.assert_close(prob.sum(dim=1),
                                   torch.ones(data_t.n_records))
    # prediction replays the margins the fit accumulated
    _close(m.predict_margin(ttr).numpy(), ours.margins.numpy())
    if c["early"] is not None:
        assert len(ours.history["eval_loss"]) == len(
            theirs.history["eval_loss"])


def test_multiclass_learns_and_round_trips_both_ways():
    codes, is_cat, y = _multi_fixture(MULTI_CASES["wide"])
    jdata, tdata = _both(codes, is_cat, 64)
    kw = dict(n_trees=3, max_depth=3, learning_rate=0.5,
              objective="multi:softmax", n_classes=4)
    theirs = jax_gbdt.train(jax_gbdt.GBDTConfig(**kw), jdata, y,
                            plan=JAX_REFERENCE).model
    # repro -> repro_torch
    model = gbdt.GBDTModel.from_state(theirs.to_state(), device="cpu")
    assert model.n_classes == 4 and model.n_rounds == 3
    assert model.base_margin.dtype == np.float32
    _close(model.predict_margin(tdata).numpy(), theirs.predict_margin(jdata))
    # repro_torch -> repro
    ours = gbdt.train(gbdt.GBDTConfig(**kw), tdata, y, device="cpu").model
    back = jax_gbdt.GBDTModel.from_state(ours.to_state())
    assert back.meta() == ours.meta()
    assert back.n_classes == 4 and back.n_rounds == 3
    np.testing.assert_array_equal(np.asarray(back.trees.feature),
                                  ours.trees.feature.numpy())
    _close(np.asarray(back.predict_margin(jdata)),
           ours.predict_margin(tdata).numpy())
    again = gbdt.GBDTModel.from_state(ours.to_state(), device="cpu")
    assert torch.equal(again.predict_margin(tdata), ours.predict_margin(tdata))
    # learning: the argmax beats the majority class
    acc = float((ours.predict(tdata).argmax(dim=1).numpy() == y).mean())
    assert acc > np.bincount(y.astype(int)).max() / len(y)


def test_forests_stack_round_major():
    forests = [ref.TreeArrays(*[torch.arange(3)[:, None] * 10 + r
                                for _ in range(5)]) for r in range(2)]
    stacked = gbdt._stack_forests(forests)
    assert stacked.feature[:, 0].tolist() == [0, 10, 20, 1, 11, 21]
    back = gbdt._unstack_forests(stacked, 2, 3)
    assert all(torch.equal(a, b) for f, g in zip(back, forests)
               for a, b in zip(f, g))


@pytest.mark.parametrize("labels,eval_labels", [
    ([0, 1, 3], None), ([0, 1, -1], None), ([0, 1.5, 2], None),
    ([0, 1, 2], [0, 3, 1])])
def test_multiclass_label_validation_matches_jax(labels, eval_labels):
    codes = np.zeros((3, 2), np.uint8)
    jdata, tdata = _both(codes, np.zeros(2, bool), 8)
    kw = dict(n_trees=1, max_depth=1, objective="multi:softmax", n_classes=3)
    ev = None if eval_labels is None else np.asarray(eval_labels, np.float32)
    with pytest.raises(ValueError, match="labels must be integers") as a:
        jax_gbdt.train(jax_gbdt.GBDTConfig(**kw), jdata,
                       np.asarray(labels, np.float32),
                       eval_set=None if ev is None else (jdata, ev),
                       plan=JAX_REFERENCE)
    with pytest.raises(ValueError, match="labels must be integers") as b:
        gbdt.train(gbdt.GBDTConfig(**kw), tdata,
                   np.asarray(labels, np.float32),
                   eval_set=None if ev is None else (tdata, ev), device="cpu")
    assert str(a.value) == str(b.value)


@pytest.mark.parametrize("kw", [
    dict(objective="multi:softmax"), dict(objective="multi:softmax",
                                          n_classes=1),
    dict(n_classes=3), dict(objective="binary:logistic", n_classes=2),
    dict(objective="multi:softmax", n_classes=3, grow_policy="lossguide")])
def test_multiclass_config_validation_matches_jax(kw):
    with pytest.raises(ValueError) as a:
        jax_gbdt.GBDTConfig(**kw)
    with pytest.raises(ValueError) as b:
        gbdt.GBDTConfig(**kw)
    assert str(a.value) == str(b.value)


def test_multiclass_subsample_shares_one_record_mask():
    codes, is_cat, y = _multi_fixture(MULTI_CASES["narrow"])
    _, data = _both(codes, is_cat, 32)
    cfg = gbdt.GBDTConfig(n_trees=1, max_depth=2, objective="multi:softmax",
                          n_classes=3, subsample=0.5, seed=3)
    g = torch.ones((len(y), 3))
    gen = gbdt._round_generator(cfg, 0, torch.device("cpu"))
    gm, hm, _ = gbdt._round_stats(cfg, gen, g, g, len(y), 6, 3)
    assert torch.equal(gm[:, 0], gm[:, 1]) and torch.equal(gm, hm)
    assert 0 < float(gm[:, 0].mean()) < 1
    a = gbdt.train(cfg, data, y, device="cpu")
    b = gbdt.train(cfg, data, y, device="cpu")
    assert a.history == b.history

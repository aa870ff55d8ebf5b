"""The port's binning, losses, split finding and grower against the JAX
package on the same numpy inputs.

Codes and tree structure are bit-equal; loss statistics match to rtol
1e-6; split gains and leaves to rtol 1e-5 (float32 sums in another order).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.api import ExecutionPlan as JaxPlan
from repro.core import binning as jax_binning
from repro.core import losses as jax_losses
from repro.core import splits as jax_splits
from repro.core import tree as jax_tree
from repro.data import make_tabular as jax_make_tabular
from repro.kernels import ref as jax_ref

from repro_torch.core import binning, losses, splits, tree
from repro_torch.data import make_tabular, paper_dataset
from repro_torch.kernels import ref

JAX_REFERENCE = JaxPlan(hist_strategy="scatter",
                        partition_strategy="reference",
                        traversal_strategy="reference")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def mixed():
    """Numeric fields with NaNs plus categoricals (one never seen)."""
    X, y, cats = make_tabular(1500, 6, 3, n_cats=7, missing_rate=0.1, seed=4)
    X[:, 1] = np.nan                               # an all-missing column
    return X, cats


def test_synthetic_copy_matches_jax():
    for seed in (0, 3):
        a = make_tabular(500, 5, 2, n_cats=6, task="binary",
                         missing_rate=0.05, seed=seed)
        b = jax_make_tabular(500, 5, 2, n_cats=6, task="binary",
                             missing_rate=0.05, seed=seed)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2] == b[2]
    X, y, cats, spec = paper_dataset("higgs", n_override=100)
    assert X.shape == (100, 28) and spec.task == "binary" and not cats


@pytest.mark.parametrize("max_bins", [256, 32])
def test_binner_host_codes_bit_equal(mixed, max_bins):
    X, cats = mixed
    ours = binning.Binner(max_bins, cats).fit(X)
    theirs = jax_binning.Binner(max_bins, cats).fit(X)
    np.testing.assert_array_equal(ours._edges, theirs._edges)
    np.testing.assert_array_equal(ours._is_cat, theirs._is_cat)
    np.testing.assert_array_equal(ours.transform_codes(X),
                                  theirs.transform_codes(X))


def test_binner_device_codes_bit_equal_to_jax(mixed):
    X, cats = mixed
    ours = binning.Binner(256, cats).fit(X)
    theirs = jax_binning.Binner(256, cats).fit(X)
    Xf = X.astype(np.float32)
    got = ours.transform_codes_device(Xf, device="cpu")
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(theirs.transform_codes_device(Xf)))


def test_binner_host_and_device_codes_bit_equal():
    """On data whose quantile edges are exact in float32 the host (float64)
    and device (float32) searches agree bit for bit."""
    rng = np.random.default_rng(0)
    n = 16 * 40 + 1                    # quantile positions land on integers
    X = np.stack([rng.permutation(n) for _ in range(4)], 1).astype(np.float64)
    X[:, 3] = rng.integers(0, 5, n)    # categorical
    X[rng.uniform(size=X.shape) < 0.1] = np.nan
    b = binning.Binner(17, [3]).fit(X)
    np.testing.assert_array_equal(
        b.transform_codes(X), b.transform_codes_device(X, device="cpu").numpy())


def test_binner_from_jax_arrays(mixed):
    X, cats = mixed
    theirs = jax_binning.Binner(64, cats).fit(X)
    ours = binning.Binner.from_arrays(64, theirs._edges, theirs._is_cat,
                                      theirs._n_value_bins)
    assert ours.categorical_fields == frozenset(cats)
    np.testing.assert_array_equal(ours.transform_codes(X),
                                  theirs.transform_codes(X))


def test_transform_builds_dual_layout(mixed):
    X, cats = mixed
    b = binning.Binner(256, cats).fit(X)
    data = b.transform(X, device="cpu")
    assert data.codes.dtype == torch.uint8 and data.n_bins == 256
    assert torch.equal(data.codes_cm, data.codes.T)
    assert data.codes_cm.is_contiguous()
    np.testing.assert_array_equal(data.codes.numpy(), b.transform_codes(X))
    assert data.missing_bin == 255 and data.n_fields == X.shape[1]
    np.testing.assert_array_equal(data.is_categorical.numpy(), b._is_cat)
    d2 = binning.dataset_from_codes(data.codes.numpy(), device="cpu")
    assert torch.equal(d2.codes_cm, data.codes_cm)
    assert d2.to("cpu") is d2
    d3 = binning.bin_dataset(X, 256, cats, device="cpu")
    assert torch.equal(d3.codes, data.codes)


def test_packed_codes_refused(mixed):
    """Packing is refused above 16 bins, as ``repro`` refuses it; at 17
    bins and more auto keeps plain uint8 codes."""
    X, cats = mixed
    b = binning.Binner(17, cats).fit(X)
    with pytest.raises(ValueError, match="packed codes need n_bins <= 16"):
        b.transform(X, packed=True, device="cpu")
    with pytest.raises(ValueError, match="packed codes need n_bins <= 16"):
        binning.dataset_from_codes(np.zeros((4, 2)), n_bins=17, packed=True,
                                   device="cpu")
    data = b.transform(X, device="cpu")
    assert data.codes.dtype == torch.uint8
    assert not isinstance(data.codes_cm, binning.PackedCodes)


@pytest.mark.parametrize("packed", [None, True])
def test_sixteen_bins_auto_pack(mixed, packed):
    """At 16 bins both copies are 4-bit PackedCodes, the codes of the
    uint8 layout bit for bit."""
    X, cats = mixed
    b = binning.Binner(16, cats).fit(X)
    data = b.transform(X, packed=packed, device="cpu")
    plain = b.transform(X, packed=False, device="cpu")
    assert isinstance(data.codes, binning.PackedCodes)
    assert isinstance(data.codes_cm, binning.PackedCodes)
    assert data.codes.data.shape == (X.shape[0], (X.shape[1] + 1) // 2)
    assert data.codes_cm.data.shape == (X.shape[1], (X.shape[0] + 1) // 2)
    assert torch.equal(data.codes.unpack(), plain.codes)
    assert torch.equal(data.codes_cm.unpack(), plain.codes_cm)
    assert (data.n_records, data.n_fields) == X.shape
    np.testing.assert_array_equal(data.codes.unpack().numpy(),
                                  b.transform_codes(X))


def test_transform_without_cuda_raises(mixed):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    X, cats = mixed
    b = binning.Binner(256, cats).fit(X)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        b.transform(X)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        b.transform_codes_device(X)


@pytest.mark.parametrize("name", ["reg:squarederror", "binary:logistic",
                                  "reg:huber"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(1)
    margin = (rng.normal(size=1001) * 3).astype(np.float32)
    margin[:3] = [40.0, -40.0, 0.0]            # saturated logistic hessians
    y = (rng.uniform(size=1001) < 0.4).astype(np.float32) \
        if name == "binary:logistic" else rng.normal(size=1001).astype(
            np.float32)
    ours, theirs = losses.get_loss(name), jax_losses.get_loss(name)
    m, yt = _t(margin), _t(y)
    jm, jy = jnp.asarray(margin), jnp.asarray(y)
    for a, b in zip(ours.grad_hess(m, yt), theirs.grad_hess(jm, jy)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_allclose(ours.value(m, yt).numpy(),
                               np.asarray(theirs.value(jm, jy)), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(float(ours.base_margin(yt)),
                               float(theirs.base_margin(jy)), rtol=1e-6)
    np.testing.assert_allclose(ours.transform(m).numpy(),
                               np.asarray(theirs.transform(jm)), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(
        float(ours.base_margin(yt[:1000])),
        float(theirs.base_margin(jy[:1000])), rtol=1e-6)   # even size


def test_loss_registry():
    assert set(losses.LOSSES) == set(jax_losses.LOSSES)
    soft = losses.get_loss("multi:softmax", 3)
    assert soft.name == "multi:softmax" and soft.n_outputs == 3
    assert jax_losses.get_loss("multi:softmax", 3).n_outputs == 3
    for bad in (None, 1):
        with pytest.raises(ValueError):
            jax_losses.get_loss("multi:softmax", bad)
        with pytest.raises(ValueError):
            losses.get_loss("multi:softmax", bad)
    with pytest.raises(KeyError):
        losses.get_loss("rank:pairwise")


def _level_hist(seed, n=3000, F=7, NB=32, NN=4):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, NB, (n, F)).astype(np.uint8)
    codes[:, 2] = NB - 1
    g = rng.normal(size=n).astype(np.float32)
    h = rng.uniform(0.2, 1.0, n).astype(np.float32)
    nid = rng.integers(0, NN, n).astype(np.int32)
    return np.array(jax_ref.histogram_ref(
        jnp.asarray(codes), jnp.asarray(g), jnp.asarray(h), jnp.asarray(nid),
        NN, NB))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_find_best_splits_matches_jax(seed):
    hist = _level_hist(seed)
    F = hist.shape[1]
    is_cat = np.zeros(F, bool)
    is_cat[[1, 4]] = True
    mask = np.ones(F, bool)
    mask[5] = seed == 0
    got = splits.find_best_splits(_t(hist), _t(is_cat), _t(mask), 1.0, 0.0,
                                  1.0)
    want = jax_splits.find_best_splits(jnp.asarray(hist), jnp.asarray(is_cat),
                                       jnp.asarray(mask), 1.0, 0.0, 1.0)
    for field in ("feature", "threshold", "is_cat", "default_left"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)))
    for field in ("gain", "node_g", "node_h", "left_h"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   rtol=1e-5, atol=1e-5)


def test_find_best_splits_refuses_everything_when_constrained():
    hist = _level_hist(3)
    F = hist.shape[1]
    got = splits.find_best_splits(_t(hist), torch.zeros(F, dtype=torch.bool),
                                  torch.ones(F, dtype=torch.bool), 1.0, 0.0,
                                  1e9)
    assert torch.all(got.gain == -1.0) and torch.all(got.feature == 0)


@pytest.mark.parametrize("depth,F", [(3, 5), (4, 12)])
def test_fit_tree_matches_jax(depth, F):
    X, y, cats = make_tabular(2500, F - 2, 2, n_cats=5, missing_rate=0.05,
                              seed=depth)
    jb = jax_binning.Binner(64, cats).fit(X)
    codes = jb.transform_codes(X)
    rng = np.random.default_rng(depth)
    g = rng.normal(size=len(y)).astype(np.float32)
    h = rng.uniform(0.5, 1.0, len(y)).astype(np.float32)
    is_cat, mask = np.asarray(jb._is_cat), np.ones(F, bool)
    kw = dict(depth=depth, n_bins=64, missing_bin=63, lambda_=1.0,
              gamma=0.0, min_child_weight=1.0)
    want = jax_tree.fit_tree(jnp.asarray(codes), jnp.asarray(codes.T.copy()),
                             jnp.asarray(g), jnp.asarray(h),
                             is_cat_field=jnp.asarray(is_cat),
                             field_mask=jnp.asarray(mask), plan=JAX_REFERENCE,
                             **kw)
    got = tree.fit_tree(_t(codes), _t(codes.T), _t(g), _t(h),
                        is_cat_field=_t(is_cat), field_mask=_t(mask), **kw)
    assert isinstance(got, ref.TreeArrays) and got.depth == depth
    for field in ("feature", "threshold", "is_cat", "default_left"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)))
    np.testing.assert_allclose(got.leaf_value.numpy(),
                               np.asarray(want.leaf_value), rtol=1e-5,
                               atol=1e-6)

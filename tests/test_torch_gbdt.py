"""The slice as a whole: ``repro_torch.core.gbdt.train`` + predict against
``repro.core.gbdt.train`` on the same ``dataset_from_codes`` data, and a
model carried across from the JAX package.

Tree structure is identical; leaves, the train-loss history and margins
match to rtol 1e-5 (float32 sums taken in another order).  Subsampling is
off in the parity fits: JAX's threefry streams cannot be reproduced.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.api import ExecutionPlan as JaxPlan
from repro.core import binning as jax_binning
from repro.core import gbdt as jax_gbdt

from repro_torch.api.plan import ExecutionPlan
from repro_torch.core import binning, gbdt
from repro_torch.data import make_tabular

JAX_REFERENCE = JaxPlan(hist_strategy="scatter",
                        partition_strategy="reference",
                        traversal_strategy="reference")


def _fixture(n, n_num, n_cat, task, seed, n_bins):
    X, y, cats = make_tabular(n, n_num, n_cat, n_cats=6, task=task,
                              missing_rate=0.05, seed=seed)
    codes = jax_binning.Binner(n_bins, cats).fit(X).transform_codes(X)
    is_cat = np.isin(np.arange(X.shape[1]), cats)
    return codes, is_cat, y


def _both(codes, is_cat, n_bins):
    return (jax_binning.dataset_from_codes(codes, jnp.asarray(is_cat), n_bins,
                                           packed=False),
            binning.dataset_from_codes(codes, is_cat, n_bins, device="cpu"))


def _assert_same_model(ours, theirs):
    for field in ("feature", "threshold", "is_cat", "default_left"):
        np.testing.assert_array_equal(
            getattr(ours.trees, field).numpy(),
            np.asarray(getattr(theirs.trees, field)), err_msg=field)
    # rtol 1e-5, plus atol 1e-5 of the largest leaf: XLA's CPU log and
    # sigmoid differ from torch's in the last ulp, and a leaf's G = Σg
    # cancels (Σ|g| >> |G|), which lifts those ulps to ~3e-5 of a small
    # leaf (ROADMAP Queue 3)
    want = np.asarray(theirs.trees.leaf_value)
    np.testing.assert_allclose(ours.trees.leaf_value.numpy(), want,
                               rtol=1e-5, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(ours.base_margin, theirs.base_margin,
                               rtol=1e-6)


SLICE_CASES = {
    # F = 8 <= 2^4 - 1: step ⑤ walks the row-major codes
    "squared": dict(n=3000, n_num=6, n_cat=2, task="regression", seed=1,
                    n_bins=64, objective="reg:squarederror", depth=4,
                    trees=5),
    "logistic": dict(n=4096, n_num=10, n_cat=0, task="binary", seed=2,
                     n_bins=256, objective="binary:logistic", depth=3,
                     trees=5),
    # F = 16 > 2^3 - 1: step ⑤ takes the renumbered-column fetch
    "wide": dict(n=2500, n_num=13, n_cat=3, task="binary", seed=3,
                 n_bins=32, objective="binary:logistic", depth=3, trees=4),
}


@pytest.mark.parametrize("case", sorted(SLICE_CASES))
def test_train_and_predict_match_jax(case):
    c = SLICE_CASES[case]
    codes, is_cat, y = _fixture(c["n"], c["n_num"], c["n_cat"], c["task"],
                                c["seed"], c["n_bins"])
    n_tr = c["n"] * 4 // 5
    (jtr, ttr), (jev, tev) = (_both(codes[:n_tr], is_cat, c["n_bins"]),
                              _both(codes[n_tr:], is_cat, c["n_bins"]))
    kw = dict(n_trees=c["trees"], max_depth=c["depth"], learning_rate=0.3,
              objective=c["objective"])
    theirs = jax_gbdt.train(jax_gbdt.GBDTConfig(**kw), jtr, y[:n_tr],
                            eval_set=(jev, y[n_tr:]), plan=JAX_REFERENCE)
    ours = gbdt.train(gbdt.GBDTConfig(**kw), ttr, y[:n_tr],
                      eval_set=(tev, y[n_tr:]), device="cpu")
    _assert_same_model(ours.model, theirs.model)
    for key in ("train_loss", "eval_loss"):
        np.testing.assert_allclose(ours.history[key], theirs.history[key],
                                   rtol=1e-5)
    for data_t, data_j in ((ttr, jtr), (tev, jev)):
        np.testing.assert_allclose(
            ours.model.predict_margin(data_t).numpy(),
            np.asarray(theirs.model.predict_margin(data_j)),
            rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ours.model.predict(tev).numpy(),
                               np.asarray(theirs.model.predict(jev)),
                               rtol=1e-5, atol=1e-6)
    # prediction replays the margins the fit accumulated
    np.testing.assert_allclose(ours.model.predict_margin(ttr).numpy(),
                               ours.margins.numpy(), rtol=1e-5, atol=1e-6)
    assert ours.model.n_trees == c["trees"]


def test_early_stopping_matches_jax():
    codes, is_cat, y = _fixture(2000, 6, 0, "regression", 5, 32)
    y = y + np.random.default_rng(0).normal(scale=3.0, size=len(y))
    (jtr, ttr), (jev, tev) = _both(codes[:1000], is_cat, 32), \
        _both(codes[1000:], is_cat, 32)
    kw = dict(n_trees=40, max_depth=4, learning_rate=0.8,
              early_stopping_rounds=2)
    theirs = jax_gbdt.train(jax_gbdt.GBDTConfig(**kw), jtr, y[:1000],
                            eval_set=(jev, y[1000:]), plan=JAX_REFERENCE)
    ours = gbdt.train(gbdt.GBDTConfig(**kw), ttr, y[:1000],
                      eval_set=(tev, y[1000:]), device="cpu")
    assert theirs.model.n_trees < 40
    assert ours.model.n_trees == theirs.model.n_trees
    np.testing.assert_allclose(ours.history["eval_loss"],
                               theirs.history["eval_loss"], rtol=1e-5)


def test_model_carried_across_from_jax():
    X, y, cats = make_tabular(3000, 20, 2, n_cats=5, task="binary",
                              missing_rate=0.05, seed=8)
    jb = jax_binning.Binner(128, cats).fit(X)
    jdata = jb.transform(X, packed=False)
    theirs = jax_gbdt.train(
        jax_gbdt.GBDTConfig(n_trees=6, max_depth=5, learning_rate=0.3,
                            objective="binary:logistic"),
        jdata, y, plan=JAX_REFERENCE).model
    model = gbdt.GBDTModel.from_state(theirs.to_state(), device="cpu")
    tb = binning.Binner.from_arrays(128, jb._edges, jb._is_cat,
                                    jb._n_value_bins)
    tdata = tb.transform(X, device="cpu")
    np.testing.assert_array_equal(tdata.codes.numpy(), np.asarray(jdata.codes))
    np.testing.assert_allclose(model.predict_margin(tdata).numpy(),
                               np.asarray(theirs.predict_margin(jdata)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(model.predict(tdata.codes).numpy(),
                               np.asarray(theirs.predict(jdata)),
                               rtol=1e-5, atol=1e-6)
    # and back: the port's state loads in the JAX package unchanged
    back = jax_gbdt.GBDTModel.from_state(model.to_state())
    np.testing.assert_array_equal(np.asarray(back.trees.feature),
                                  np.asarray(theirs.trees.feature))
    assert back.meta() == theirs.meta()


def test_reference_plan_gives_same_fit():
    codes, is_cat, y = _fixture(1200, 5, 1, "regression", 9, 16)
    _, data = _both(codes, is_cat, 16)
    cfg = gbdt.GBDTConfig(n_trees=3, max_depth=3)
    a = gbdt.train(cfg, data, y, device="cpu")
    b = gbdt.train(cfg, data, y, device="cpu",
                   plan=ExecutionPlan(hist_strategy="reference",
                                      partition_strategy="reference",
                                      traversal_strategy="reference"))
    for x, z in zip(a.model.trees, b.model.trees):
        assert torch.equal(x, z)
    assert a.history == b.history


def test_sampling_is_seeded_and_learns():
    X, y, cats = make_tabular(2000, 8, 0, task="binary", seed=4)
    data = binning.Binner(32).fit(X).transform(X, device="cpu")
    cfg = gbdt.GBDTConfig(n_trees=6, max_depth=3, learning_rate=0.5,
                          objective="binary:logistic", subsample=0.7,
                          colsample_bytree=0.5, seed=11)
    a = gbdt.train(cfg, data, y, device="cpu")
    b = gbdt.train(cfg, data, y, device="cpu")
    assert a.history == b.history
    loss = a.history["train_loss"]
    assert loss[-1] < loss[0]
    acc = float(((a.model.predict(data) > 0.5).numpy() == y).mean())
    assert acc > max(y.mean(), 1 - y.mean())


def test_state_round_trip():
    codes, is_cat, y = _fixture(800, 4, 0, "regression", 2, 16)
    _, data = _both(codes, is_cat, 16)
    model = gbdt.train(gbdt.GBDTConfig(n_trees=2, max_depth=2), data, y,
                       device="cpu").model
    again = gbdt.GBDTModel.from_state(model.to_state(), device="cpu")
    assert torch.equal(again.predict_margin(data), model.predict_margin(data))


@pytest.mark.parametrize("kw", [
    dict(fused_rounds=True), dict(grow_policy="lossguide"),
    dict(goss_top_rate=0.2, goss_other_rate=0.1),
    # multi-class is ported; an unported option beside it still raises
    dict(objective="multi:softmax", n_classes=3, fused_rounds=True)])
def test_unported_options_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gbdt.GBDTConfig(**kw)


def test_unported_entry_options_raise():
    codes, is_cat, y = _fixture(200, 3, 0, "regression", 1, 8)
    _, data = _both(codes, is_cat, 8)
    model = gbdt.train(gbdt.GBDTConfig(n_trees=1, max_depth=2), data, y,
                       device="cpu").model
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gbdt.train(gbdt.GBDTConfig(n_trees=1), data, y, init_model=model,
                   device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model.predict_margin(data, mode="cached")
    with pytest.raises(ValueError):
        model.predict_margin(data, mode="batched")


def test_train_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    codes, is_cat, y = _fixture(100, 3, 0, "regression", 1, 8)
    _, data = _both(codes, is_cat, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gbdt.train(gbdt.GBDTConfig(n_trees=1, max_depth=2), data, y)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        binning.dataset_from_codes(codes)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gbdt.GBDTModel.from_state({"trees": {}, "meta": {}})

"""The port's serving-path modules against the JAX package, on the CPU.

``repro_torch.core.inference`` (buckets, ``pad_trees``,
``feature_importance``, the cached engine and its trace counter),
``repro_torch.api.serialize`` (bundles that cross-load both ways),
``repro_torch.distributed.checkpoint`` (fallback past a corrupt step,
``keep_last``), the warm start of ``core.gbdt.train`` and the estimators.
Identical numpy inputs go to ``repro`` (CPU, ``scatter``/``reference``
plans) and to the port (CPU, plain versions).  Trees cross-load bit-equal;
predictions of the two packages agree to rtol 1e-5 (float32 sums taken in
another order); within the port, cached, direct, warm-started and
resumed margins are bit-equal.  Subsample, colsample and GOSS are off:
JAX's threefry streams cannot be reproduced.
"""
import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.api import ExecutionPlan as JaxPlan
from repro.api import estimator as jax_est
from repro.api import serialize as jax_ser
from repro.core import gbdt as jax_gbdt
from repro.core import inference as jax_inf
from repro.kernels.ref import TreeArrays as JaxTrees

from repro_torch.api import estimator as est_mod
from repro_torch.api import serialize
from repro_torch.core import binning, gbdt, inference
from repro_torch.data import make_tabular
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.kernels.ref import TreeArrays
from repro_torch.resilience import GracefulShutdown, RecoveryPolicy

JAX_REFERENCE = JaxPlan(hist_strategy="scatter",
                        partition_strategy="reference",
                        traversal_strategy="reference")
N_BINS, F = 16, 6


def _forest(rng, T, depth, n_cols=F):
    """Stacked random (T, ...) numpy trees with pass-through nodes."""
    n_int = 2 ** depth - 1
    feat = rng.integers(0, n_cols, (T, n_int)).astype(np.int32)
    feat[rng.uniform(size=feat.shape) < 0.2] = -1
    return dict(feature=feat,
                threshold=rng.integers(0, N_BINS - 1,
                                       (T, n_int)).astype(np.int32),
                is_cat=rng.integers(0, 2, (T, n_int)).astype(np.int32),
                default_left=rng.integers(0, 2, (T, n_int)).astype(np.int32),
                leaf_value=rng.normal(size=(T, 2 ** depth)).astype(
                    np.float32))


def _models(rng, T=12, depth=3, K=1):
    """The same random ensemble as a port model and a ``repro`` model."""
    trees = _forest(rng, T * K, depth)
    base = (0.25 if K == 1 else rng.normal(size=K).astype(np.float32))
    kw = dict(base_margin=base, missing_bin=N_BINS - 1, n_fields=F,
              max_depth=depth, n_classes=K,
              objective="multi:softmax" if K > 1 else "reg:squarederror")
    ours = gbdt.GBDTModel(trees=TreeArrays(**{k: torch.from_numpy(v)
                                              for k, v in trees.items()}),
                          **kw)
    theirs = jax_gbdt.GBDTModel(trees=JaxTrees(**{k: jnp.asarray(v)
                                                  for k, v in trees.items()}),
                                **kw)
    return ours, theirs


def _codes(rng, n, n_cols=F):
    codes = rng.integers(0, N_BINS, (n, n_cols)).astype(np.uint8)
    codes[rng.uniform(size=codes.shape) < 0.1] = N_BINS - 1
    return codes


def _assert_same_trees(ours, theirs):
    for field in TreeArrays._fields:
        np.testing.assert_array_equal(
            getattr(ours.trees, field).cpu().numpy(),
            np.asarray(getattr(theirs.trees, field)), err_msg=field)
    assert ours.meta() == theirs.meta()


# --------------------------------------------------------------------------
# buckets, padding, importances
# --------------------------------------------------------------------------
def test_buckets_match_jax():
    for x in range(1, 70_001):
        assert inference.bucket_pow2(x, inference.ROW_BUCKET_FLOOR) == \
            jax_inf.bucket_pow2(x, jax_inf.ROW_BUCKET_FLOOR)
        assert inference.bucket_trees(x) == jax_inf.bucket_trees(x), x
    assert inference.ROW_BUCKET_FLOOR == jax_inf.ROW_BUCKET_FLOOR
    assert inference.bucket_pow2(0) == jax_inf.bucket_pow2(0) == 1


@pytest.mark.parametrize("T,multiple", [(12, 16), (13, 8), (16, 16),
                                        (5, 104)])
def test_pad_trees_matches_jax(T, multiple):
    ours, theirs = _models(np.random.default_rng(T), T=T)
    _assert_same_trees(inference.pad_trees(ours, multiple),
                       jax_inf.pad_trees(theirs, multiple))


@pytest.mark.parametrize("kind", ["split", "gain", "cover"])
def test_feature_importance_matches_jax(kind):
    ours, theirs = _models(np.random.default_rng(3), T=20, depth=4)
    np.testing.assert_allclose(inference.feature_importance(ours, kind),
                               jax_inf.feature_importance(theirs, kind),
                               rtol=0, atol=1e-12)


# --------------------------------------------------------------------------
# the cached engine
# --------------------------------------------------------------------------
@pytest.mark.parametrize("K", [1, 3])
def test_cached_margins_bit_equal_to_direct(K):
    rng = np.random.default_rng(13 + K)
    ours, theirs = _models(rng, T=5, K=K)
    codes = _codes(rng, 203)
    cache = inference.PredictCache()
    cached = ours.predict_margin(torch.from_numpy(codes), mode="cached",
                                 cache=cache)
    direct = ours.predict_margin(torch.from_numpy(codes))
    assert cached.shape == direct.shape == ((203,) if K == 1 else (203, K))
    assert torch.equal(cached, direct)
    # a padded bucket (5*K trees -> bucket_trees) and padded rows (256)
    assert cache.stats()["traces"] == 1 and cache.stats()["replays"] == 1
    np.testing.assert_allclose(
        cached.numpy(),
        np.asarray(theirs.predict_margin(jnp.asarray(codes),
                                         plan=JAX_REFERENCE)),
        rtol=1e-5, atol=1e-6)


def test_trace_counter_matches_jax_call_by_call():
    """One sequence of batch sizes and model versions (tree counts 12, 11,
    99, 100, 104, 105): the port counts a trace exactly where ``repro``'s
    jit compiles."""
    rng = np.random.default_rng(7)
    versions = {T: _models(rng, T=T) for T in (12, 11, 99, 100, 104, 105)}
    ours_cache, jax_cache = inference.PredictCache(), jax_inf.PredictCache()
    plan = JaxPlan(traversal_strategy="reference")
    calls = [(12, 5), (12, 128), (12, 129), (11, 64), (12, 300),
             (99, 64), (100, 100), (104, 1000), (105, 1000), (12, 7)]
    for T, n in calls:
        ours, theirs = versions[T]
        codes = _codes(rng, n)
        got = inference.predict_margin_cached(ours, torch.from_numpy(codes),
                                              cache=ours_cache)
        want = jax_inf.predict_margin_cached(theirs, jnp.asarray(codes),
                                             plan=plan, cache=jax_cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
        mine, ref = ours_cache.stats(), jax_cache.stats()
        assert mine["traces"] == ref["traces"], (T, n)
        assert {k: mine[k] for k in ref} == ref
    assert ours_cache.stats()["replays"] == len(calls)


def test_cached_engine_refuses_trees_past_the_row():
    rng = np.random.default_rng(8)
    ours, _ = _models(rng, T=4)
    with pytest.raises(ValueError, match="splits on field"):
        inference.predict_margin_cached(
            ours, torch.from_numpy(_codes(rng, 50, n_cols=3)),
            cache=inference.PredictCache())


def test_device_binning_matches_host():
    rng = np.random.default_rng(21)
    X = rng.normal(size=(500, 8)).astype(np.float32).astype(np.float64)
    X[:, 6] = rng.integers(0, 5, 500)
    X[rng.uniform(size=X.shape) < 0.05] = np.nan
    binner = binning.Binner(32, [6]).fit(X)
    host = binner.transform_codes(X)
    for _ in range(2):          # the second call reuses the device tables
        got = binner.transform_codes_device(X, device="cpu")
        np.testing.assert_array_equal(got.numpy(), host)


# --------------------------------------------------------------------------
# fits shared by the bundle, warm-start and estimator tests
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def binary():
    X, y, cats = make_tabular(2500, 8, 2, n_cats=5, task="binary",
                              missing_rate=0.05, seed=11)
    return X.astype(np.float32).astype(np.float64), y, cats


@pytest.fixture(scope="module")
def fitted_pair(binary):
    """The same classifier fitted by both packages."""
    X, y, cats = binary
    kw = dict(n_trees=4, max_depth=3, learning_rate=0.3, max_bins=32,
              categorical_fields=cats, seed=3)
    ours = est_mod.BoosterClassifier(device="cpu", **kw).fit(X, y)
    theirs = jax_est.BoosterClassifier(plan=JAX_REFERENCE, **kw).fit(X, y)
    return ours, theirs


def test_estimator_fit_matches_jax(binary, fitted_pair):
    X, y, _ = binary
    ours, theirs = fitted_pair
    _assert_same_trees_loose(ours.model_, theirs.model_)
    np.testing.assert_allclose(
        ours.predict_proba(X),
        theirs.predict_proba(X, plan=JAX_REFERENCE), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ours.history_["train_loss"],
                               theirs.history_["train_loss"], rtol=1e-5)


def _assert_same_trees_loose(ours, theirs):
    """Structure bit-equal, leaves to rtol 1e-5 (+1e-5 of the largest:
    XLA's CPU log/sigmoid differ from torch's in the last ulp)."""
    for field in ("feature", "threshold", "is_cat", "default_left"):
        np.testing.assert_array_equal(
            getattr(ours.trees, field).numpy(),
            np.asarray(getattr(theirs.trees, field)), err_msg=field)
    want = np.asarray(theirs.trees.leaf_value)
    np.testing.assert_allclose(ours.trees.leaf_value.numpy(), want,
                               rtol=1e-5, atol=1e-5 * np.abs(want).max())


def _artifact(kind, est):
    return {"model": lambda: est.model_, "pipeline": est.to_pipeline,
            "estimator": lambda: est}[kind]()


def _model_of(obj):
    return getattr(obj, "model_", None) or getattr(obj, "model", None) \
        or obj


@pytest.mark.parametrize("kind", ["model", "pipeline", "estimator"])
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_bundles_cross_load(binary, fitted_pair, tmp_path, kind, direction):
    X, _, _ = binary
    ours, theirs = fitted_pair
    path = str(tmp_path / "bundle")
    if direction == "port_to_jax":
        serialize.save(path, _artifact(kind, ours))
        loaded_ours, loaded_theirs = (_artifact(kind, ours),
                                      jax_ser.load(path))
    else:
        jax_ser.save(path, _artifact(kind, theirs))
        loaded_ours, loaded_theirs = (serialize.load(path, device="cpu"),
                                      _artifact(kind, theirs))
    assert type(loaded_ours).__name__ == type(loaded_theirs).__name__
    _assert_same_trees(_model_of(loaded_ours), _model_of(loaded_theirs))
    if kind == "model":
        codes = loaded_ours.trees.feature.new_tensor(
            ours.binner_.transform_codes(X), dtype=torch.uint8)
        got = loaded_ours.predict_margin(codes).numpy()
        want = np.asarray(loaded_theirs.predict_margin(
            jnp.asarray(codes.numpy()), plan=JAX_REFERENCE))
    else:
        got = loaded_ours.predict(X, plan=None).numpy() \
            if kind == "pipeline" else loaded_ours.predict_proba(X)
        want = np.asarray(loaded_theirs.predict(X, plan=JAX_REFERENCE)) \
            if kind == "pipeline" else \
            loaded_theirs.predict_proba(X, plan=JAX_REFERENCE)
        np.testing.assert_array_equal(loaded_ours.binner._edges
                                      if kind == "pipeline"
                                      else loaded_ours.binner_._edges,
                                      loaded_theirs.binner._edges
                                      if kind == "pipeline"
                                      else loaded_theirs.binner_._edges)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if kind == "estimator":
        assert {k: v for k, v in loaded_ours.get_params().items()
                if k not in serialize.RUNTIME_PARAMS} == \
            {k: v for k, v in loaded_theirs.get_params().items()
             if k != "plan"}


def test_bundle_leaves_runtime_choices_out(fitted_pair, tmp_path):
    ours, _ = fitted_pair
    path = str(tmp_path / "bundle")
    ours.save(path)
    with open(os.path.join(path, "manifest.json")) as f:
        params = json.load(f)["meta"]["estimator"]["params"]
    assert "device" not in params and "plan" not in params
    assert set(params) == set(jax_est._PARAM_DEFAULTS) - {"plan"}


def test_corrupt_bundle_rejected(fitted_pair, tmp_path):
    ours, _ = fitted_pair
    path = str(tmp_path / "bundle")
    ours.save(path)
    with open(os.path.join(path, "arrays.npz"), "r+b") as f:
        f.seek(30)
        f.write(b"\xde\xad")
    with pytest.raises(FileNotFoundError):
        serialize.load(path, device="cpu")


# --------------------------------------------------------------------------
# named checkpoints
# --------------------------------------------------------------------------
def test_corrupt_step_falls_back_to_the_previous_one(tmp_path):
    d = str(tmp_path / "ckpt")
    for step in (1, 2, 3):
        ckpt.save_named(d, {"a": np.full(4, step), "b/c": np.arange(step)},
                        step, extra_meta={"step": step})
    with open(os.path.join(d, "step_3", "arrays.npz"), "r+b") as f:
        f.seek(40)
        f.write(b"\x00\xff\x00")
    arrays, step, meta = ckpt.restore_named(d)
    assert step == 2 and meta == {"step": 2}
    np.testing.assert_array_equal(arrays["a"], np.full(4, 2))
    # a partial write (no manifest) is skipped the same way
    os.makedirs(os.path.join(d, "step_9"))
    assert ckpt.restore_named(d)[1] == 2
    # the JAX package reads the same layout
    from repro.distributed import checkpoint as jax_ckpt
    assert jax_ckpt.restore_named(d)[1] == 2
    with pytest.raises(FileNotFoundError):
        ckpt.restore_named(str(tmp_path / "empty"))


def test_keep_last_collects_old_steps(tmp_path):
    d = str(tmp_path / "ckpt")
    for step in range(1, 6):
        ckpt.save_named(d, {"x": np.zeros(2)}, step, keep_last=2)
    assert ckpt.list_steps(d) == [4, 5]
    assert not os.path.exists(os.path.join(d, "step_5.tmp"))


# --------------------------------------------------------------------------
# warm start and checkpoint resume
# --------------------------------------------------------------------------
@pytest.mark.parametrize("objective,K", [("binary:logistic", None),
                                         ("multi:softmax", 3)])
def test_warm_start_bit_equal_to_one_go_fit(objective, K):
    X, y, cats = make_tabular(2000, 6, 2, n_cats=5,
                              task="binary" if K is None else "multiclass",
                              n_classes=K or 2, missing_rate=0.05, seed=4)
    data = binning.Binner(32, cats).fit(X).transform(X, device="cpu")

    def fit(n_trees, init=None):
        cfg = gbdt.GBDTConfig(n_trees=n_trees, max_depth=3,
                              learning_rate=0.3, objective=objective,
                              n_classes=K)
        return gbdt.train(cfg, data, y, init_model=init, device="cpu")

    one = fit(16)
    first = fit(8)
    cont = fit(8, first.model)
    for field in TreeArrays._fields:
        assert torch.equal(getattr(cont.model.trees, field),
                           getattr(one.model.trees, field)), field
    assert cont.history["train_loss"] == one.history["train_loss"][8:]
    assert torch.equal(cont.margins, one.margins)
    # the replayed margins are the direct predict's, bit for bit
    replayed = gbdt._replay_margins(first.model, data,
                                    gbdt.resolve_plan(None))
    assert torch.equal(replayed, first.model.predict_margin(data))
    assert torch.equal(replayed, first.margins)


def test_warm_start_refuses_a_mismatched_model():
    X, y, _ = make_tabular(600, 4, 0, task="binary", seed=1)
    data = binning.Binner(16).fit(X).transform(X, device="cpu")
    first = gbdt.train(gbdt.GBDTConfig(n_trees=2, max_depth=2,
                                       objective="binary:logistic"),
                       data, y, device="cpu")
    with pytest.raises(ValueError, match="max_depth"):
        gbdt.train(gbdt.GBDTConfig(n_trees=2, max_depth=3,
                                   objective="binary:logistic"), data, y,
                   init_model=first.model, device="cpu")


def test_checkpoint_resume_bit_equal_to_one_go_fit(binary, tmp_path):
    X, y, cats = binary
    kw = dict(n_trees=6, max_depth=3, learning_rate=0.3, max_bins=32,
              categorical_fields=cats, device="cpu")
    one = est_mod.BoosterClassifier(**kw).fit(X, y)
    d = str(tmp_path / "ckpt")
    est_mod.BoosterClassifier(**dict(kw, n_trees=4)).fit(
        X, y, checkpoint_dir=d, checkpoint_every=2)
    assert ckpt.list_steps(d) == [2, 4]
    obj, step = serialize.load_checkpoint(d, device="cpu")
    assert step == 4 and isinstance(obj, est_mod.BoosterClassifier)
    # a newest step torn on disk: resume falls back to step 2
    with open(os.path.join(d, "step_4", "arrays.npz"), "r+b") as f:
        f.seek(50)
        f.write(b"\x13\x37")
    resumed = est_mod.BoosterClassifier(**kw).fit(X, y, checkpoint_dir=d,
                                                  checkpoint_every=2)
    assert resumed.n_trees_ == 6
    for field in TreeArrays._fields:
        assert torch.equal(getattr(resumed.model_.trees, field),
                           getattr(one.model_.trees, field)), field
    np.testing.assert_array_equal(resumed.predict_proba(X),
                                  one.predict_proba(X))


def test_xgb_model_bundle_path_of_the_jax_package(binary, fitted_pair,
                                                  tmp_path):
    """A ``repro`` bundle path warm-starts the port's estimator."""
    X, y, cats = binary
    _, theirs = fitted_pair
    path = str(tmp_path / "jax_bundle")
    theirs.save(path)
    cont = est_mod.BoosterClassifier(
        n_trees=2, max_depth=3, learning_rate=0.3, max_bins=32,
        categorical_fields=cats, device="cpu").fit(X, y, xgb_model=path)
    assert cont.n_trees_ == theirs.n_trees_ + 2
    np.testing.assert_array_equal(cont.model_.trees.feature[:4].numpy(),
                                  np.asarray(theirs.model_.trees.feature))


# --------------------------------------------------------------------------
# the estimators
# --------------------------------------------------------------------------
def test_get_set_params_roundtrip():
    est = est_mod.BoosterRegressor(n_trees=9, learning_rate=0.05,
                                   categorical_fields=[3, 1])
    params = est.get_params()
    assert params["n_trees"] == 9 and params["categorical_fields"] == (3, 1)
    assert set(params) == set(jax_est._PARAM_DEFAULTS) | {"device"}
    est.set_params(n_trees=4, max_depth=3, device="cpu")
    assert est.n_trees == 4 and est.max_depth == 3
    with pytest.raises(ValueError):
        est.set_params(bogus_param=1)
    with pytest.raises(TypeError):
        est_mod.BoosterRegressor(bogus_param=1)
    assert "n_trees=4" in repr(est)


@pytest.mark.parametrize("case", ["nan_label", "inf_label", "lengths",
                                  "empty", "not_2d", "eval_set"])
def test_fit_validates_inputs(case):
    X = np.random.default_rng(0).normal(size=(40, 3))
    y = np.zeros(40)
    kw = {}
    if case == "nan_label":
        y = y.copy()
        y[5] = np.nan
    elif case == "inf_label":
        y = y.copy()
        y[7] = np.inf
    elif case == "lengths":
        y = y[:30]
    elif case == "empty":
        X, y = X[:0], y[:0]
    elif case == "not_2d":
        X = X[:, 0]
    else:
        kw["eval_set"] = (X[:10], np.full(9, 0.0))
    with pytest.raises(ValueError):
        est_mod.BoosterRegressor(n_trees=1, device="cpu").fit(X, y, **kw)


@pytest.mark.parametrize("kw", [dict(data=object()), dict(mesh=object()),
                                dict(recovery=RecoveryPolicy()),
                                dict(shutdown=GracefulShutdown())])
def test_unported_fit_options_raise(kw):
    """``mesh=`` is ported and refuses what is no ``Mesh``
    (``tests/test_torch_distributed.py`` fits on one); ``data=`` is ported
    and, as ``repro``'s, refuses what is no data source; ``recovery=`` and
    ``shutdown=`` are ported and fit."""
    X = np.random.default_rng(0).normal(size=(64, 2))
    y = X[:, 0].copy()
    est = est_mod.BoosterRegressor(n_trees=2, max_depth=2, device="cpu")
    if "data" in kw:
        with pytest.raises(TypeError, match="DataSource"):
            est.fit(**kw)
        return
    if "mesh" in kw:
        with pytest.raises(TypeError, match="Mesh"):
            est.fit(X, y, **kw)
        return
    est.fit(X, y, **kw)
    assert est.n_trees_ == 2 and not est.stats_.get("interrupted")
    loss = est.history_["train_loss"]
    assert loss[-1] < loss[0]


@pytest.mark.parametrize("params", [dict(max_leaves=8),
                                    dict(goss_top_rate=0.2,
                                         goss_other_rate=0.1),
                                    dict(fused_rounds=True)])
def test_unported_params_raise_at_fit(params):
    """The lossguide grower's ``max_leaves``, GOSS and fused rounds are
    ported: each reaches ``train`` and fits."""
    X = np.random.default_rng(1).normal(size=(200, 3))
    y = X[:, 0] - X[:, 1]
    grow = dict(grow_policy="lossguide") if "max_leaves" in params else {}
    est = est_mod.BoosterRegressor(n_trees=3, max_depth=4, device="cpu",
                                   **params, **grow)
    gbdt.round_step_cache_clear()
    est.fit(X, y)
    assert est.n_trees_ == 3
    loss = est.history_["train_loss"]
    assert loss[-1] < loss[0]
    if "max_leaves" in params:
        splits = (est.model_.trees.feature >= 0).sum(dim=1)
        assert int(splits.max()) <= params["max_leaves"] - 1
    if "fused_rounds" in params:
        assert est.stats_["fused_rounds"] and est.stats_["graph_replays"] == 2


def test_unfitted_raises():
    est = est_mod.BoosterClassifier(device="cpu")
    for call in (lambda: est.predict(np.zeros((3, 2))),
                 lambda: est.predict_proba(np.zeros((3, 2))),
                 lambda: est.save("unused"),
                 lambda: est.feature_importances_):
        with pytest.raises(est_mod.NotFittedError):
            call()


def test_staged_predict_and_proba(binary, fitted_pair):
    X, y, _ = binary
    ours, theirs = fitted_pair
    stages = list(ours.staged_predict(X))
    assert len(stages) == ours.n_trees_
    proba = ours.predict_proba(X)
    np.testing.assert_allclose(proba.sum(axis=1), 1.0, rtol=1e-6)
    # the last stage sums in the engine's order: equal to predict
    np.testing.assert_array_equal(stages[-1].numpy(), proba[:, 1])
    for ours_k, theirs_k in zip(stages, theirs.staged_predict(
            X, plan=JAX_REFERENCE)):
        np.testing.assert_allclose(ours_k.numpy(), np.asarray(theirs_k),
                                   rtol=1e-5, atol=1e-6)
    assert set(np.unique(ours.predict(X))) <= {0, 1}


def test_multiclass_classifier_matches_jax():
    X, y, cats = make_tabular(1500, 5, 1, n_cats=3, task="multiclass",
                              n_classes=3, missing_rate=0.05, seed=6)
    kw = dict(n_trees=3, max_depth=3, learning_rate=0.3, max_bins=32,
              categorical_fields=cats)
    ours = est_mod.BoosterClassifier(device="cpu", **kw).fit(X, y)
    theirs = jax_est.BoosterClassifier(plan=JAX_REFERENCE, **kw).fit(X, y)
    assert ours.model_.n_classes == theirs.model_.n_classes == 3
    proba = ours.predict_proba(X)
    assert proba.shape == (1500, 3)
    np.testing.assert_allclose(proba.sum(axis=1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(proba, theirs.predict_proba(
        X, plan=JAX_REFERENCE), rtol=1e-5, atol=1e-5)
    assert np.array_equal(ours.predict(X), proba.argmax(axis=1))
    stages = list(ours.staged_predict(X))
    assert len(stages) == 3 and stages[-1].shape == (1500, 3)


def test_entry_points_default_to_cuda(fitted_pair, tmp_path):
    """Without CUDA, loading or fitting on the default device raises
    instead of quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    ours, _ = fitted_pair
    path = str(tmp_path / "bundle")
    ours.save(path)
    with pytest.raises(RuntimeError, match="CUDA"):
        serialize.load(path)
    with pytest.raises(RuntimeError, match="CUDA"):
        est_mod.BoosterRegressor(n_trees=1).fit(np.zeros((8, 2)),
                                                np.zeros(8))

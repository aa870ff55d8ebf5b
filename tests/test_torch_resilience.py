"""The port's resilience layer against the JAX package, on the CPU.

``repro_torch.resilience`` keeps its own copies of ``repro``'s
``RecoveryPolicy``/``classify``, ``GracefulShutdown`` and ``metrics``;
they are held field for field against ``repro``'s.  Then ``repro``'s
divergence and shutdown cases (its ``tests/test_chaos.py``), run against
the port's estimator on the host loop and on fused rounds: the typed
divergence error, the fused rollback budget, the silent legacy path, a
shutdown after a committed round that resumes bit-equal, a real SIGTERM,
and a one-off divergence that the fused loop rolls back and replays
bit-equal.
"""
import dataclasses
import os
import signal

import numpy as np
import pytest
import torch

from repro.resilience import errors as jax_errors
from repro.resilience import recovery as jax_recovery
from repro.resilience import shutdown as jax_shutdown

from repro_torch.api.estimator import BoosterRegressor
from repro_torch.core import gbdt
from repro_torch.resilience import (DeviceOOMError, GracefulShutdown,
                                    NumericalDivergenceError, Preemption,
                                    RecoveryPolicy, TrainingInterrupted,
                                    TransientIOError, classify, metrics)


def _xy(n=32, f=3):
    rng = np.random.default_rng(0)
    return (rng.normal(size=(n, f)).astype(np.float32),
            rng.normal(size=n).astype(np.float32))


def _est(**kw):
    return BoosterRegressor(device="cpu", **kw)


def _assert_same_trees(a, b):
    for field, u, v in zip(a.trees._fields, a.trees, b.trees):
        assert torch.equal(u, v), field


def test_policy_and_shutdown_mirror_jax():
    ours = {f.name: f.default for f in dataclasses.fields(RecoveryPolicy)}
    theirs = {f.name: f.default
              for f in dataclasses.fields(jax_recovery.RecoveryPolicy)}
    assert ours == theirs
    for bad in (dict(checkpoint_every=0), dict(max_recoveries=-1),
                dict(min_chunk_rows=0), dict(max_divergence_rollbacks=-1),
                dict(divergence_backoff=1.0)):
        with pytest.raises(ValueError):
            RecoveryPolicy(**bad)
        with pytest.raises(ValueError):
            jax_recovery.RecoveryPolicy(**bad)
    assert [m for m in dir(GracefulShutdown) if not m.startswith("__")] \
        == [m for m in dir(jax_shutdown.GracefulShutdown)
            if not m.startswith("__")]


@pytest.mark.parametrize("exc_type,kind", [
    ("NumericalDivergenceError", "divergence"),
    ("DeviceOOMError", "oom"), ("TransientIOError", "transient"),
    ("Preemption", "transient"), ("ValueError", "fatal")])
def test_classify_matches_jax(exc_type, kind):
    ours = {"NumericalDivergenceError": NumericalDivergenceError,
            "DeviceOOMError": DeviceOOMError,
            "TransientIOError": TransientIOError, "Preemption": Preemption,
            "ValueError": ValueError}[exc_type]("x")
    theirs = getattr(jax_errors, exc_type, ValueError)("x")
    assert classify(ours) == jax_recovery.classify(theirs) == kind


def test_metrics_snapshot_and_delta():
    before = metrics.snapshot()
    metrics.record("recoveries", 2)
    assert metrics.delta(before) == {"recoveries": 2}


@pytest.mark.parametrize("fused", [False, True])
def test_recovery_accepted_on_every_fit_path(fused):
    X, y = _xy(64)
    est = _est(n_trees=2, max_depth=2, fused_rounds=fused).fit(
        X, y, recovery=RecoveryPolicy())
    assert est.n_trees_ == 2


def test_divergence_sentinel_raises_typed():
    """An absurd learning rate overflows squared-error margins to inf in
    the first round; with a policy armed the host loop raises the typed
    error with the round index."""
    X, y = _xy(64)
    with pytest.raises(NumericalDivergenceError) as ei:
        _est(n_trees=3, max_depth=2, learning_rate=1e20).fit(
            X, y, recovery=RecoveryPolicy(max_divergence_rollbacks=0))
    assert ei.value.round_index >= 0


def test_divergence_fused_rollback_budget_exhausts():
    """The fused loop rolls back and halves the learning rate; a config
    that keeps diverging exhausts ``max_divergence_rollbacks`` and the
    typed error propagates."""
    X, y = _xy(64)
    before = metrics.snapshot()
    with pytest.raises(NumericalDivergenceError):
        _est(n_trees=4, max_depth=2, learning_rate=1e30,
             fused_rounds=True, log_every=1).fit(
            X, y, recovery=RecoveryPolicy(max_divergence_rollbacks=2))
    assert metrics.delta(before).get("recoveries") == 2


def test_divergence_without_recovery_is_legacy_silent():
    """No policy: the host loop keeps the legacy behaviour (a NaN-loss
    model, the caller's problem); the fused loop's sentinel fails fast
    with the typed error, as ``repro``'s does."""
    X, y = _xy(64)
    est = _est(n_trees=2, max_depth=2, learning_rate=1e20).fit(X, y)
    assert not np.isfinite(est.history_["train_loss"][-1])
    with pytest.raises(NumericalDivergenceError):
        _est(n_trees=2, max_depth=2, learning_rate=1e20,
             fused_rounds=True).fit(X, y)


def _glitch(monkeypatch, rounds):
    """Make the ``rounds``-th calls (0-based) of the round body's grower
    return NaN leaves: a one-off divergence."""
    real, calls = gbdt._grow_round, [0]

    def grow(*a, **kw):
        tree = real(*a, **kw)
        calls[0] += 1
        if calls[0] - 1 in rounds:
            tree = tree._replace(leaf_value=tree.leaf_value * float("nan"))
        return tree

    monkeypatch.setattr(gbdt, "_grow_round", grow)


def test_fused_rollback_replays_a_glitch_bit_equal(monkeypatch):
    """A one-off NaN in round 3 trips the sentinel; the fused loop rolls
    back to its last finite round and replays at the same learning rate,
    landing on the fault-free ensemble bit for bit."""
    X, y = _xy(200)
    kw = dict(n_trees=6, max_depth=3, seed=3, fused_rounds=True,
              log_every=2)
    gold = _est(**kw).fit(X, y)
    _glitch(monkeypatch, {3})
    est = _est(**kw).fit(X, y, recovery=RecoveryPolicy())
    assert est.stats_["divergence_rollbacks"] == 1
    _assert_same_trees(est.model_, gold.model_)
    assert est.history_ == gold.history_


def test_fused_rollback_backs_off_a_repeated_divergence(monkeypatch):
    """The same window diverging on its replay backs the learning rate off
    (a new step key: one more trace)."""
    X, y = _xy(200)
    gbdt.round_step_cache_clear()
    _glitch(monkeypatch, {1, 2})
    est = _est(n_trees=3, max_depth=2, fused_rounds=True, log_every=1,
               learning_rate=0.3).fit(X, y, recovery=RecoveryPolicy())
    stats = est.stats_
    assert stats["divergence_rollbacks"] == 2 and est.n_trees_ == 3
    assert stats["graph_captures"] == 2
    assert np.isfinite(est.history_["train_loss"]).all()


def test_shutdown_interrupts_host_and_fused_and_resumes_bit_equal(tmp_path):
    """``sd.request()`` after round 2 interrupts both loops after the
    commit; the partial model stays fitted state and a resume from the
    checkpoint lands on the bit-equal final ensemble."""
    X, y = _xy(256)
    for i, fused in enumerate((False, True)):
        kw = dict(n_trees=6, max_depth=3, max_bins=32, seed=3,
                  fused_rounds=fused)
        gold = _est(**kw).fit(X, y)
        ckdir = str(tmp_path / f"ck{i}")
        est = _est(**kw)
        sd = GracefulShutdown()

        def cb(t_idx, model):
            if t_idx == 2:
                sd.request("SIGTERM")

        with pytest.raises(TrainingInterrupted) as ei:
            est.fit(X, y, checkpoint_dir=ckdir, checkpoint_every=2,
                    callback=cb, shutdown=sd)
        assert ei.value.rounds_done == 3
        assert ei.value.signal_name == "SIGTERM"
        assert ei.value.checkpoint_dir == ckdir
        assert ei.value.result.stats["interrupted"]
        assert est.is_fitted and est.n_trees_ == 3   # partial model kept
        res = _est(**kw).fit(X, y, checkpoint_dir=ckdir)
        _assert_same_trees(res.model_, gold.model_)


def test_sigterm_delivers_typed_interrupt():
    """A real SIGTERM mid-fit: the round in flight finishes and the typed
    error names the signal; the handlers are restored afterwards."""
    X, y = _xy(128)
    prev = signal.getsignal(signal.SIGTERM)

    def cb(t_idx, model):
        if t_idx == 1:
            os.kill(os.getpid(), signal.SIGTERM)

    with GracefulShutdown() as sd:
        with pytest.raises(TrainingInterrupted) as ei:
            _est(n_trees=5, max_depth=2).fit(X, y, callback=cb, shutdown=sd)
    assert ei.value.signal_name == "SIGTERM" and ei.value.rounds_done == 2
    assert signal.getsignal(signal.SIGTERM) is prev

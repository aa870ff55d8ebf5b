"""Seeded chaos on the port's out-of-core path, on the CPU.

The cases of ``repro``'s ``tests/test_chaos.py`` for streaming training and
the data path, run against the port (``repro_torch.core.gbdt.
train_streaming`` on the CPU, the kernels' plain versions).  Every fault
schedule is seeded or pinned to a step, so each assertion is exact:

* a streamed fit under injected IO errors, one device OOM and one
  mid-round preemption gives the fault-free model bit for bit (chunked
  sums do not depend on the chunk size; rounds commit at once and replay
  under per-round random streams);
* a restore from a checkpoint reproduces the tree structure bit for bit
  and the leaves to float tolerance (its margins are recomputed by a
  streamed inference pass);
* corruption is loud: a flipped byte in a staged shard raises
  ``ShardCorruptionError`` and is never retried;
* a SIGTERM during a stream raises ``TrainingInterrupted`` and the fit
  resumes bit-equal.

``seeded_schedule`` is ``repro``'s: the same seed gives the same schedule
in both packages.
"""
import os
import signal

import numpy as np
import pytest
import torch

from repro.resilience import faults as jax_faults

from repro_torch.api import (ArraySource, BoosterRegressor, ExecutionPlan,
                             NpzShardSource, RecoveryPolicy, RetryingSource,
                             RetryPolicy, write_npz_shards)
from repro_torch.api import serialize
from repro_torch.core.binning import StreamingBinner
from repro_torch.core.gbdt import GBDTConfig, train_streaming
from repro_torch.data.synthetic import SyntheticSource
from repro_torch.resilience import (DeviceOOMError, FaultSchedule,
                                    FaultySource, GracefulShutdown,
                                    Preemption, ShardCorruptionError,
                                    TrainingInterrupted, TransientIOError,
                                    corrupt_file, seeded_schedule)

N, F, CHUNK = 1200, 5, 256
NO_BACKOFF = RetryPolicy(base_delay_s=0.0, max_delay_s=0.0, jitter=0.0)


def _materialize(src, n):
    xs, ys = zip(*src.chunks(n))
    return np.concatenate(xs), np.concatenate(ys)


def _fresh_source():
    return SyntheticSource(N, F, seed=7)


def _assert_trees_equal(a, b, *, leaf_rtol=None):
    """Bit-equal forests; with ``leaf_rtol`` the structure stays exact and
    the leaves compare to float tolerance."""
    for field, u, v in zip(a.trees._fields, a.trees, b.trees):
        if field == "leaf_value" and leaf_rtol is not None:
            torch.testing.assert_close(u, v, rtol=leaf_rtol, atol=1e-6)
        else:
            assert torch.equal(u, v), field


def _stream(base, source, **kw):
    return train_streaming(base["cfg"], source, base["binner"], base["y"],
                           chunk_rows=kw.pop("chunk_rows", CHUNK),
                           device="cpu", **kw)


@pytest.fixture(scope="module")
def base():
    """The fault-free fit every chaos run compares with."""
    X, y = _materialize(_fresh_source(), N)
    binner = StreamingBinner(max_bins=32, sketch_size=4096).fit(X)
    cfg = GBDTConfig(n_trees=6, max_depth=3, learning_rate=0.3,
                     objective="reg:squarederror")
    res = train_streaming(cfg, _fresh_source(), binner, y, chunk_rows=CHUNK,
                          device="cpu")
    return {"X": X, "y": y, "binner": binner, "cfg": cfg, "res": res}


# --------------------------------------------------------------------------
# streaming training under injected faults
# --------------------------------------------------------------------------
def test_seeded_io_errors_absorbed_bit_equal(base):
    """A seeded storm of transient read errors, absorbed by RetryingSource:
    the trainer never sees one and the model is bit-equal."""
    sched = seeded_schedule(123, "source", 120, rate=0.15)
    assert sched.pending() > 0
    flaky = RetryingSource(FaultySource(_fresh_source(), sched), NO_BACKOFF)
    res = _stream(base, flaky)
    assert flaky.stats["retries"] > 0
    assert all(kind == "error" for _, _, kind in sched.fired)
    assert res.stats["recoveries"] == 0
    _assert_trees_equal(res.model, base["res"].model)
    assert res.history["train_loss"] == base["res"].history["train_loss"]
    assert flaky._closed                   # closed on the way out


def test_oom_degrades_chunk_and_preserves_model(base):
    """A device OOM mid-round halves chunk_rows and retries the round; the
    chunked sums do not depend on the chunk size here, so the model is
    bit-equal."""
    sched = FaultSchedule().add("source", 7, exc=DeviceOOMError)
    res = _stream(base, FaultySource(_fresh_source(), sched),
                  recovery=RecoveryPolicy(min_chunk_rows=64))
    assert res.stats["oom_halvings"] == 1
    assert res.stats["chunk_rows"] == CHUNK // 2
    assert res.stats["n_chunks"] == -(-N // (CHUNK // 2))
    assert sched.fired == [("source", 7, "error")]
    _assert_trees_equal(res.model, base["res"].model)
    assert res.history["train_loss"] == base["res"].history["train_loss"]


@pytest.mark.parametrize("case", ["floor", "budget"])
def test_oom_exhaustion_propagates(base, case):
    """No room to degrade (min_chunk_rows == chunk_rows), or no halvings
    left in the budget: the OOM propagates instead of looping."""
    sched = FaultSchedule().add("source", 3, exc=DeviceOOMError)
    if case == "budget":
        sched.add("source", 12, exc=DeviceOOMError)
    policy = (RecoveryPolicy(min_chunk_rows=CHUNK) if case == "floor"
              else RecoveryPolicy(min_chunk_rows=16, max_oom_halvings=1))
    with pytest.raises(DeviceOOMError):
        _stream(base, FaultySource(_fresh_source(), sched), recovery=policy)


def test_midround_preemption_replays_in_memory(base):
    """No checkpoint_dir: a transient failure mid-round replays the round
    from the previous round's state in memory, bit-equal."""
    sched = FaultSchedule().add("source", 50, exc=Preemption)
    res = _stream(base, FaultySource(_fresh_source(), sched),
                  recovery=RecoveryPolicy())
    assert res.stats["recoveries"] == 1
    assert res.stats["replayed_rounds"] == 0
    _assert_trees_equal(res.model, base["res"].model)
    assert res.history["train_loss"] == base["res"].history["train_loss"]


def test_recovery_budget_exhaustion_propagates(base):
    sched = (FaultSchedule()
             .add("source", 30, exc=Preemption)
             .add("source", 45, exc=Preemption))   # fires in the replay
    with pytest.raises(Preemption):
        _stream(base, FaultySource(_fresh_source(), sched),
                recovery=RecoveryPolicy(max_recoveries=1))


def test_preemption_restores_from_checkpoint(base, tmp_path):
    """With checkpoint_dir set, a late preemption restores the newest
    checkpoint and replays only the lost rounds: structure bit-equal,
    leaves to float tolerance."""
    sched = FaultSchedule().add("source", 100, exc=Preemption)  # round 5
    res = _stream(base, FaultySource(_fresh_source(), sched),
                  recovery=RecoveryPolicy(checkpoint_dir=str(tmp_path),
                                          checkpoint_every=2))
    assert res.stats["recoveries"] == 1
    assert res.stats["replayed_rounds"] == 1   # restored round 4, lost 5
    assert res.model.n_trees == base["res"].model.n_trees
    _assert_trees_equal(res.model, base["res"].model, leaf_rtol=1e-5)
    assert serialize.has_checkpoint(str(tmp_path))


def test_combined_chaos_matches_fault_free(base):
    """Seeded IO errors, one device OOM and one mid-round preemption in
    one fit: every recovery layer fires and the model is bit-equal."""
    io_sched = seeded_schedule(5, "source", 120, rate=0.1)
    io_sched.add("source", 33, exc=DeviceOOMError)       # not retryable
    inner = RetryingSource(FaultySource(_fresh_source(), io_sched),
                           NO_BACKOFF)
    preempt = FaultSchedule().add("source", 70, exc=Preemption)
    outer = FaultySource(inner, preempt)    # above the retry wrapper: the
    res = _stream(                          # trainer handles this one
        base, outer,
        recovery=RecoveryPolicy(min_chunk_rows=64, max_recoveries=2))
    assert inner.stats["retries"] > 0
    assert res.stats["oom_halvings"] == 1
    assert res.stats["recoveries"] == 1
    assert ("source", 70, "error") in preempt.fired
    _assert_trees_equal(res.model, base["res"].model)
    assert res.history["train_loss"] == base["res"].history["train_loss"]


def test_estimator_recovery_end_to_end():
    """Through the estimator: ``fit(data=RetryingSource(...),
    recovery=...)`` under seeded faults predicts as the fault-free fit."""
    src = SyntheticSource(1500, 6, seed=9)
    X, _ = _materialize(src, 1500)
    plan = ExecutionPlan(chunk_bytes=12_000)
    kw = dict(n_trees=5, max_depth=3, learning_rate=0.3, max_bins=32,
              device="cpu")
    clean = BoosterRegressor(**kw).fit(data=src, plan=plan)
    sched = seeded_schedule(11, "source", 200, rate=0.1)
    flaky = RetryingSource(
        FaultySource(SyntheticSource(1500, 6, seed=9), sched), NO_BACKOFF)
    rec = BoosterRegressor(**kw).fit(data=flaky, plan=plan,
                                     recovery=RecoveryPolicy())
    assert flaky.stats["retries"] > 0
    assert torch.equal(clean.predict(X), rec.predict(X))


# --------------------------------------------------------------------------
# RetryingSource on its own
# --------------------------------------------------------------------------
def test_retry_budget_exhaustion_raises():
    sched = FaultSchedule()
    for step in range(3):                       # 3 consecutive failures
        sched.add("source", step, exc=TransientIOError)
    src = RetryingSource(
        FaultySource(SyntheticSource(400, 3, seed=1), sched),
        RetryPolicy(max_retries=2, base_delay_s=0.0, jitter=0.0))
    with pytest.raises(TransientIOError):
        list(src.chunks(200))
    assert src.stats["retries"] == 2


def test_corruption_is_never_retried():
    sched = FaultSchedule().add("source", 1, exc=ShardCorruptionError)
    src = RetryingSource(
        FaultySource(SyntheticSource(400, 3, seed=1), sched), NO_BACKOFF)
    with pytest.raises(ShardCorruptionError):
        list(src.chunks(200))
    assert src.stats["retries"] == 0


def test_hung_read_times_out_and_retries():
    """A latency spike past chunk_timeout_s is a (transient)
    ChunkTimeoutError: the pass re-opens and the stream stays identical;
    ``close`` joins the watchdog and is idempotent."""
    plain = np.concatenate(
        [x for x, _ in SyntheticSource(400, 3, seed=1).chunks(100)])
    sched = FaultSchedule().add("source", 0, kind="latency", delay_s=0.6)
    with RetryingSource(
            FaultySource(SyntheticSource(400, 3, seed=1), sched),
            RetryPolicy(chunk_timeout_s=0.1, base_delay_s=0.0,
                        jitter=0.0)) as src:
        got = np.concatenate([x for x, _ in src.chunks(100)])
        assert src.n_fields == 3
    assert src.stats["timeouts"] == 1 and src.stats["retries"] == 1
    np.testing.assert_array_equal(got, plain)
    src.close()


def test_retry_policy_validates_and_backs_off():
    with pytest.raises(ValueError, match="max_retries"):
        RetryPolicy(max_retries=-1)
    with pytest.raises(ValueError, match="jitter"):
        RetryPolicy(jitter=1.5)
    p = RetryPolicy(base_delay_s=0.1, max_delay_s=0.3, jitter=0.0)
    rng = np.random.default_rng(0)
    assert [p.delay_s(a, rng) for a in (1, 2, 3)] == [0.1, 0.2, 0.3]


def test_seeded_schedule_is_deterministic_and_matches_jax():
    a = seeded_schedule(42, "source", 100, rate=0.2, latency_rate=0.1)
    b = seeded_schedule(42, "source", 100, rate=0.2, latency_rate=0.1)
    assert a.pending() == b.pending() > 0
    c = seeded_schedule(43, "source", 100, rate=0.2, latency_rate=0.1)
    assert set(a._pending) != set(c._pending)
    theirs = jax_faults.seeded_schedule(42, "source", 100, rate=0.2,
                                        latency_rate=0.1)
    assert {k: [(f.kind, f.delay_s) for f in v]
            for k, v in a._pending.items()} == \
        {k: [(f.kind, f.delay_s) for f in v]
         for k, v in theirs._pending.items()}


# --------------------------------------------------------------------------
# shard corruption: crc32 manifests
# --------------------------------------------------------------------------
def test_corrupt_shard_detected_on_read_and_at_open(tmp_path):
    paths = write_npz_shards(str(tmp_path), SyntheticSource(600, 4, seed=3),
                             rows_per_shard=200)
    copy = tmp_path / "copy.bin"                 # repro flips the same bytes
    copy.write_bytes(open(paths[1], "rb").read())
    offsets = corrupt_file(paths[1], seed=0)     # mid-directory
    assert len(offsets) == 8
    assert offsets == jax_faults.corrupt_file(str(copy), seed=0)
    assert copy.read_bytes() == open(paths[1], "rb").read()
    src = NpzShardSource(str(tmp_path))          # shard 0 verifies fine
    with pytest.raises(ShardCorruptionError, match="crc32"):
        list(src.chunks(250))
    corrupt_file(paths[0], seed=1)
    with pytest.raises(ShardCorruptionError, match="crc32"):
        NpzShardSource(str(tmp_path))


def test_unmanifested_directory_still_loads(tmp_path):
    """Directories that predate checksumming load without verification."""
    write_npz_shards(str(tmp_path), SyntheticSource(300, 4, seed=3),
                     rows_per_shard=200)
    plain = np.concatenate(
        [x for x, _ in NpzShardSource(str(tmp_path)).chunks(100)])
    os.remove(tmp_path / "manifest.json")
    back = NpzShardSource(str(tmp_path))
    assert back.manifest is None
    np.testing.assert_array_equal(
        np.concatenate([x for x, _ in back.chunks(100)]), plain)


def test_foreign_shard_rejected_by_manifest(tmp_path):
    write_npz_shards(str(tmp_path), SyntheticSource(300, 4, seed=3),
                     rows_per_shard=200)
    np.savez(tmp_path / "zz_foreign.npz", X=np.zeros((4, 4), np.float32))
    with pytest.raises(ShardCorruptionError, match="manifest"):
        list(NpzShardSource(str(tmp_path)).chunks(100))
    (tmp_path / "manifest.json").write_text("{not json")
    with pytest.raises(ShardCorruptionError, match="manifest"):
        NpzShardSource(str(tmp_path))


# --------------------------------------------------------------------------
# graceful shutdown during a stream
# --------------------------------------------------------------------------
def test_streaming_sigterm_delivers_typed_interrupt(base, tmp_path):
    """A real SIGTERM mid-stream: the round in flight finishes, a
    checkpoint is committed and the typed resumable error names the
    signal."""
    sd = GracefulShutdown()

    def cb(t_idx, model):
        if t_idx == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    with sd:
        with pytest.raises(TrainingInterrupted) as ei:
            _stream(base, _fresh_source(), callback=cb, shutdown=sd,
                    recovery=RecoveryPolicy(checkpoint_dir=str(tmp_path),
                                            checkpoint_every=2))
    stop = ei.value
    assert stop.signal_name == "SIGTERM" and stop.rounds_done == 3
    assert stop.checkpoint_dir == str(tmp_path)
    assert stop.result.stats["interrupted"]
    assert serialize.has_checkpoint(str(tmp_path))


def test_streaming_sigterm_resume_bit_equal(tmp_path):
    """SIGTERM mid-fit, then a resume, equals the uninterrupted fit bit for
    bit, through the estimator."""
    src = SyntheticSource(1500, 6, seed=9)
    X, y = _materialize(src, 1500)
    plan = ExecutionPlan(chunk_bytes=12_000)
    kw = dict(n_trees=6, max_depth=3, learning_rate=0.3, max_bins=32,
              device="cpu")
    gold = BoosterRegressor(**kw).fit(data=ArraySource(X, y), plan=plan)
    ckdir = str(tmp_path / "ck")
    est = BoosterRegressor(**kw)
    sd = GracefulShutdown()

    def cb(t_idx, model):
        if t_idx == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    with sd:
        with pytest.raises(TrainingInterrupted):
            est.fit(data=ArraySource(X, y), plan=plan, checkpoint_dir=ckdir,
                    checkpoint_every=2, callback=cb,
                    recovery=RecoveryPolicy(), shutdown=sd)
    assert est.n_trees_ == 3
    res = BoosterRegressor(**kw).fit(data=ArraySource(X, y), plan=plan,
                                     checkpoint_dir=ckdir)
    _assert_trees_equal(res.model_, gold.model_)
    assert torch.equal(res.predict(X), gold.predict(X))


def test_fit_validates_streamed_labels():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(200, 3)).astype(np.float32)
    y = rng.normal(size=200).astype(np.float32)
    y[77] = np.nan
    with pytest.raises(ValueError, match="streamed labels"):
        BoosterRegressor(n_trees=1, device="cpu").fit(
            data=ArraySource(X, y), plan=ExecutionPlan(chunk_bytes=2_000))

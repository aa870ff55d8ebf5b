"""The port's serving daemon on the CPU: deadline batching, hot swap,
multi-tenancy, typed failures — the behaviours ``tests/test_serving.py``
holds ``repro``'s server to, and its answers against ``repro``'s.

* coalescing: requests queued under one deadline are served in a single
  flush, bit-equal to individual predicts (padding never changes a row);
* zero-slack requests dispatch at once; a full batch flushes early;
  oversize requests chop into segments and reassemble in order;
* warm-up covers every bucket a flush can reach: no trace after it;
* hot swap under load loses nothing and traces nothing when the shape
  buckets match; a new tree bucket is traced off the serving path;
* tenants (and separate registries) keep disjoint caches; ``unpublish``
  evicts exactly one;
* overload and failures are typed: shed, deadline, dispatcher crash and
  restart, health.

The same synthetic bundle served by ``repro``'s server gives the same
answers to rtol 1e-5 (float32 sums in another order) and the same trace
counts.
"""
import threading
import time

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.api import ExecutionPlan as JaxPlan
from repro.core.binning import Binner as JaxBinner
from repro.core.gbdt import GBDTModel as JaxModel
from repro.core.inference import GBDTPipeline as JaxPipeline
from repro.kernels.ref import TreeArrays as JaxTrees
from repro.serving import ModelRegistry as JaxRegistry
from repro.serving import Server as JaxServer

from repro_torch.api import ExecutionPlan, ModelRegistry, Server, \
    warmup_buckets
from repro_torch.core.binning import Binner
from repro_torch.core.gbdt import GBDTModel
from repro_torch.core.inference import (GBDTPipeline, PredictCache,
                                        ROW_BUCKET_FLOOR, bucket_pow2,
                                        bucket_trees)
from repro_torch.kernels.ref import TreeArrays
from repro_torch.resilience import (DeadlineExceededError,
                                    DispatcherCrashError, FaultSchedule,
                                    QueueFullError)

N_BINS = 16
MISSING = N_BINS - 1
N_FIELDS = 7
PLAN = ExecutionPlan()


def rand_forest(rng, T, depth):
    n_int, n_leaf = 2 ** depth - 1, 2 ** depth
    feat = rng.integers(0, N_FIELDS, (T, n_int)).astype(np.int32)
    feat[rng.uniform(size=feat.shape) < 0.2] = -1
    return dict(feature=feat,
                threshold=rng.integers(0, N_BINS - 1,
                                       (T, n_int)).astype(np.int32),
                is_cat=rng.integers(0, 2, (T, n_int)).astype(np.int32),
                default_left=rng.integers(0, 2, (T, n_int)).astype(np.int32),
                leaf_value=rng.normal(size=(T, n_leaf)).astype(np.float32))


def make_pipelines(seed: int, T: int = 12, depth: int = 3):
    """One synthetic binner+model bundle (no training, deterministic) as
    the port's pipeline and as ``repro``'s."""
    rng = np.random.default_rng(seed)
    X_fit = rng.normal(size=(512, N_FIELDS)).astype(np.float32)
    trees = rand_forest(rng, T, depth)
    kw = dict(base_margin=0.5, objective="reg:squarederror",
              missing_bin=MISSING, n_fields=N_FIELDS, max_depth=depth)
    ours = GBDTPipeline(
        binner=Binner(N_BINS).fit(X_fit),
        model=GBDTModel(trees=TreeArrays(**{k: torch.from_numpy(v)
                                            for k, v in trees.items()}),
                        **kw))
    theirs = JaxPipeline(
        binner=JaxBinner(N_BINS).fit(X_fit),
        model=JaxModel(trees=JaxTrees(**{k: jnp.asarray(v)
                                         for k, v in trees.items()}), **kw))
    return ours, theirs


def make_pipeline(seed: int, T: int = 12, depth: int = 3) -> GBDTPipeline:
    return make_pipelines(seed, T, depth)[0]


def make_X(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(1000 + seed)
    X = rng.normal(size=(n, N_FIELDS)).astype(np.float32)
    X[rng.random(X.shape) < 0.05] = np.nan
    return X


def direct(pipe, X):
    return pipe.predict(X, plan=PLAN, mode="direct").numpy()


@pytest.fixture
def registry():
    reg = ModelRegistry(PLAN, device="cpu")
    reg.publish("a", make_pipeline(0))
    return reg


# --------------------------------------------------------------------------
# against repro's server
# --------------------------------------------------------------------------
def test_served_answers_and_traces_match_jax():
    ours, theirs = make_pipelines(4)
    sizes = (3, 130, 513, 999, 1000)
    answers = {}
    for name, reg, server, pipe in (
            ("port", ModelRegistry(PLAN, device="cpu"), Server, ours),
            ("jax", JaxRegistry(JaxPlan(traversal_strategy="reference")),
             JaxServer, theirs)):
        reg.publish("m", pipe)
        with server(reg, max_batch=1000, default_slack_ms=0.0) as srv:
            warm = srv.warmup("m")
            reqs = [srv.submit("m", make_X(i, n))
                    for i, n in enumerate(sizes)]
            answers[name] = [np.asarray(r.result(timeout=60)) for r in reqs]
            stats = srv.stats()["m"]
        answers[name + "_traces"] = (warm, stats["traces"])
    assert answers["port_traces"] == answers["jax_traces"] == (4, 4)
    for got, want in zip(answers["port"], answers["jax"]):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------
# deadline batching
# --------------------------------------------------------------------------
def test_coalesced_flush_bit_equal_to_individual_predicts(registry):
    pipe = registry.pipeline("a")
    batches = [make_X(i, n) for i, n in enumerate((100, 37, 160, 201))]
    with Server(registry, max_batch=1024, default_slack_ms=500.0) as srv:
        srv.warmup("a")
        flushes0 = srv.stats()["a"]["flushes"]
        replays0 = registry.entry("a").cache.stats()["replays"]
        reqs = [srv.submit("a", X) for X in batches]
        outs = [r.result(timeout=60) for r in reqs]
        stats = srv.stats()["a"]
    # all four queued within the 500 ms slack of the first: ONE flush
    assert stats["flushes"] - flushes0 == 1
    assert registry.entry("a").cache.stats()["replays"] - replays0 == 1
    for X, out in zip(batches, outs):
        np.testing.assert_array_equal(out, direct(pipe, X))


def test_zero_slack_serves_immediately(registry):
    with Server(registry, max_batch=1024, default_slack_ms=0.0) as srv:
        srv.warmup("a")
        for i in range(3):
            srv.submit("a", make_X(i, 50)).result(timeout=60)
        stats = srv.stats()["a"]
    assert stats["requests"] == 3 and stats["flushes"] == 3


def test_full_batch_flushes_before_deadline(registry):
    with Server(registry, max_batch=256, default_slack_ms=3600e3) as srv:
        srv.warmup("a")
        reqs = [srv.submit("a", make_X(i, 128)) for i in range(2)]
        # an hour of slack, but 2 x 128 rows fill max_batch: flush now
        outs = [r.result(timeout=60) for r in reqs]
    assert all(o.shape == (128,) for o in outs)


def test_oversize_request_chops_and_reassembles(registry):
    pipe = registry.pipeline("a")
    X = make_X(7, 700)
    with Server(registry, max_batch=256, default_slack_ms=5.0) as srv:
        srv.warmup("a")
        out = srv.submit("a", X).result(timeout=60)
        stats = srv.stats()["a"]
    assert stats["requests"] == 1 and stats["flushes"] == 3
    np.testing.assert_array_equal(out, direct(pipe, X))


def test_warmup_covers_every_reachable_flush_bucket(registry):
    with Server(registry, max_batch=1000, default_slack_ms=200.0) as srv:
        traces = srv.warmup("a")
        buckets = warmup_buckets(1000)
        assert buckets == [128, 256, 512, 1024]
        assert traces == len(buckets)
        for rows in (1, 128, 129, 700, 1000):
            assert bucket_pow2(rows, ROW_BUCKET_FLOOR) in buckets
        t0 = srv.stats()["a"]["traces"]
        reqs = [srv.submit("a", make_X(i, n))
                for i, n in enumerate((3, 130, 513, 999, 1000))]
        for r in reqs:
            r.result(timeout=60)
        assert srv.stats()["a"]["traces"] == t0   # no trace, any mix


# --------------------------------------------------------------------------
# hot swap
# --------------------------------------------------------------------------
def test_hotswap_under_load_drops_nothing_and_never_retraces(registry):
    v2 = make_pipeline(99)        # same T/depth: same shape buckets
    assert bucket_trees(v2.model.n_trees) == bucket_trees(
        registry.pipeline("a").model.n_trees)
    with Server(registry, max_batch=512, default_slack_ms=2.0) as srv:
        srv.warmup("a")
        warm = srv.stats()["a"]["traces"]
        reqs, swapped = [], threading.Event()

        def pound():
            for i in range(40):
                reqs.append(srv.submit("a", make_X(i, 64 + i)))
                if i == 20:
                    swapped.set()
                time.sleep(0.001)

        t = threading.Thread(target=pound)
        t.start()
        swapped.wait(timeout=30)
        version = registry.publish("a", v2)     # hot swap mid-load
        t.join()
        outs = [r.result(timeout=60) for r in reqs]
        # submitted after publish() returned: served by the new version
        post = srv.submit("a", make_X(999, 77)).result(timeout=60)
        stats = srv.stats()["a"]
    assert version == 2
    assert len(outs) == 40 and stats["dropped"] == 0
    assert stats["requests"] == 41
    assert stats["traces"] == warm              # no trace across the swap
    np.testing.assert_array_equal(post, direct(v2, make_X(999, 77)))


def test_publish_warms_new_buckets_off_hot_path():
    reg = ModelRegistry(PLAN, device="cpu")
    reg.publish("a", make_pipeline(0))
    reg.warm("a", [128, 256])
    # v2 lands in another tree bucket: publish() traces the buckets served
    # so far before the swap becomes visible
    v2 = make_pipeline(5, T=40)
    assert bucket_trees(40) != bucket_trees(12)
    traces_before = reg.entry("a").cache.stats()["traces"]
    reg.publish("a", v2)
    traces_after = reg.entry("a").cache.stats()["traces"]
    assert traces_after - traces_before == 2
    out = v2.predict(make_X(1, 100), plan=PLAN, cache=reg.entry("a").cache)
    np.testing.assert_array_equal(out.numpy(), direct(v2, make_X(1, 100)))
    assert reg.entry("a").cache.stats()["traces"] == traces_after


# --------------------------------------------------------------------------
# multi-model tenancy
# --------------------------------------------------------------------------
def test_multi_model_isolation_and_eviction():
    reg = ModelRegistry(PLAN, device="cpu")
    reg.publish("a", make_pipeline(0))
    reg.publish("b", make_pipeline(1, T=20, depth=4))
    ca, cb = reg.entry("a").cache, reg.entry("b").cache
    assert ca is not cb
    reg.warm("a", [128])
    assert ca.stats()["traces"] == 1
    assert cb.stats()["traces"] == 0            # tenant b untouched
    reg.warm("b", [128])
    assert cb.stats()["traces"] == 1
    reg.unpublish("a")
    assert "a" not in reg and "b" in reg and reg.names() == ["b"]
    assert ca.stats() == {"entries": 0, "hits": 0, "misses": 0,
                          "traces": 0, "replays": 0}
    assert cb.stats()["traces"] == 1            # eviction is per tenant
    with pytest.raises(KeyError):
        reg.unpublish("a")


def test_two_registries_do_not_collide():
    r1 = ModelRegistry(PLAN, device="cpu")
    r2 = ModelRegistry(PLAN, device="cpu")
    r1.publish("m", make_pipeline(0))
    r2.publish("m", make_pipeline(1))
    r1.warm("m", [128, 256])
    assert r1.entry("m").cache.stats()["traces"] == 2
    assert r2.entry("m").cache.stats()["traces"] == 0
    X = make_X(0, 64)
    out1 = r1.pipeline("m").predict(X, plan=PLAN, cache=r1.entry("m").cache)
    out2 = r2.pipeline("m").predict(X, plan=PLAN, cache=r2.entry("m").cache)
    assert not torch.equal(out1, out2)


def test_publish_takes_bundle_paths_and_estimators(tmp_path):
    from repro_torch.api import BoosterRegressor, save

    pipe = make_pipeline(3)
    path = str(tmp_path / "bundle")
    save(path, pipe)
    rng = np.random.default_rng(2)
    X = rng.normal(size=(300, N_FIELDS))
    est = BoosterRegressor(n_trees=2, max_depth=2, max_bins=N_BINS,
                           device="cpu").fit(X, X[:, 0])
    reg = ModelRegistry(PLAN, device="cpu")
    reg.publish("path", path)
    reg.publish("est", est)
    np.testing.assert_array_equal(
        reg.pipeline("path").predict(make_X(0, 20), plan=PLAN).numpy(),
        direct(pipe, make_X(0, 20)))
    assert reg.pipeline("est").model is est.model_
    with pytest.raises(TypeError):
        reg.publish("bad", object())


def test_submit_unknown_model_raises(registry):
    with Server(registry, max_batch=256) as srv:
        with pytest.raises(KeyError):
            srv.submit("nope", make_X(0, 8))
        with pytest.raises(ValueError):
            srv.submit("a", np.zeros((0, N_FIELDS)))


# --------------------------------------------------------------------------
# stats consistency
# --------------------------------------------------------------------------
def test_stats_counters_match_request_mix(registry):
    registry.publish("b", make_pipeline(1, T=20, depth=4))
    sizes_a, sizes_b = (64, 130, 7), (100, 200)
    with Server(registry, max_batch=512, default_slack_ms=5.0) as srv:
        srv.warmup("a")
        srv.warmup("b")
        reqs = ([srv.submit("a", make_X(i, n))
                 for i, n in enumerate(sizes_a)]
                + [srv.submit("b", make_X(i, n))
                   for i, n in enumerate(sizes_b)])
        for r in reqs:
            r.result(timeout=60)
        stats = srv.stats()
    a, b = stats["a"], stats["b"]
    assert a["requests"] == len(sizes_a) and a["rows"] == sum(sizes_a)
    assert b["requests"] == len(sizes_b) and b["rows"] == sum(sizes_b)
    for s in (a, b):
        assert s["dropped"] == 0
        assert s["queue_depth"] == 0            # drained
        assert 0.0 < s["batch_fill"] <= 1.0
        assert s["p50_ms"] <= s["p99_ms"]
        assert s["qps"] > 0.0
        assert s["flushes"] <= s["requests"]
    assert a["version"] == 1 and b["version"] == 1


def test_stop_drains_pending_requests(registry):
    srv = Server(registry, max_batch=256, default_slack_ms=10_000.0)
    srv.warmup("a")
    reqs = [srv.submit("a", make_X(i, 20)) for i in range(4)]
    srv.stop()                    # long slack, but stop() must drain
    assert all(r.done() for r in reqs)
    with pytest.raises(RuntimeError):
        srv.submit("a", make_X(9, 20))


# --------------------------------------------------------------------------
# overload and failure posture
# --------------------------------------------------------------------------
def test_bounded_queue_sheds_typed_and_never_enqueues(registry):
    with Server(registry, max_batch=128, default_slack_ms=10_000.0,
                max_queue_rows=128) as srv:
        srv.warmup("a")
        keep = srv.submit("a", make_X(0, 60))       # queued: 60 < max_batch
        shed = srv.submit("a", make_X(1, 100))      # 160 > 128: shed
        assert shed.done()                          # failed at admission
        with pytest.raises(QueueFullError):
            shed.result(timeout=1)
        late = srv.submit("a", make_X(2, 30))       # 90 <= 128: admitted
        stats = srv.stats()["a"]
        assert stats["shed"] == 1
        assert stats["queue_depth"] == 90
    assert keep.result(timeout=60).shape == (60,)
    assert late.result(timeout=60).shape == (30,)


def test_queue_deadline_fails_typed(registry):
    with Server(registry, max_batch=256, default_slack_ms=10_000.0,
                timeout_ms=50.0) as srv:
        srv.warmup("a")
        req = srv.submit("a", make_X(0, 20))
        with pytest.raises(DeadlineExceededError):
            req.result(timeout=60)
        deadline = time.monotonic() + 30
        while (srv.stats()["a"]["deadline_failures"] == 0
               and time.monotonic() < deadline):
            time.sleep(0.01)
        stats = srv.stats()["a"]
    assert stats["deadline_failures"] == 1
    assert stats["queue_depth"] == 0                # popped, not leaked


def test_dispatcher_crash_restarts_and_keeps_serving(registry):
    sched = FaultSchedule()
    sched.add("dispatch", 0, kind="error",
              exc=RuntimeError, message="chaos: flush 0 dies")
    with Server(registry, max_batch=256, default_slack_ms=0.0,
                fault_injector=sched) as srv:
        srv.warmup("a")
        doomed = srv.submit("a", make_X(0, 30))
        with pytest.raises(DispatcherCrashError) as ei:
            doomed.result(timeout=60)
        assert isinstance(ei.value.__cause__, RuntimeError)
        out = srv.submit("a", make_X(1, 30)).result(timeout=60)
        health = srv.health()
        stats = srv.stats()["a"]
    assert out.shape == (30,)
    assert health.alive and health.ready
    assert health.dispatcher_restarts == 1
    assert stats["dropped"] == 1                    # the crashed flush
    assert sched.fired == [("dispatch", 0, "error")]


def test_restart_budget_exhaustion_fails_everything_typed(registry):
    sched = FaultSchedule()
    sched.add("dispatch", 0, kind="error",
              exc=RuntimeError, message="chaos: fatal flush")
    with Server(registry, max_batch=256, default_slack_ms=0.0,
                max_dispatcher_restarts=0, fault_injector=sched) as srv:
        srv.warmup("a")
        doomed = srv.submit("a", make_X(0, 30))
        with pytest.raises(DispatcherCrashError):
            doomed.result(timeout=60)
        deadline = time.monotonic() + 30
        while srv.health().alive and time.monotonic() < deadline:
            time.sleep(0.01)
        health = srv.health()
        fast = srv.submit("a", make_X(1, 10))
        assert fast.done()
        with pytest.raises(DispatcherCrashError):
            fast.result(timeout=1)
    assert not health.alive and not health.ready
    assert srv.health().failed_requests == 2        # crash + fast-fail


def test_latency_fault_delays_but_serves(registry):
    sched = FaultSchedule().add("dispatch", 0, kind="latency", delay_s=0.05)
    with Server(registry, max_batch=256, default_slack_ms=0.0,
                fault_injector=sched) as srv:
        srv.warmup("a")
        req = srv.submit("a", make_X(0, 12))
        assert req.result(timeout=60).shape == (12,)
        assert req.latency_s >= 0.05
    assert sched.fired == [("dispatch", 0, "latency")]
    assert sched.pending() == 0


def test_health_reports_clean_server(registry):
    with Server(registry, max_batch=256, default_slack_ms=0.0) as srv:
        srv.warmup("a")
        srv.submit("a", make_X(0, 16)).result(timeout=60)
        h = srv.health()
    assert h.alive and h.ready
    assert h.dispatcher_restarts == 0 and h.failed_requests == 0
    assert h.models == 1
    assert h.as_dict()["alive"] is True


def test_errors_classify_torch_oom():
    from repro_torch.resilience import (DeviceOOMError, ShardCorruptionError,
                                        TransientIOError, is_oom,
                                        is_transient)

    assert is_oom(torch.cuda.OutOfMemoryError("CUDA out of memory"))
    assert is_oom(DeviceOOMError("injected"))
    assert not is_transient(torch.cuda.OutOfMemoryError("x"))
    assert is_transient(TransientIOError("flaky"))
    assert not is_transient(ShardCorruptionError("bad bytes"))
    assert not is_oom(ValueError("shape mismatch"))


def test_predict_cache_counts_one_replay_per_request():
    pipe = make_pipeline(2)
    cache = PredictCache()
    for n in (10, 20, 300):
        pipe.predict(make_X(n, n), plan=PLAN, cache=cache)
    assert cache.stats() == {"entries": 1, "hits": 2, "misses": 1,
                             "traces": 2, "replays": 3}
    cache.clear()
    assert cache.stats()["replays"] == 0


def test_cache_holds_its_counts_under_thread_contention():
    """More threads than cores on one cache, with a short switch interval:
    every call gets its own rows, and no count is lost."""
    import os
    import sys

    pipe = make_pipeline(6)
    cache = PredictCache()
    batches = [make_X(i, 50 + 17 * i) for i in range(12)]
    want = [direct(pipe, X) for X in batches]
    n_threads, reps = (os.cpu_count() or 1) + 4, 5
    errors = []

    def work(t):
        for r in range(reps):
            i = (t + r) % len(batches)
            got = pipe.predict(batches[i], plan=PLAN, cache=cache).numpy()
            if not np.array_equal(got, want[i]):
                errors.append(i)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors
    stats = cache.stats()
    assert stats["replays"] == stats["hits"] + stats["misses"] \
        == n_threads * reps
    assert stats["entries"] == 1 and stats["traces"] == len(
        {bucket_pow2(X.shape[0], ROW_BUCKET_FLOOR) for X in batches})

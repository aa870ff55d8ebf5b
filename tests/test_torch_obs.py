"""``repro_torch.obs``: the counters and the spans, their off path, their
place in a ``torch.profiler`` timeline, and the spans of the training
round (``core/gbdt.train``, ``core/tree.fit_forest``)."""
import itertools
import sys
import threading
import tracemalloc

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import binning
from repro_torch.core import tree as tree_mod
from repro_torch.core.gbdt import GBDTConfig, train
from repro_torch.data import make_tabular
from repro_torch.resilience import metrics


@pytest.fixture
def fresh(monkeypatch):
    """Empty span rows, tracing off, restored after the test."""
    monkeypatch.setattr(obs, "_rows", {})
    monkeypatch.setattr(obs, "_enabled", False)
    return obs


def _fake_clock(monkeypatch, ticks_ms):
    ticks = iter(int(t * 1e6) for t in ticks_ms)
    monkeypatch.setattr(obs, "_clock", lambda: next(ticks))


def test_nesting_gives_count_total_and_self(fresh, monkeypatch):
    #         a [0 ......................... 20]
    #           b [1 .. 5]   b [6 ....... 12]
    #                          c [7 .. 9]
    _fake_clock(monkeypatch, [0, 1, 5, 6, 7, 9, 12, 20])
    obs.enable(True)
    with obs.span("a"):
        with obs.span("b"):
            assert obs.open_spans() == ("a", "b")
        with obs.span("b"):
            with obs.span("c"):
                pass
    assert obs.open_spans() == ()
    ms = 1_000_000
    assert obs.spans() == {
        "a": {"count": 1, "total_ns": 20 * ms, "self_ns": 10 * ms},
        "b": {"count": 2, "total_ns": 10 * ms, "self_ns": 8 * ms},
        "c": {"count": 1, "total_ns": 2 * ms, "self_ns": 2 * ms}}
    assert obs.reset_spans()["a"]["count"] == 1 and obs.spans() == {}


def test_off_path_is_one_shared_no_op(fresh, monkeypatch):
    def refuse(*_):
        raise AssertionError("the off path read the clock or made a span")
    monkeypatch.setattr(obs, "_clock", refuse)
    monkeypatch.setattr(obs, "_Span", refuse)
    assert obs.span("gbdt.round") is obs.span("tree.split.3") is obs._OFF
    with obs.span("gbdt.round"):
        with obs.span("host.wait"):
            assert obs.open_spans() == ()
    span = obs.span
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        for _ in itertools.repeat(None, 10_000):
            with span("tree.split.3"):
                pass
        after = tracemalloc.get_traced_memory()[0]
    finally:
        tracemalloc.stop()
    assert after == before
    assert obs.spans() == {}


def test_counters_are_thread_safe_and_re_exported(fresh):
    assert metrics.record is obs.record and metrics.delta is obs.delta
    before = metrics.snapshot()
    obs.enable(True)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2_000):
                obs.record("obs_test")
                with obs.span("obs.thread"):
                    pass
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert metrics.delta(before) == {"obs_test": 32_000}
    assert obs.spans()["obs.thread"]["count"] == 32_000
    obs.reset()
    assert metrics.counts() == {}


def test_spans_land_in_the_profilers_host_timeline(fresh):
    x = torch.ones(64)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with obs.span("obs.outer"):
            with obs.span("obs.inner"):
                x = x * 2
    assert obs.spans()["obs.outer"]["count"] == 1    # on with the profiler
    events = prof.events()
    assert not any(e.is_user_annotation for e in events)
    by_name = {e.name: e for e in events}
    outer, inner = by_name["obs.outer"], by_name["obs.inner"]
    mul = by_name["aten::mul"]
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= outer.time_range.end
    assert inner.time_range.start <= mul.time_range.start
    assert mul.time_range.end <= inner.time_range.end


def test_a_profiler_started_or_stopped_inside_a_span_is_harmless(fresh):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with obs.span("obs.before"):            # off: the no-op
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        with obs.span("obs.during"):
            prof.stop()
    assert set(obs.spans()) == {"obs.during"}
    with torch.profiler.profile(activities=acts):
        outer = obs.span("obs.outer")
        outer.__enter__()
    outer.__exit__(None, None, None)       # after the profiler stopped
    assert obs.spans()["obs.outer"]["count"] == 1


def _dataset(task, seed=3):
    X, y, cats = make_tabular(1500, 5, 2, n_cats=5, task=task, seed=seed,
                              n_classes=3)
    codes = binning.Binner(32, cats).fit(X).transform_codes(X)
    is_cat = np.isin(np.arange(X.shape[1]), cats)
    return binning.dataset_from_codes(codes, is_cat, 32, device="cpu"), y


ROUND_CASES = {
    "binary": dict(task="binary", objective="binary:logistic", eval=False),
    "binary_eval": dict(task="binary", objective="binary:logistic",
                        eval=True),
    "multiclass": dict(task="multiclass", objective="multi:softmax",
                       n_classes=3, eval=False),
}


@pytest.mark.parametrize("case", ROUND_CASES, ids=list(ROUND_CASES))
def test_round_spans_and_bit_equal_fits(fresh, case):
    c = ROUND_CASES[case]
    data, y = _dataset(c["task"])
    depth, rounds = 3, 3
    cfg = GBDTConfig(n_trees=rounds, max_depth=depth,
                     objective=c["objective"], n_classes=c.get("n_classes"))
    kw = dict(device="cpu", eval_set=(data, y) if c["eval"] else None)
    off = train(cfg, data, y, **kw)
    assert obs.spans() == {}
    obs.enable(True)
    on = train(cfg, data, y, **kw)
    obs.enable(False)
    rows = obs.spans()
    waits = 2 if c["eval"] else 1
    expect = {"gbdt.round": rounds, "gbdt.draws": rounds,
              "gbdt.grad": rounds, "tree.grow": rounds,
              "tree.leaves": rounds, "gbdt.traverse": waits * rounds,
              "gbdt.loss": waits * rounds, "host.wait": waits * rounds}
    for step in ("hist", "split", "partition"):
        expect.update({f"tree.{step}.{L}": rounds for L in range(depth)})
    assert {k: v["count"] for k, v in rows.items()} == expect
    assert rows["tree.grow"]["total_ns"] <= rows["gbdt.round"]["total_ns"]
    assert rows["gbdt.round"]["self_ns"] >= 0
    for a, b in zip(off.model.trees, on.model.trees):
        assert torch.equal(a, b)
    assert off.history == on.history
    assert torch.equal(off.margins, on.margins)
    assert set(on.step_times) == {"binning_split", "traversal", "other"}


def test_predict_margin_is_one_span(fresh):
    data, y = _dataset("binary")
    model = train(GBDTConfig(n_trees=2, max_depth=2,
                             objective="binary:logistic"),
                  data, y, device="cpu").model
    obs.enable(True)
    model.predict_margin(data)
    obs.enable(False)
    assert obs.spans()["gbdt.predict"]["count"] == 1


def test_every_unpack_of_packed_codes_is_one_span(fresh):
    codes = torch.randint(0, 16, (37, 115), dtype=torch.uint8)
    packed = binning.PackedCodes.pack(codes)
    packed_cm = binning.PackedCodes.pack(codes.T.contiguous())
    assert torch.equal(packed.unpack(), codes)        # tracing off
    assert obs.spans() == {}
    obs.enable(True)
    assert torch.equal(packed.unpack(), codes)
    assert torch.equal(binning.as_unpacked(packed_cm), codes.T)
    assert np.array_equal(np.asarray(packed), codes.numpy())
    idx = torch.tensor([3, 0])
    assert torch.equal(tree_mod._gather_fields(packed_cm, idx), codes.T[idx])
    assert binning.as_unpacked(codes) is codes         # plain: no unpack
    obs.enable(False)
    assert obs.spans()[binning.UNPACK_SPAN]["count"] == 4
    assert set(obs.spans()) == {"codes.unpack"}
    binning.as_unpacked(packed)
    assert obs.spans()["codes.unpack"]["count"] == 4

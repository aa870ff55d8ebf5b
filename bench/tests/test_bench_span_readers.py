"""The readers of the program's spans (``repro_torch.obs``):
``host_waits_per_round``, ``host_ms_per_round`` and ``grower_host_ms``."""
from bench.run import Context
from bench.spec import Spec
from repro_torch import obs

READERS = ("host_waits_per_round", "host_ms_per_round", "grower_host_ms")


def test_span_readers_none_when_empty_and_exact_when_planted(monkeypatch):
    spec = Spec()
    ctx = Context(None, {}, {})
    monkeypatch.setattr(obs, "_rows", {})
    assert {m: spec.reader(m).read(ctx) for m in READERS} == dict.fromkeys(
        READERS)
    # two rounds: round [0, 20] ms, tree.grow [1, 13], host.wait [15, 19];
    # then round [100, 124], tree.grow [101, 113], host.wait [116, 122]
    ticks = iter(int(t * 1e6) for t in
                 (0, 1, 13, 15, 19, 20, 100, 101, 113, 116, 122, 124))
    monkeypatch.setattr(obs, "_clock", lambda: next(ticks))
    monkeypatch.setattr(obs, "_enabled", True)
    for _ in range(2):
        with obs.span("gbdt.round"):
            with obs.span("tree.grow"):
                pass
            with obs.span("host.wait"):
                pass
    assert {m: spec.reader(m).read(ctx) for m in READERS} == {
        "host_waits_per_round": 1.0,
        "host_ms_per_round": (44 - 10) / 2,
        "grower_host_ms": 12.0}

"""What the training round's spans (``repro_torch.obs``) show on one
NVIDIA GPU, at a benchmark cell's sizes.

    python3 scripts/obs_round.py WORKLOAD SEED

``WORKLOAD`` is a training cell of ``BENCHMARK.json`` (``higgs.train``,
``covertype.train``); its table is made from ``SEED`` and set up as the
benchmark sets it up (``bench/kinds/train.py``).  The span tables and
the named idle gaps of a cell come from the benchmark's own traced run
(``bench/run.py --trace 1``); this script makes the checks that run
cannot.  In this order (the first profile slows the process's launches
for the rest of its life, so the profiles come last):

* ``sync``: 6 rounds under ``torch.cuda.set_sync_debug_mode("warn")``,
  each warning filed under the spans open when it was raised; a warning
  outside ``host.wait`` is printed with the port's frame that raised it;
* ``cost``: 20-round fits with tracing off and held on by
  ``obs.enable(True)`` (no profiler), in turns off, on, on, off, twice;
  the mean round of each by the host clock, and the spans of the fits
  with tracing on, per round;
* ``off_ns``: the host's cost of one span with tracing off, against an
  empty loop and ``contextlib.nullcontext`` (a million each);
* ``profile``: 3 rounds under ``torch.profiler`` with the device's
  activity alone (as the benchmark's metric stretch), then 3 with the
  host's too: the events that carry ``is_user_annotation``, the device
  events, and the host events named after a span.

It prints the card's name and power limit and ends with one JSON line,
also written to ``chiprun_out/obs_checks_<workload>_<seed>.json``.
"""
import contextlib
import dataclasses
import itertools
import json
import os
import statistics
import subprocess
import sys
import time
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not found"


def _per_round(rows, rounds):
    """Each span's count, total and self ms a round, largest total
    first."""
    return {name: {"count": r["count"] / rounds,
                   "total_ms": r["total_ns"] / rounds / 1e6,
                   "self_ms": r["self_ns"] / rounds / 1e6}
            for name, r in sorted(rows.items(),
                                  key=lambda kv: -kv[1]["total_ns"])}


def _print_table(title, table):
    print(f"{title}: span, count, total ms, self ms a round")
    for name, r in table.items():
        print(f"  {name:20s} {r['count']:6.2f} {r['total_ms']:9.4f} "
              f"{r['self_ms']:9.4f}")


def _load(workload, seed):
    from bench.run import CACHE, devices_for
    from bench.spec import Spec
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(CACHE / "torch_extensions"))
    spec = Spec()
    cell = spec.cell(workload)
    mix = spec.traffic(cell["traffic"])
    kind = spec.kind(mix["kind"])
    load = kind.KIND(spec.config(cell["config"]), mix, seed,
                     devices_for(cell), spec.limits(workload), None)
    load.setup()
    return load


def _fit(load, rounds):
    import torch
    from repro_torch.core.gbdt import train
    cfg = dataclasses.replace(load.gcfg, n_trees=rounds)
    t0 = time.perf_counter()
    res = train(cfg, load.dataset, load.table.y, device=load.device)
    torch.cuda.synchronize(load.device)
    return res, time.perf_counter() - t0


def _sync_check(load, rounds=6):
    import torch
    from repro_torch import obs
    seen = []

    def hook(message, category, filename, lineno, file=None, line=None):
        port = [f for f in traceback.extract_stack()
                if "repro_torch" in f.filename and "obs.py" not in f.filename]
        seen.append({"spans": obs.open_spans(), "message": str(message)[:90],
                     "frame": (f"{Path(port[-1].filename).name}:"
                               f"{port[-1].lineno} {port[-1].line}"
                               if port else filename)})

    old = obs.enable(True)
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _fit(load, rounds)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            obs.enable(old)
    in_round = [w for w in seen if "gbdt.round" in w["spans"]]
    in_wait = [w for w in in_round if w["spans"][-1] == "host.wait"]
    stray = [w for w in in_round if w["spans"][-1] != "host.wait"]
    out = {"rounds": rounds, "warnings": len(seen),
           "in_rounds": len(in_round), "in_host_wait": len(in_wait),
           "per_round": len(in_round) / rounds,
           "outside_rounds": [w["frame"] for w in seen
                              if "gbdt.round" not in w["spans"]],
           "stray": stray}
    print(f"sync: {len(in_round)} warnings in {rounds} rounds "
          f"({len(in_wait)} inside host.wait), {len(seen) - len(in_round)} "
          f"outside the rounds")
    for w in stray:
        print(f"  stray: {w['spans']} {w['frame']} {w['message']}")
    for frame in out["outside_rounds"]:
        print(f"  outside a round: {frame}")
    return out


def _cost(load, rounds=20, pairs=2):
    from repro_torch import obs
    obs.reset_spans()
    times = {"off": [], "on": []}
    for mode in ("off", "on", "on", "off") * pairs:
        old = obs.enable(mode == "on")
        try:
            _, secs = _fit(load, rounds)
        finally:
            obs.enable(old)
        times[mode].append(secs / rounds * 1e3)
    table = _per_round(obs.reset_spans(), rounds * 2 * pairs)
    off, on = statistics.fmean(times["off"]), statistics.fmean(times["on"])
    print(f"cost: mean round off {off!r} ms, on {on!r} ms "
          f"({100 * (on / off - 1)!r} %); off {times['off']}, "
          f"on {times['on']}")
    _print_table("spans with tracing held on, no profiler", table)
    return {"round_ms": times, "off_ms": off, "on_ms": on,
            "spans_per_round": table}


def _off_ns(n=1_000_000):
    from repro_torch import obs
    span, null = obs.span, contextlib.nullcontext()

    def empty():
        for _ in itertools.repeat(None, n):
            pass

    def spans():
        for _ in itertools.repeat(None, n):
            with span("tree.split.3"):
                pass

    def nulls():
        for _ in itertools.repeat(None, n):
            with null:
                pass

    out = {}
    for name, fn in (("empty", empty), ("span_off", spans),
                     ("nullcontext", nulls)):
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter_ns()
            fn()
            best = min(best, time.perf_counter_ns() - t0)
        out[name] = best / n
    out["span_off_less_empty"] = out["span_off"] - out["empty"]
    print(f"off_ns: {out}")
    return out


def _profile_check(load, rounds=3):
    import torch
    from repro_torch import obs
    acts = torch.profiler.ProfilerActivity
    names = {"gbdt.", "tree.", "host."}
    out = {}
    for label, activities in (("device", [acts.CUDA]),
                              ("host_and_device", [acts.CPU, acts.CUDA])):
        obs.reset_spans()
        with torch.profiler.profile(activities=activities) as prof:
            _fit(load, rounds)
        events = prof.events()
        device = [e for e in events if "CUDA" in str(e.device_type)]
        out[label] = {
            "events": len(events), "device_events": len(device),
            "user_annotations": sum(bool(getattr(e, "is_user_annotation",
                                                 False)) for e in events),
            "span_events": sum(e.name[:5] in names for e in events),
            "span_rows": obs.reset_spans().get("gbdt.round",
                                               {}).get("count", 0)}
        print(f"profile {label}: {out[label]}")
    return out


def main(argv) -> int:
    workload, seed = argv[0], int(argv[1])
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card: nothing measured", file=sys.stderr)
        return 2
    card = _card()
    print(f"card: {card}; torch {torch.__version__}")
    load = _load(workload, seed)
    out = {"workload": workload, "seed": seed, "card": card,
           "sync": _sync_check(load), "cost": _cost(load),
           "off_ns": _off_ns(), "profile": _profile_check(load)}
    line = json.dumps(out)
    dest = ROOT / "chiprun_out" / f"obs_checks_{workload}_{seed}.json"
    dest.parent.mkdir(exist_ok=True)
    dest.write_text(line + "\n")
    print(line[:4000])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

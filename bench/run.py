"""Run one benchmark cell once and print its result as the last line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``'s
``workloads``) names a configuration and a traffic mix; the run makes
its inputs from the seed on the card, sets up the program, measures for
``--seconds`` and then checks what the program produced against the
plain reference.  With ``--trace 0`` the result holds the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from
a profiled stretch of the window, and a breakdown of the trace.  Without
a CUDA card (or with fewer cards than the cell asks for) it exits with
code 2 and prints no result.
"""
import time

T0 = time.perf_counter()          # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "bench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _paths() -> None:
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    # every build and kernel cache at a fixed path inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Context:
    """What a per-layer metric's reader sees."""

    def __init__(self, trace, shapes, counters):
        self.trace, self.shapes, self.counters = trace, shapes, counters


def devices_for(cell) -> list:
    """The cards a cell asks for: ``cuda:0`` up to its ``chips``."""
    import torch
    return [torch.device("cuda", i) for i in range(int(cell["chips"]))]


def run_cell(spec, name: str, seed: int, seconds: float, trace: bool,
             devices, t0: float, control=None):
    """One run of cell ``name`` on ``devices``; returns (result dict,
    checks, notes).  The result is ``None`` where the run must print
    none."""
    import torch

    from bench import load as load_mod
    from bench.measure import profile as prof_mod

    cell = spec.cell(name)
    config, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    kind = spec.kind(mix["kind"])
    load = kind.KIND(config, mix, seed, devices, spec.limits(name), control)
    load.setup()
    for d in load.devices:
        load_mod.sync(d)
    load_mod.settle()
    setup_s = time.perf_counter() - t0
    profiler = prof_mod.Profiler(len(load.devices)) if trace else None
    res = load.window(seconds, profiler)
    cuda = load.device.type == "cuda"
    peak = max(int(torch.cuda.max_memory_allocated(d)) if cuda else 0
               for d in load.devices)
    found = forbidden_modules()
    if found:
        return None, [], [f"the window loaded {', '.join(found)}: refused"]
    metrics = {}
    units = {m["name"]: m["unit"] for m in spec.declared["end_to_end"]
             + spec.declared["per_layer"]}
    tr = profiler.trace if profiler is not None else None
    if trace:
        ctx = Context(tr, load.shapes(), load.counters)
        for m in spec.per_layer(name):
            value = spec.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        if tr is None:
            load.notes.append("every profile came back without device "
                              "events: the profiled metrics are left out")
    else:
        measured = dict(res["metrics"], setup_s=setup_s)
        for m in spec.end_to_end(name):
            if m["name"] not in measured:
                if control:           # the control's window is not timed
                    continue
                raise SystemExit(f"{name} does not measure {m['name']}")
            metrics[m["name"]] = {"value": float(measured[m["name"]]),
                                  "unit": units[m["name"]]}
    dev = {"platform": "gpu" if cuda else load.device.type,
           "kind": (torch.cuda.get_device_name(load.device)
                    if cuda else "cpu"),
           "count": int(cell["chips"]), "memory_peak_bytes": peak}
    if trace and tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
    load.free()
    checks = load.verdict()
    load.notes += [f"{k} {v}" for k, v in sorted(load.counters.items())]
    correct = (res["failed"] == 0
               and all(math.isfinite(v) and v <= lim for _, v, lim in checks))
    result = {"correct": correct, "attempted": res["attempted"],
              "failed": res["failed"], "metrics": metrics, "device": dev}
    if trace and tr is not None:
        gaps = profiler.gap_trace
        result["breakdown"] = {"device_ops": prof_mod.device_ops(tr),
                               "idle_gaps": prof_mod.idle_gaps(gaps)
                               if gaps is not None else []}
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in checks}
    return result, checks, load.notes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    import torch

    from bench.spec import Spec

    spec = Spec()
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}: no result",
              file=sys.stderr)
        return 2
    result, checks, notes = run_cell(spec, args.workload, args.seed,
                                     args.seconds, bool(args.trace),
                                     devices_for(cell), T0)
    for line in notes:
        print(line, file=sys.stderr)
    found = forbidden_modules()
    if result is None or found:
        print(f"loaded {', '.join(found)}: no result", file=sys.stderr)
        return 3
    for n, v, lim in checks:
        print(f"check {n} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

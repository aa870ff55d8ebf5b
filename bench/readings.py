"""The readings that a cell's limits are set from, on the card.

    python3 bench/readings.py --workload higgs.train --seeds 11,12,13 \\
        --mode control --seconds 1

One process runs the cell once a seed, at its own sizes, and prints one
JSON line a seed with every number its check compares.  ``--mode``:

* ``program``: the program as the benchmark runs it (the lower readings);
* ``control``: the plain reference, computed in bfloat16, in the
  program's place (``bench/kinds/<kind>.py``; its readings bound the
  limits from above, and the check has to fail it);
* ``fault:<name>``: the program with a fault that the cell's kind plants
  underneath (``bench/faults.py``).

The benchmark's own runs never run the control or a fault.
"""
import argparse
import contextlib
import json
import sys
import time

from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", default="program")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    from bench.run import _paths
    _paths()
    import torch

    from bench.run import devices_for, run_cell
    from bench.spec import Spec

    if not torch.cuda.is_available():
        print("no CUDA card: no readings", file=sys.stderr)
        return 2
    spec = Spec()
    cell = spec.cell(args.workload)
    kind = spec.kind(spec.traffic(cell["traffic"])["kind"])
    control = "bf16" if args.mode == "control" else None
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.mode.startswith("fault:"):
            from bench.faults import planted
            scope = planted(args.mode.split(":", 1)[1], kind)
        else:
            scope = contextlib.nullcontext()
        t0 = time.perf_counter()
        with scope:
            result, checks, notes = run_cell(
                spec, args.workload, seed, args.seconds, False,
                devices_for(cell), t0, control=control)
        print(json.dumps({
            "workload": args.workload, "mode": args.mode, "seed": seed,
            "correct": result["correct"],
            "seconds": time.perf_counter() - t0,
            "checks": {n: v for n, v, _ in checks}}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    sys.exit(main())

"""Time the ensemble kernel of several checkouts on one NVIDIA GPU, each in
a fresh process, in the order given.

    python3 scripts/ensemble_ab.py SRC [SRC ...]

Each SRC is the ``src`` directory of a checkout of this repository: its
``repro_torch`` package is imported from there and builds its kernels into
that checkout's ``build/``.  Giving ``A B B A`` compares two versions on one
card within one call.  Every process makes the same inputs from one seed:
random depth-6 trees (split fields in [-1, F), so pass-through nodes too;
numeric and categorical splits) with real (normal, not dyadic) leaves, and
random codes with the last bin as the missing bin, at three shapes:

* ``higgs``: K = 1, 10,000,000 records of 28 uint8 codes (256 bins),
  T = 500 trees;
* ``cover``: K = 7, 581,012 records of 54 codes (256 bins), T = 504 trees
  (72 rounds of 7 classes, tree t into column t % 7);
* ``iot``: K = 1, 2,000,000 records of 115 codes of 16 bins (the IoT path
  predicts through this kernel after ``unpack_codes``), T = 500 trees.

For each it prints the median and the least time of 20 launches after a
warm-up (CUDA events), the device time of one launch by kernel name
(``torch.profiler`` over 3 launches; "not measured" where it sees none) and
a sha256 of the output bytes: equal hashes across checkouts show that the
sums are bit-equal.  Then the card's name and power limit, each shape's
mean median per SRC against the first SRC's with the hashes compared, and
one JSON line with every result.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

SEED = 1
REPS = 20
DEPTH = 6
# (name, records, fields, bins, trees, classes)
SHAPES = (("higgs", 10_000_000, 28, 256, 500, 1),
          ("cover", 581_012, 54, 256, 504, 7),
          ("iot", 2_000_000, 115, 16, 500, 1))


def _timed(fn) -> dict:
    """Median and least of REPS timed launches, and the profiler's device
    time of one launch by kernel name."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        us = getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0))
        if us > 0:
            kernels[e.key[:60]] = us / 3 / 1e3
    return {"median_ms": statistics.median(times), "min_ms": min(times),
            "kernels": kernels or "not measured"}


def child(src: str) -> dict:
    import torch

    sys.path.insert(0, str(Path(src).resolve()))
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import traversal as trav_k

    _build.build_all()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {"src": src}
    n_int = 2 ** DEPTH - 1
    for name, n, F, NB, T, K in SHAPES:
        codes = torch.randint(0, NB, (n, F), generator=gen, device=dev,
                              dtype=torch.uint8)
        ints = [torch.randint(lo, hi, (T, n_int), generator=gen, device=dev,
                              dtype=torch.int32)
                for lo, hi in ((-1, F), (0, NB - 1), (0, 2), (0, 2))]
        leaves = 0.1 * torch.randn((T, 2 ** DEPTH), generator=gen,
                                   device=dev)
        trees = ref.TreeArrays(*ints, leaves)

        def run():
            return trav_k.predict_ensemble_cuda(trees, codes,
                                                missing_bin=NB - 1,
                                                n_classes=K)

        res = _timed(run)
        res["sha256"] = hashlib.sha256(
            run().cpu().numpy().tobytes()).hexdigest()
        out[name] = res
        del codes, trees
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("srcs", nargs="+")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child(args.srcs[0])))
        return 0
    results = []
    for src in args.srcs:
        proc = subprocess.run([sys.executable, __file__, src, "--child"],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        results.append(res)
        print(src + "  " + "  ".join(
            f"{k} {v['median_ms']:.4f} (min {v['min_ms']:.4f}) "
            f"{v['sha256'][:12]}" for k, v in res.items()
            if isinstance(v, dict)), flush=True)
        for k, v in res.items():
            if isinstance(v, dict):
                print(f"    {k} by kernel: {json.dumps(v['kernels'])}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0])
    srcs = list(dict.fromkeys(args.srcs))
    for name, *_ in SHAPES:
        mean = {s: statistics.mean(r[name]["median_ms"] for r in results
                                   if r["src"] == s) for s in srcs}
        hashes = {r[name]["sha256"] for r in results}
        print(f"{name:6s} " + "  ".join(
            f"{s}: {mean[s]:.4f} ms ({mean[srcs[0]] / mean[s]:.2f}x)"
            for s in srcs)
            + ("  outputs bit-equal" if len(hashes) == 1
               else f"  outputs differ ({len(hashes)} hashes)"))
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())

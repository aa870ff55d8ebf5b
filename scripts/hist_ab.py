"""Time the histogram kernels of several checkouts on one NVIDIA GPU, each
in a fresh process, in the order given.

    python3 scripts/hist_ab.py SRC [SRC ...]

Each SRC is the ``src`` directory of a checkout of this repository: its
``repro_torch`` package is imported from there and builds its kernels into
that checkout's ``build/``.  Giving ``A B B A`` compares two versions on one
card within one call.  Every process makes the same inputs from one seed and
times every entry of the grouped kernel (``histogram_cuda``) and the
naive-packing kernel (``histogram_naive_cuda``, cases ``naive_*``) at the
shapes of ``chip_smoke.py``'s paths, at NN = 1 and NN = 32 nodes a class
(the first and the deepest level of a depth-6 tree), node ids drawn
uniformly, g normal and h in [0.1, 1):

* ``higgs``: 10,000,000 records of 28 random uint8 codes, 256 bins, K = 1
  (both kernels);
* ``cover``: the Covertype-shaped path's own codes (581,012 records, 10
  numeric fields and 44 two-category fields, made by ``make_tabular`` and
  ``Binner(256)`` from the seed as ``chip_smoke.py`` makes them), K = 7
  (both kernels);
* ``cover_random``: 581,012 records of 54 random uint8 codes, K = 7;
* ``iot_nibble``: 2,000,000 records of 115 random 4-bit codes, packed
  (``PackedCodes``, the nibble entry), 16 bins, K = 1; ``naive_iot``: the
  same codes unpacked, through the naive kernel.

For each it prints the median and the least time of 20 launches after a
warm-up (CUDA events), the device time of one launch by kernel name
(``torch.profiler`` over 3 launches; "not measured" where it sees none) and
the sha256 of the output for dyadic g, h (on a 1/64 grid: every order of
summation is exact, so equal hashes mean bit-equal sums), one line per
process; then the card's name and power limit, each shape's mean median
per SRC against the first SRC's, and one JSON line with every result.
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
LEVELS = (1, 32)
HIGGS = (10_000_000, 28, 256)
COVER_RECORDS, COVER_NUMERIC, COVER_BINARY, COVER_CLASSES = 581_012, 10, 44, 7
IOT = (2_000_000, 115, 16)


def _timed(fn, dyadic) -> dict:
    """Median and least of REPS timed launches, the profiler's device time
    of one launch by kernel name, and the sha256 of ``dyadic()``'s output."""
    import torch

    sha = hashlib.sha256(dyadic().cpu().numpy().tobytes()).hexdigest()
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
            "kernels": kernels or "not measured", "sha256": sha}


def child(src: str) -> dict:
    import torch

    sys.path.insert(0, str(Path(src).resolve()))
    from repro_torch.core.binning import Binner, PackedCodes
    from repro_torch.data import make_tabular
    from repro_torch.kernels import _build
    from repro_torch.kernels import histogram as hist_k

    _build.build_all()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {"src": src}

    def levels(name, codes, K, n_bins, entries=("grouped",)):
        n = codes.shape[0]
        shape = (n,) if K == 1 else (K, n)
        g = torch.randn(shape, generator=gen, device=dev)
        h = torch.rand(shape, generator=gen, device=dev) * 0.9 + 0.1
        g_dy = torch.randint(-64, 64, shape, generator=gen, device=dev) / 64
        h_dy = torch.randint(1, 64, shape, generator=gen, device=dev) / 64
        for nn in LEVELS:
            nid = torch.randint(0, nn, shape, generator=gen, device=dev,
                                dtype=torch.int32)
            for entry in entries:
                fn = (hist_k.histogram_cuda if entry == "grouped"
                      else hist_k.histogram_naive_cuda)
                key = f"{name}_nn{nn}" if entry == "grouped" \
                    else f"naive_{name}_nn{nn}"
                out[key] = _timed(
                    lambda: fn(codes, g, h, nid, n_nodes=nn, n_bins=n_bins),
                    lambda: fn(codes, g_dy, h_dy, nid, n_nodes=nn,
                               n_bins=n_bins))

    n, F, NB = HIGGS
    levels("higgs", torch.randint(0, NB, (n, F), generator=gen, device=dev,
                                  dtype=torch.uint8), 1, NB,
           ("grouped", "naive"))
    # the Covertype-shaped path's codes, as chip_smoke.py makes them
    n = COVER_RECORDS
    X, _, cats = make_tabular(n + n // 10, COVER_NUMERIC, COVER_BINARY,
                              n_cats=2, task="multiclass",
                              n_classes=COVER_CLASSES, seed=SEED)
    codes = Binner(256, categorical_fields=cats).fit(X[:n]).transform(
        X[:n], device=dev).codes
    del X
    levels("cover", codes, COVER_CLASSES, 256, ("grouped", "naive"))
    levels("cover_random", torch.randint(
        0, 256, tuple(codes.shape), generator=gen, device=dev,
        dtype=torch.uint8), COVER_CLASSES, 256)
    n, F, NB = IOT
    codes = torch.randint(0, NB, (n, F), generator=gen, device=dev,
                          dtype=torch.uint8)
    levels("iot_nibble", PackedCodes.pack(codes), 1, NB)
    levels("iot", codes, 1, NB, ("naive",))
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
            f"{k} {v['median_ms']:.4f}" for k, v in res.items()
            if isinstance(v, dict)), flush=True)
        for k, v in res.items():
            if isinstance(v, dict):
                print(f"    {k} by kernel: {json.dumps(v['kernels'])}  "
                      f"sha256 {v['sha256'][:16]}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0])
    shapes = [k for k, v in results[0].items() if isinstance(v, dict)]
    srcs = list(dict.fromkeys(args.srcs))
    mean = {s: {k: statistics.mean(r[k]["median_ms"] for r in results
                                   if r["src"] == s) for k in shapes}
            for s in srcs}
    for k in shapes:
        hashes = {r[k]["sha256"] for r in results}
        # the naive kernel's dyadic sums against the grouped kernel's
        twin = k[len("naive_"):] if k.startswith("naive_") else None
        if twin in shapes:
            hashes |= {r[twin]["sha256"] for r in results}
        print(f"{k:18s} " + "  ".join(
            f"{s}: {mean[s][k]:.4f} ms ({mean[srcs[0]][k] / mean[s][k]:.2f}x)"
            for s in srcs) + "  outputs "
            + ("bit-equal" if len(hashes) == 1 else "DIFFER")
            + (f" (and to {twin})" if twin in shapes else ""))
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())

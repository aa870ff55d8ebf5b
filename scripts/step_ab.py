"""Time the partition and step-⑤ traversal kernels of several checkouts on
one NVIDIA GPU, each in a fresh process, in the order given, and hash the
ensemble kernel's outputs.

    python3 scripts/step_ab.py SRC [SRC ...]

Each SRC is the ``src`` directory of a checkout of this repository: its
``repro_torch`` package is imported from there and builds its kernels into
that checkout's ``build/``.  Giving ``A B B A`` compares two versions on one
card within one call.  Every process makes the same inputs from one seed,
through entry points that every checkout since the port's fifth slice has:

* ``part_k1``: the column-major partition, K = 1, 10,000,000 records x 28
  uint8 codes, NN = 32 nodes with random splits (pass-through nodes,
  numeric and categorical);
* ``part_rows``: the same through the row entry (the level's 32 gathered
  columns, renumbered);
* ``part_k7``: K = 7 classes, 581,012 x 54, NN = 32 a class;
* ``part_nibble``: the nibble entry, 2,000,001 records (odd: a pad nibble)
  x 115 fields of 16 bins, NN = 32;
* ``trav_k1`` and ``trav_k7``: the step-⑤ kernel alone, one round's K
  random depth-6 trees (``traverse_forest_cuda``, leaf values out) at the
  K = 1 and K = 7 shapes above;
* ``round_k1``, ``round_k7`` and ``round_iot``: step ⑤ as the trainer runs
  it, the round's margins updated through ``core.gbdt._predict_forest``
  (``margins + _predict_forest(...)`` where it takes no margins, else the
  margins added into in place), over datasets of those shapes and of an
  IoT-shaped 2,000,000 x 115 set of 4-bit packed codes (one tree), all
  its device work; the hash is of one update of a fresh copy;
* ``ens_k1``, ``ens_k7``, ``ens_iot``: the ensemble kernel as in
  ``scripts/ensemble_ab.py`` (T = 500 / 504 / 500 trees, real leaves).

For each it prints the median and the least time of 20 calls after a
warm-up (CUDA events around the call: the wrapper's time), the device time
of one call by kernel name (``torch.profiler`` over 3 calls; "not
measured" where it sees none) and a sha256 of the output bytes: equal
hashes across checkouts show that the outputs are bit-equal.  Then the
card's name and power limit, each case's mean median and mean device time
per SRC against the first SRC's with the hashes compared, and one JSON
line with every result.
"""
from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import statistics
import subprocess
import sys
from pathlib import Path

SEED = 1
REPS = 20
DEPTH = 6
NN = 32
CASES = ("part_k1", "part_rows", "part_k7", "part_nibble", "trav_k1",
         "trav_k7", "round_k1", "round_k7", "round_iot", "ens_k1", "ens_k7",
         "ens_iot")


def _timed(fn) -> dict:
    """Median and least of REPS timed calls, and the profiler's device time
    of one call by kernel name."""
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
            "device_ms": sum(kernels.values()) if kernels else None,
            "kernels": kernels or "not measured"}


def child(src: str, cases) -> dict:
    import torch

    sys.path.insert(0, str(Path(src).resolve()))
    from repro_torch.core import binning, gbdt
    from repro_torch.core.binning import PackedCodes
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import partition as part_k
    from repro_torch.kernels import traversal as trav_k

    _build.build_all()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n_int = 2 ** DEPTH - 1

    def ints(shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    def trees(T, F, NB, real):
        arrays = [ints((T, n_int), lo, hi)
                  for lo, hi in ((-1, F), (0, NB - 1), (0, 2), (0, 2))]
        leaves = torch.randn((T, 2 ** DEPTH), generator=gen, device=dev)
        if not real:                     # dyadic: every sum exact
            leaves = torch.round(leaves * 64) / 64
        return ref.TreeArrays(*arrays, 0.1 * leaves if real else leaves)

    def codes_of(n, F, NB):
        return torch.randint(0, NB, (n, F), generator=gen, device=dev,
                             dtype=torch.uint8)

    def splits(K, F, NB):
        shape = (NN,) if K == 1 else (K, NN)
        return [ints(shape, lo, hi)
                for lo, hi in ((-1, F), (0, NB), (0, 2), (0, 2))]

    out = {"src": src}

    def record(name, fn, once=None):
        if name not in cases:
            return
        res = _timed(fn)
        res["sha256"] = hashlib.sha256(
            (once or fn)().cpu().numpy().tobytes()).hexdigest()
        out[name] = res

    # -- partition ---------------------------------------------------------
    for name, K, n, F, NB, packed in (
            ("part_k1", 1, 10_000_000, 28, 256, False),
            ("part_k7", 7, 581_012, 54, 256, False),
            ("part_nibble", 1, 2_000_001, 115, 16, True)):
        codes_cm = codes_of(F, n, NB)
        nid = ints((n,) if K == 1 else (K, n), 0, NN)
        split = splits(K, F, NB)
        data = PackedCodes.pack(codes_cm) if packed else codes_cm
        record(name, lambda: part_k.partition_cm_cuda(
            nid, data, *split, missing_bin=NB - 1))
        if name == "part_k1":
            lvl = codes_cm[split[0].clamp(min=0).long()].T.contiguous()
            renum = torch.where(split[0] >= 0, torch.arange(
                NN, device=dev, dtype=torch.int32), -1)
            record("part_rows", lambda: part_k.partition_cuda(
                nid, lvl, renum, *split[1:], missing_bin=NB - 1))
            del lvl
        del codes_cm, data, nid
        torch.cuda.empty_cache()

    # -- step ⑤ --------------------------------------------------------------
    for name, K, n, F in (("trav_k1", 1, 10_000_000, 28),
                          ("trav_k7", 7, 581_012, 54)):
        codes = codes_of(n, F, 256)
        forest = trees(K, F, 256, real=False)
        record(name, lambda: trav_k.traverse_forest_cuda(
            forest, codes, missing_bin=255))
        del codes
        torch.cuda.empty_cache()
    folds = "margins" in inspect.signature(gbdt._predict_forest).parameters
    for name, K, n, F, NB in (("round_k1", 1, 10_000_000, 28, 256),
                              ("round_k7", 7, 581_012, 54, 256),
                              ("round_iot", 1, 2_000_000, 115, 16)):
        data = binning.dataset_from_codes(codes_of(n, F, NB).cpu().numpy(),
                                          None, NB, device=dev)
        forest = trees(K, F, NB, real=True)
        base = torch.randn((n, K), generator=gen, device=dev)
        margins = base.clone()

        def step(m):
            if folds:
                return gbdt._predict_forest(forest, data, None, m)
            return m + gbdt._predict_forest(forest, data, None)

        record(name, lambda: step(margins), lambda: step(base.clone()))
        del data, base, margins
        torch.cuda.empty_cache()

    # -- the ensemble, as scripts/ensemble_ab.py ----------------------------
    for name, n, F, NB, T, K in (("ens_k1", 10_000_000, 28, 256, 500, 1),
                                 ("ens_k7", 581_012, 54, 256, 504, 7),
                                 ("ens_iot", 2_000_000, 115, 16, 500, 1)):
        codes = codes_of(n, F, NB)
        ens = trees(T, F, NB, real=True)
        record(name, lambda: trav_k.predict_ensemble_cuda(
            ens, codes, missing_bin=NB - 1, n_classes=K))
        del codes, ens
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("srcs", nargs="+")
    ap.add_argument("--cases", default=",".join(CASES),
                    help="comma-separated cases to run (default: all)")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    cases = [c for c in args.cases.split(",") if c]
    unknown = set(cases) - set(CASES)
    if unknown:
        ap.error(f"unknown cases {sorted(unknown)}; choose from {CASES}")
    if args.child:
        print(json.dumps(child(args.srcs[0], cases)))
        return 0
    results = []
    for src in args.srcs:
        proc = subprocess.run([sys.executable, __file__, src, "--child",
                               "--cases", ",".join(cases)],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        results.append(res)
        print(src, flush=True)
        for k in cases:
            v = res[k]
            dev_ms = ("not measured" if v["device_ms"] is None
                      else f"{v['device_ms']:.4f}")
            print(f"    {k:11s} {v['median_ms']:.4f} (min {v['min_ms']:.4f})"
                  f"  device {dev_ms}  {v['sha256'][:12]}  "
                  f"{json.dumps(v['kernels'])}", flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0])
    srcs = list(dict.fromkeys(args.srcs))
    for name in cases:
        mean = {s: statistics.mean(r[name]["median_ms"] for r in results
                                   if r["src"] == s) for s in srcs}
        dev = {s: [r[name]["device_ms"] for r in results if r["src"] == s]
               for s in srcs}
        dev = {s: statistics.mean(v) if None not in v else None
               for s, v in dev.items()}
        hashes = {r[name]["sha256"] for r in results}
        print(f"{name:11s} " + "  ".join(
            f"{s}: {mean[s]:.4f} ms ({mean[srcs[0]] / mean[s]:.2f}x), "
            f"device {'not measured' if dev[s] is None else f'{dev[s]:.4f}'}"
            for s in srcs)
            + ("  outputs bit-equal" if len(hashes) == 1
               else f"  outputs differ ({len(hashes)} hashes)"))
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())

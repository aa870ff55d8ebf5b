"""Time the single-class (K = 1) histogram kernel of several checkouts on
one NVIDIA GPU, each in a fresh process, in the order given.

    python3 scripts/hist_ab.py SRC [SRC ...]

Each SRC is the ``src`` directory of a checkout of this repository: its
``repro_torch`` package is imported from there and builds its kernels into
that checkout's ``build/``.  Giving ``A B B A`` compares two versions on one
card within one call.  Every process makes the same inputs from one seed,
at the Higgs-shaped main path's shape: 10,000,000 records of 28 random
uint8 codes, 256 bins, normal g and h in [0.1, 1), and node ids drawn
uniformly from NN = 1 and NN = 32 nodes (the first and the deepest level
of a depth-6 tree).  It prints the median and the least time of 20
launches after a warm-up, on CUDA events, one line per process, then the
card's name and power limit and one JSON line with every result.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

N_RECORDS, N_FIELDS, N_BINS, SEED = 10_000_000, 28, 256, 1
LEVELS = (1, 32)
REPS = 20


def child(src: str) -> dict:
    import torch

    sys.path.insert(0, str(Path(src).resolve()))
    from repro_torch.kernels import _build
    from repro_torch.kernels import histogram as hist_k

    _build.build_all()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n = N_RECORDS
    codes = torch.randint(0, N_BINS, (n, N_FIELDS), generator=gen,
                          device=dev, dtype=torch.uint8)
    g = torch.randn((n,), generator=gen, device=dev)
    h = torch.rand((n,), generator=gen, device=dev) * 0.9 + 0.1
    out = {"src": src, "records": n}
    for nn in LEVELS:
        nid = torch.randint(0, nn, (n,), generator=gen, device=dev,
                            dtype=torch.int32)

        def run():
            hist_k.histogram_cuda(codes, g, h, nid, n_nodes=nn,
                                  n_bins=N_BINS)

        run()
        torch.cuda.synchronize()
        times = []
        for _ in range(REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        out[f"nn{nn}_median_ms"] = statistics.median(times)
        out[f"nn{nn}_min_ms"] = min(times)
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
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        results.append(res)
        print("  ".join(f"{k} {v:.4f}" if isinstance(v, float) else
                        f"{k} {v}" for k, v in res.items()), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0])
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""How exact and how repeatable the grouped histogram kernel of several
checkouts is on one NVIDIA GPU, each in a fresh process.

    python3 scripts/hist_accuracy.py SRC [SRC ...]

Each SRC is the ``src`` directory of a checkout of this repository: its
``repro_torch`` package is imported from there and builds its kernels into
that checkout's ``build/``.  Every process makes the inputs of
``tests/test_torch_cuda.py``'s ``FIXED_POINT_CASES`` (the Higgs, Covertype
and IoT shapes, non-dyadic g and h, from one numpy seed) at NN = 1 and 32
nodes a class, launches ``histogram_cuda`` 20 times on each and prints,
per case: the number of distinct outputs (sha256 of the bytes), and the
least and the largest over the launches of the largest error over the bins
against the float64 sum of the same float32 g (h).  Then the card's name
and power limit, and one JSON line with every result.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

LAUNCHES = 20
LEVELS = (1, 32)
ROOT = Path(__file__).resolve().parents[1]


def child(src: str) -> dict:
    import torch

    sys.path[:0] = [str(Path(src).resolve()), str(ROOT / "tests")]
    from repro_torch.kernels import histogram as hist_k
    import test_torch_cuda as cases

    dev = torch.device("cuda", 0)
    out = {"src": src}
    for name in sorted(cases.FIXED_POINT_CASES):
        for nn in LEVELS:
            codes, g, h, nid, nb = cases.fixed_point_case(name, nn, dev)
            want = cases.float64_histogram(codes, g, h, nid, nn, nb)
            hashes, errs = set(), []
            for _ in range(LAUNCHES):
                got = hist_k.histogram_cuda(codes, g, h, nid, n_nodes=nn,
                                            n_bins=nb)
                hashes.add(hashlib.sha256(
                    got.cpu().numpy().tobytes()).hexdigest())
                err = (got.double().reshape(want.shape) - want).abs()
                errs.append([float(err[..., i].max()) for i in (0, 1)])
            out[f"{name}_nn{nn}"] = {
                "distinct": len(hashes),
                "least_max_err": [min(e[i] for e in errs) for i in (0, 1)],
                "most_max_err": [max(e[i] for e in errs) for i in (0, 1)]}
            del codes, g, h, nid, want
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
                              capture_output=True, text=True, timeout=1200)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        results.append(res)
        for k, v in res.items():
            if isinstance(v, dict):
                print(f"{src}  {k:14s} distinct {v['distinct']:2d}  "
                      f"max err g, h: least {v['least_max_err']}  "
                      f"most {v['most_max_err']}", flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0])
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Aggregate dry-run artifacts into the §Dry-run / §Roofline tables.

The counterpart of :mod:`repro.launch.report`: the same loader, rows and
markdown, over the port's records (``artifacts/dryrun_torch`` by default)
or ``repro``'s alike (``--dir artifacts/dryrun``); both keep the same keys.

Usage:  PYTHONPATH=src python -m repro_torch.launch.report [--dir DIR]
        [--mesh single|multi] [--variant base]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.configs import ARCH_IDS, SHAPES
from repro_torch.launch.roofline import format_table

KEYS = ["arch", "shape", "status", "compute", "memory", "collective",
        "dominant", "frac", "mf_ratio", "hbm/dev"]


def _fmt_s(x):
    if x is None:
        return "-"
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.2f}ms"
    return f"{x*1e6:.1f}us"


def _fmt_b(x):
    if x is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(x) < 1024:
            return f"{x:.1f}{unit}"
        x /= 1024
    return f"{x:.1f}PB"


def load(directory: str, mesh: str = "single", variant: str = "base"):
    """``{(arch, shape): record}`` of one mesh's records of ``variant``."""
    recs = {}
    for path in glob.glob(os.path.join(directory, f"{mesh}_*.json")):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("variant", "base") != variant:
            continue
        recs[(rec["arch"], rec["shape"])] = rec
    return recs


def roofline_rows(recs):
    """One row a cell, in ``ARCH_IDS`` x ``SHAPES`` order: SKIP, FAIL or
    the roofline terms."""
    rows = []
    for aid in ARCH_IDS:
        for sh in SHAPES:
            rec = recs.get((aid, sh))
            if rec is None:
                continue
            status = ("SKIP" if rec.get("skipped")
                      else "FAIL" if "error" in rec else None)
            if status:
                rows.append(dict({k: "-" for k in KEYS[3:]}, arch=aid,
                                 shape=sh, status=status))
                continue
            rows.append({
                "arch": aid, "shape": sh, "status": "ok",
                "compute": _fmt_s(rec["compute_s"]),
                "memory": _fmt_s(rec["memory_s"]),
                "collective": _fmt_s(rec["collective_s"]),
                "dominant": rec["dominant"],
                "frac": f"{rec['roofline_fraction']:.3f}",
                "mf_ratio": f"{rec.get('model_flops_ratio', 0):.3f}",
                "hbm/dev": _fmt_b(rec.get("bytes_per_device")),
            })
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    default_dir = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                               "artifacts", "dryrun_torch")
    ap.add_argument("--dir", default=os.path.abspath(default_dir))
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--variant", default="base")
    args = ap.parse_args(argv)

    recs = load(args.dir, args.mesh, args.variant)
    rows = roofline_rows(recs)
    print(f"### Roofline — mesh={args.mesh}, variant={args.variant}\n")
    print(format_table(rows, KEYS))
    ok = [r for r in rows if r["status"] == "ok"]
    print(f"\ncells: {len(rows)} total, {len(ok)} compiled, "
          f"{sum(1 for r in rows if r['status'] == 'SKIP')} skipped, "
          f"{sum(1 for r in rows if r['status'] == 'FAIL')} failed")


if __name__ == "__main__":
    main()

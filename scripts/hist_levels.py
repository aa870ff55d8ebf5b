"""Step ①'s device time a level on one NVIDIA GPU, the direct pass against
exact subtraction, on the benchmark's training cells' own tables.

    python3 scripts/hist_levels.py CELL [CELL ...] [--seed N] [--rounds R]

For each cell of ``BENCHMARK.json`` (``higgs.train``, ``covertype.train``,
``iot.train``, ``allstate.train_mixed``) it builds the cell's table and
codes from the seed as the benchmark does (``bench/``), then

1. fits R rounds (100 by default) of the cell's configuration and reads
   the histogram's counters (``repro_torch.obs``): the levels built by
   exact subtraction and the (class, record) pairs they listed against the
   pairs a direct pass lists;
2. keeps each level's inputs as the grower hands them to
   ``kernels/histogram.histogram_level_cuda`` at round ``TIMED_ROUND`` of
   that fit, and times each level > 0 both ways: the direct pass, and
   exact subtraction from the parent level's int64 sums (CUDA events
   behind a sleep kernel, so the host has queued every launch before the
   card reaches them; median of ``REPS`` calls).  Both must give the same
   float32 histogram and int64 sums, bit for bit.

Prints one line a cell, then one JSON line with every number, the card's
name and power limit first.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

TIMED_ROUND = 10
REPS = 20
HOLD_CYCLES = 20_000_000          # ~10 ms of the card's clock


def device_ms(fn) -> float:
    """Median device ms of ``fn``'s launches over REPS calls after a
    warm-up, each enqueued behind a sleep kernel."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        torch.cuda._sleep(HOLD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cell_levels(spec, name: str, seed: int, rounds: int) -> dict:
    import torch

    from repro_torch import obs
    from repro_torch.core import gbdt
    from repro_torch.kernels import histogram as hist_k
    from bench.load import gbdt_config

    cell = spec.cell(name)
    config, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    load = spec.kind(mix["kind"]).KIND(config, mix, seed,
                                       [torch.device("cuda", 0)],
                                       spec.limits(name))
    load.setup()
    gcfg = gbdt_config(config, mix, seed, rounds)
    depth = gcfg.max_depth
    real, calls, kept = hist_k.histogram_level_cuda, [0], []

    def spy(codes, g, h, nid, *, parent=None, **kw):
        if calls[0] // depth == TIMED_ROUND:
            kept.append((codes, g.clone(), h.clone(), nid.clone(), kw,
                         None if parent is None else parent.clone()))
        calls[0] += 1
        return real(codes, g, h, nid, parent=parent, **kw)

    hist_k.record_pair_counts()
    before = obs.snapshot()
    hist_k.histogram_level_cuda = spy
    try:
        gbdt.train(gcfg, load.dataset, load.table.y, device=load.device)
    finally:
        hist_k.histogram_level_cuda = real
    hist_k.record_pair_counts()
    gained = obs.delta(before)
    out = {"cell": name, "seed": seed, "rounds": rounds,
           "levels_subtracted": gained.get("hist.levels_subtracted", 0),
           "pairs_binned": gained.get("hist.pairs_binned", 0),
           "pairs_total": gained.get("hist.pairs_total", 0), "levels": []}
    out["pairs_share"] = out["pairs_binned"] / max(out["pairs_total"], 1)
    for level, (codes, g, h, nid, kw, parent) in enumerate(kept):
        if parent is None:
            out["levels"].append({"level": level, "direct_ms": device_ms(
                lambda: real(codes, g, h, nid, **kw))})
            continue
        direct = real(codes, g, h, nid, **kw)
        sub = real(codes, g, h, nid, parent=parent, **kw)
        equal = all(torch.equal(a, b) for a, b in zip(direct, sub))
        slot = nid.long() + kw["n_nodes"] * torch.arange(
            nid.shape[0], device=nid.device)[:, None]
        counts = torch.bincount(slot.reshape(-1),
                                minlength=nid.shape[0] * kw["n_nodes"])
        listed = int(counts[hist_k.smaller_child_plain(
            counts.view(nid.shape[0], -1)).reshape(-1)].sum())
        out["levels"].append({
            "level": level, "bit_equal": equal,
            "listed_share": listed / nid.numel(),
            "direct_ms": device_ms(lambda: real(codes, g, h, nid, **kw)),
            "sub_ms": device_ms(lambda: real(codes, g, h, nid,
                                             parent=parent, **kw))})
        del direct, sub
    del load, kept
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    import torch

    from bench.spec import Spec

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cells", nargs="+")
    ap.add_argument("--seed", type=int, default=3500000001)
    ap.add_argument("--rounds", type=int, default=100)
    args = ap.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    spec, results, ok = Spec(), [], True
    for name in args.cells:
        r = cell_levels(spec, name, args.seed, args.rounds)
        results.append(r)
        sub = [lv for lv in r["levels"] if "sub_ms" in lv]
        ok &= all(lv["bit_equal"] for lv in sub)
        print(f"{name}: levels subtracted {r['levels_subtracted']}, pairs "
              f"{r['pairs_binned']} of {r['pairs_total']} "
              f"({r['pairs_share']:.4f}); ms a level, direct [subtraction]: "
              + ", ".join(f"L{lv['level']} {lv['direct_ms']:.4f}"
                          + (f" [{lv['sub_ms']:.4f}]" if "sub_ms" in lv
                             else "") for lv in r["levels"])
              + f"; bit-equal {all(lv['bit_equal'] for lv in sub)}",
              flush=True)
    print(json.dumps({"card": card, "cells": results}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

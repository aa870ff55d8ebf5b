"""GBDT-at-scale dry run: the paper's own workload planned for H100 meshes.

The counterpart of :mod:`repro.launch.dryrun_gbdt`: one full level-wise
tree (steps ①–④ over depth 6) of a Terabyte-Click-Log-scale dataset
(200 M records x 64 fields, the paper's motivating scale, §IV) across 256
or 512 cards, records sharded over the data axes, fields and histogram
slabs over ``"model"``.  ``repro`` lowers and compiles the program on
placeholder XLA devices and reads XLA's cost and memory analyses and the
HLO's collectives; PyTorch has none of these, so this plan is analytic:
it counts, per card and per level, what the port's own schedule does
(``distributed.sharding.distributed_fit_tree`` for the ``explicit*``
variants, ``distributed.sharding.pjit_fit_tree`` for ``base``).  Nothing
is compiled or allocated (``plan_s`` replaces ``lower_s``/``compile_s``).
A card keeps ``repro``'s key names (``flops_per_chip``, ...), so both
packages' records cross-read.

Per card (D data shards = the product of the data axes, M = the model
axis, n_l = n / D records, f = F / M fields for ``explicit*`` and f = F for
``base``, whose model axis holds replicas; NB bins, level l has NN = 2^l
nodes, depth levels, 2^depth leaves):

  * step ① bytes: codes (n_l x f, uint8), g, h (float32) and node ids
    (int32) read once, the (NN, f, NB, 2) float32 histogram written once:
    n_l·f + 12·n_l + 8·NN·f·NB.
  * step ① operations: two adds a record and field (g and h into a bin):
    2·n_l·f.
  * step ② operations: ``SPLIT_OPS_PER_BIN`` a (node, field, bin): the
    prefix sums of G and H and the gain with the missing bin sent left and
    right: SPLIT_OPS_PER_BIN·NN·f·NB.
  * step ③ bytes: the node id read and written and one split-column code
    read a record, 9·n_l; with ``bits`` also the verdict written and its
    sum read, 11·n_l.  Operations: one comparison a record, n_l.
  * memory a card (``bytes_per_device``): both code layouts, g, h and node
    ids, and the deepest level's histogram:
    2·n_l·f + 12·n_l + 8·2^(depth-1)·f·NB.

Collectives a card, as ``collective_stats()`` counts them (bytes a shard,
an all-reduce's operand twice):

  * ``explicit*``, each level: one all-reduce of the (NN, F/M, NB, 2)
    histogram over the data axes, 2·8·NN·(F/M)·NB bytes (bf16: 2·4·...);
    one all-gather of the M shards' (NN, 8) float32 split candidates over
    ``"model"``, 32·M·NN bytes; then with ``bits`` one all-reduce of the
    int8 verdicts over ``"model"``, 2·n_l bytes, else (M > 1) one
    all-gather of the level's (NN, n_l) uint8 split columns over
    ``"model"``, NN·n_l bytes.
  * ``base``, each level: one all-reduce of the (1, NN, F, NB, 2) float32
    histogram over the data axes, 2·8·NN·F·NB bytes.
  * the tree's end, both: one all-reduce of the bottom leaves' (2, 2^depth)
    G, H sums over the data axes, 2·2·2^depth·8 bytes (float64 on the card;
    float32, 4 bytes, on a mesh of CPU devices).

Each collective names its link (``roofline.link_of``): NVLink within an
8-card node, the network across nodes.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_gbdt --mesh both \\
        --variant explicit

writes ``artifacts/dryrun_torch/{single,multi}_gbdt_<variant>.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List

from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import (Mesh, axis_size, data_axes,
                                     meta_production_mesh)

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun_torch")
VARIANTS = ("base", "explicit", "explicit_bf16", "explicit_bits",
            "explicit_bits_bf16")
SPLIT_OPS_PER_BIN = 20      # prefix sums of G, H; gain both ways missing


def plan_levels(mesh: Mesh, *, n_records: int, n_fields: int, n_bins: int,
                depth: int, variant: str) -> Dict:
    """The per-card plan of one tree on ``mesh``: ``levels`` (one dict a
    level: its bytes, operations, terms and collectives), ``tree_end``
    (the leaf sums' collective) and the card's shape (see the module's
    counts).  A mesh of CPU devices sums the leaves in float32, any
    other (the card's, or ``meta`` standing for it) in float64."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: one of {VARIANTS}")
    da = data_axes(mesh)
    D = axis_size(mesh, da)
    M = mesh.shape.get("model", 1)
    explicit = variant != "base"
    n_l = -(-n_records // D)
    f = n_fields // M if explicit else n_fields
    if explicit and n_fields % M:
        raise ValueError(f"{n_fields} fields do not divide the model axis "
                         f"({M})")
    hist_b = 2 if "bf16" in variant else 4
    bits = "bits" in variant
    levels: List[Dict] = []
    for level in range(depth):
        nn = 2 ** level
        hist_bytes = n_l * f + 12 * n_l + 8 * nn * f * n_bins
        part_bytes = (11 if bits else 9) * n_l
        ops_ = 2 * n_l * f + SPLIT_OPS_PER_BIN * nn * f * n_bins + n_l
        if explicit:
            colls = [rl.collective_entry(mesh, "all-reduce", da, 1,
                                         2 * nn * f * n_bins * 2 * hist_b),
                     rl.collective_entry(mesh, "all-gather", "model", 1,
                                         M * nn * 8 * 4)]
            if bits:
                colls.append(rl.collective_entry(mesh, "all-reduce",
                                                 "model", 1, 2 * n_l))
            elif M > 1:
                colls.append(rl.collective_entry(mesh, "all-gather",
                                                 "model", 1, nn * n_l))
        else:
            colls = [rl.collective_entry(mesh, "all-reduce", da, 1,
                                         2 * nn * f * n_bins * 2 * 4)]
        levels.append({
            "level": level, "nodes": nn, "hist_bytes": hist_bytes,
            "split_ops": SPLIT_OPS_PER_BIN * nn * f * n_bins,
            "partition_bytes": part_bytes, "ops": ops_,
            "hist_memory_s": hist_bytes / rl.HBM_BW,
            "partition_memory_s": part_bytes / rl.HBM_BW,
            "memory_s": (hist_bytes + part_bytes) / rl.HBM_BW,
            "collectives": colls,
            "collective_s": rl.collective_seconds(colls)})
    sum_bytes = 4 if mesh.devices.flat[0].type == "cpu" else 8
    tree_end = [rl.collective_entry(mesh, "all-reduce", da, 1,
                                    2 * 2 * 2 ** depth * sum_bytes)]
    return {"records_per_card": n_l, "fields_per_card": f,
            "data_shards": D, "model_shards": M, "levels": levels,
            "tree_end": tree_end,
            "memory_per_card": (2 * n_l * f + 12 * n_l
                                + 8 * 2 ** (depth - 1) * f * n_bins)}


def plan_collectives(plan: Dict) -> List[Dict]:
    """Every planned collective of the tree, levels then its end."""
    return [c for lv in plan["levels"] for c in lv["collectives"]] \
        + plan["tree_end"]


def run(multi_pod: bool, variant: str, n_records: int, n_fields: int,
        n_bins: int, depth: int) -> Dict:
    """One record: the plan on the production mesh, in ``repro``'s keys."""
    t0 = time.time()
    mesh = meta_production_mesh(multi_pod)
    plan = plan_levels(mesh, n_records=n_records, n_fields=n_fields,
                       n_bins=n_bins, depth=depth, variant=variant)
    colls = plan_collectives(plan)
    rec = {"arch": "gbdt-booster",
           "shape": f"fit_tree_{n_records}x{n_fields}", "variant": variant,
           "chips": mesh.size,
           "mesh": "x".join(str(s) for s in mesh.shape.values()),
           "bins": n_bins, "depth": depth}
    rec.update({k: plan[k] for k in ("records_per_card", "fields_per_card",
                                      "data_shards", "model_shards")})
    rec["bytes_per_device"] = plan["memory_per_card"]
    rec["flops_per_chip"] = float(sum(lv["ops"] for lv in plan["levels"]))
    rec["bytes_per_chip"] = float(sum(lv["hist_bytes"] + lv["partition_bytes"]
                                      for lv in plan["levels"]))
    rec["collectives"] = rl.by_kind(colls)
    rec["collective_links"] = colls
    rec["collective_bytes_per_chip"] = float(sum(c["bytes"] for c in colls))
    rec.update(rl.roofline_terms(rec["flops_per_chip"], rec["bytes_per_chip"],
                                 rec["collective_bytes_per_chip"],
                                 collective_s=rl.collective_seconds(colls),
                                 peak=rl.PEAK_FLOPS_FP32))
    rec["levels"] = plan["levels"]
    rec["tree_end"] = plan["tree_end"]
    rec["plan_s"] = round(time.time() - t0, 4)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--records", type=int, default=200_000_000)
    ap.add_argument("--fields", type=int, default=64)
    ap.add_argument("--bins", type=int, default=256)
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--variant", default="base", choices=list(VARIANTS))
    ap.add_argument("--out", default=None, help="artifact directory")
    args = ap.parse_args(argv)
    out_dir = os.path.abspath(args.out or ARTIFACT_DIR)
    os.makedirs(out_dir, exist_ok=True)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    for multi in meshes:
        tag = f"{'multi' if multi else 'single'}_gbdt_{args.variant}"
        print(f"[gbdt-dryrun] {tag} ...", flush=True)
        rec = run(multi, args.variant, args.records, args.fields,
                  args.bins, args.depth)
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
        links = sorted({c["link"] for c in rec["collective_links"]})
        print(f"[gbdt-dryrun]   ok plan={rec['plan_s']}s "
              f"card={rec['records_per_card']}x{rec['fields_per_card']} "
              f"dominant={rec['dominant']} "
              f"compute={rec['compute_s']:.3e}s "
              f"memory={rec['memory_s']:.3e}s "
              f"collective={rec['collective_s']:.3e}s "
              f"coll/chip={rec['collective_bytes_per_chip']:.3e}B "
              f"links={','.join(links)}", flush=True)


if __name__ == "__main__":
    main()

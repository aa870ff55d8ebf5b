"""Roofline terms for one NVIDIA H100.

The counterpart of :mod:`repro.launch.roofline`, with the card's
datasheet peaks in place of the TPU's.  Each is the NVIDIA H100 80GB HBM3
(SXM) datasheet figure at its full 700 W power limit; a card set below
it runs slower under load, so results stand beside the card's
``nvidia-smi`` power limit:

  * ``PEAK_FLOPS``      989 TFLOP/s, bf16 on the dense tensor cores
  * ``PEAK_FLOPS_FP32``  67 TFLOP/s, float32 outside the tensor cores
  * ``HBM_BW``          3.35 TB/s of HBM3
  * ``LINK_BW``          450 GB/s of NVLink a direction
  * ``NET_BW``            50 GB/s, one 400 Gb/s network port a card (the
                          DGX H100 layout: 8 cards a node, ``NODE_CARDS``)

The quantities are a card's own (a shard's work on its device):

  compute term    = flops_per_card / peak
  memory term     = bytes_per_card / HBM_BW
  collective term = collective_bytes_per_card / link rate

The link rate is the one term's value for the card, by this rule: the
cards of a mesh fill nodes of ``NODE_CARDS`` in the mesh's (row-major)
order, so card i sits in node i // 8.  A collective over some axes runs
in groups, the cards that differ only along those axes; when every group
lies within one node it moves over NVLink (``LINK_BW``), else over the
network (``NET_BW``), and a group of one card moves nothing.  On the
16 x 16 production mesh a ``"model"`` group is 16 consecutive cards, two
nodes, so both axes leave the node.  :func:`link_of` applies the rule,
:func:`collective_entry` records which rate each collective used, and
:func:`collective_seconds` sums their times.

``repro``'s ``parse_collectives`` reads the collectives of compiled XLA
HLO, which a PyTorch program does not have.  Its counterpart here,
:func:`collectives`, reads
:func:`repro_torch.distributed.sharding.collective_stats` (the mesh
collectives the port ran, bytes a shard, an all-reduce's operand counted
twice as ``repro`` counts it) and returns the same ``{kind: {count,
bytes}}`` shape.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional

import numpy as np

from repro_torch.distributed.sharding import COLLECTIVES, collective_stats
from repro_torch.launch.mesh import Mesh, axis_size

PEAK_FLOPS = 989e12        # bf16 dense tensor cores / card
PEAK_FLOPS_FP32 = 67e12    # float32 outside the tensor cores / card
HBM_BW = 3.35e12           # bytes/s / card
LINK_BW = 450e9            # bytes/s / card, NVLink, one direction
NET_BW = 50e9              # bytes/s / card, one 400 Gb/s port
NODE_CARDS = 8             # cards joined by NVLink in one node
LINK_RATES = {"nvlink": LINK_BW, "net": NET_BW}

_DTYPE_BYTES = {
    "bool": 1, "uint8": 1, "int8": 1, "float8_e4m3fn": 1, "float8_e5m2": 1,
    "int16": 2, "uint16": 2, "bfloat16": 2, "float16": 2,
    "int32": 4, "uint32": 4, "float32": 4, "int64": 8, "uint64": 8,
    "float64": 8, "complex64": 8, "complex128": 16,
}
_SHAPE_RE = re.compile(r"([a-z0-9_]+)\[([0-9,]*)\]")


def _shape_bytes(result: str) -> int:
    """Bytes of the shapes in ``result``, written ``dtype[d0,d1,...]`` with
    torch's dtype names (``bfloat16[2,3]``, or a tuple of them)."""
    total = 0
    for dtype, dims in _SHAPE_RE.findall(result):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def collectives(stats: Optional[Dict] = None) -> Dict[str, Dict[str, int]]:
    """Per-kind ``{count, bytes}`` of the mesh collectives: ``stats`` as
    ``collective_stats()`` returns it (read now when None)."""
    if stats is None:
        stats = collective_stats()
    return {k: {"count": int(stats.get(k, {}).get("count", 0)),
                "bytes": int(stats.get(k, {}).get("bytes", 0))}
            for k in COLLECTIVES}


def collective_bytes(stats: Optional[Dict] = None) -> int:
    return int(sum(v["bytes"] for v in collectives(stats).values()))


def link_of(mesh: Mesh, axes) -> str:
    """``"nvlink"``, ``"net"`` or ``"none"`` (a group of one card) for a
    collective over ``axes`` of ``mesh`` (see the module's rule)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if axis_size(mesh, axes) == 1:
        return "none"
    names = mesh.axis_names
    moved = [names.index(a) for a in axes]
    kept = [i for i in range(len(names)) if i not in moved]
    cards = np.arange(mesh.size).reshape(mesh.devices.shape)
    groups = cards.transpose(kept + moved).reshape(-1, axis_size(mesh, axes))
    nodes = groups // NODE_CARDS
    return "nvlink" if bool(np.all(nodes == nodes[:, :1])) else "net"


def collective_entry(mesh: Mesh, kind: str, axes, count: int,
                     n_bytes: int) -> Dict:
    """One planned collective: its kind, axes, count and bytes a card, and
    the link it uses with that link's rate (0 for a group of one)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    link = link_of(mesh, axes)
    return {"kind": kind, "axes": list(axes), "count": int(count),
            "bytes": int(n_bytes), "link": link,
            "rate": LINK_RATES.get(link, 0.0)}


def collective_seconds(entries: List[Dict]) -> float:
    """The collective term of planned ``entries``: each one's bytes over
    its link's rate."""
    return float(sum(e["bytes"] / e["rate"] for e in entries if e["rate"]))


def by_kind(entries: List[Dict]) -> Dict[str, Dict[str, int]]:
    """Planned ``entries`` summed into ``collective_stats()``'s
    ``{kind: {count, bytes}}`` shape."""
    out = {k: {"count": 0, "bytes": 0} for k in COLLECTIVES}
    for e in entries:
        out[e["kind"]]["count"] += e["count"]
        out[e["kind"]]["bytes"] += e["bytes"]
    return out


def roofline_terms(flops_per_card: float, bytes_per_card: float,
                   coll_bytes_per_card: float, *,
                   collective_s: Optional[float] = None,
                   peak: float = PEAK_FLOPS) -> Dict[str, float]:
    """The three terms, the one that dominates, and the roofline fraction
    (the compute term over the bound).  The compute term is at ``peak``
    (bf16 by default); the collective term is ``collective_s`` where a
    plan gives it (:func:`collective_seconds`), else the bytes over
    NVLink."""
    terms = {
        "compute_s": flops_per_card / peak,
        "memory_s": bytes_per_card / HBM_BW,
        "collective_s": (coll_bytes_per_card / LINK_BW
                         if collective_s is None else collective_s),
    }
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    terms["dominant"] = dom.replace("_s", "")
    terms["roofline_fraction"] = (terms["compute_s"] / bound
                                  if bound > 0 else 0.0)
    return terms


def model_flops(kind: str, n_params_active: int, tokens: int) -> float:
    """6ND for training (forward and backward), 2ND for inference."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_params_active * tokens


def format_table(rows: List[Dict], keys: List[str]) -> str:
    widths = [max(len(k), *(len(str(r.get(k, ""))) for r in rows))
              for k in keys]
    lines = [" | ".join(k.ljust(w) for k, w in zip(keys, widths)),
             "-|-".join("-" * w for w in widths)]
    for r in rows:
        lines.append(" | ".join(str(r.get(k, "")).ljust(w)
                                for k, w in zip(keys, widths)))
    return "\n".join(lines)

"""Seeded tabular tables, made on the device, and their quantile edges.

A frozen, benchmark-owned copy of the recipe of the port's
``data/synthetic.make_tabular``, rewritten in torch so that a 10 M-record
table is made on the card in a few large calls: normal numeric fields,
two-category indicator fields in one-hot groups (Covertype's 4 wilderness
areas and 40 soil types), and a label that is a random shallow-tree
function of six fields plus noise (binary: a Bernoulli of its sigmoid;
K classes: a draw from the softmax of K such functions).  The label
function's few constants come from a host generator; every large tensor
from a ``torch.Generator`` on the device.  The same seed gives the same
table on the same device.

The edges are the benchmark's input to binning, handed to the program
and to the reference alike: for a numeric field, the order statistics at
the ``max_bins - 1`` equal-count cut points, deduplicated.  They are
values of the float32 table, so float32 and float64 searches of them
agree.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

LABEL_FIELDS = 6          # fields the planted label function reads
NOISE = 0.1               # scale of the label function's noise


class Table(NamedTuple):
    X: torch.Tensor           # (n, F) float32 raw values
    y: torch.Tensor           # (n,) float32 labels (0/1, or 0..K-1)
    is_cat: np.ndarray        # (F,) bool: indicator fields


def n_fields(config: Dict) -> int:
    return int(config["n_numeric"]) + sum(config.get("onehot_groups", []))


def _label_rng(seed: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), 7919])


def device_generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return gen


def _planted(X: torch.Tensor, is_cat: np.ndarray, rng, picks) -> torch.Tensor:
    """One planted shallow-tree function of the ``picks`` fields."""
    margin = torch.zeros(X.shape[0], dtype=torch.float32, device=X.device)
    for f in picks:
        if is_cat[f]:
            vals = torch.as_tensor(rng.normal(size=2), dtype=torch.float32,
                                   device=X.device)
            margin += vals[X[:, f].long()]
        else:
            thr, lo, hi = rng.normal(size=3)
            margin += torch.where(X[:, f] > float(thr), float(hi), float(lo))
    return margin


def make_table(config: Dict, n: int, seed: int, device) -> Table:
    """The config's table of ``n`` records from ``seed`` on ``device``."""
    n_num = int(config["n_numeric"])
    groups = [int(s) for s in config.get("onehot_groups", [])]
    F = n_fields(config)
    K = int(config["train"].get("n_classes") or 1)
    gen = device_generator(seed, device)
    rng = _label_rng(seed)
    X = torch.empty((n, F), dtype=torch.float32, device=device)
    if n_num:
        X[:, :n_num] = torch.randn((n, n_num), generator=gen, device=device)
    col = n_num
    for size in groups:
        pick = torch.randint(0, size, (n, 1), generator=gen, device=device)
        X[:, col:col + size] = 0.0
        X[:, col:col + size].scatter_(1, pick, 1.0)
        col += size
    is_cat = np.zeros(F, dtype=bool)
    is_cat[n_num:] = True
    picks = rng.choice(F, size=min(F, LABEL_FIELDS), replace=False)
    if K == 1:
        margin = _planted(X, is_cat, rng, picks)
        wave = torch.sin(2.0 * X[:, picks[0]]) * (X[:, picks[-1]] > 0)
        margin += 0.5 * wave
        margin += NOISE * torch.randn(n, generator=gen, device=device)
        p = torch.sigmoid(margin)
        y = (torch.rand(n, generator=gen, device=device) < p).float()
    else:
        m = torch.stack([_planted(X, is_cat, rng, picks) for _ in range(K)],
                        dim=1)
        m = 2.0 * (m - m.mean(dim=0, keepdim=True))
        p = torch.softmax(m, dim=1)
        u = torch.rand((n, 1), generator=gen, device=device)
        y = (p.cumsum(dim=1) < u).sum(dim=1).clamp(max=K - 1).float()
    return Table(X, y, is_cat)


def quantile_edges(X: torch.Tensor, is_cat: np.ndarray, max_bins: int):
    """(edges (F, max_bins - 2) float64 padded with inf, n_value_bins (F,))
    for a ``Binner.from_arrays``: the order statistics of each numeric
    field at ``max_bins - 1`` equal-count cut points, deduplicated;
    indicator fields hold two categories."""
    n, F = X.shape
    n_value = max_bins - 1                  # the last code marks missing
    edges = np.full((F, n_value - 1), np.inf)
    nvb = np.zeros(F, dtype=np.int64)
    cut = (torch.arange(1, n_value, device=X.device, dtype=torch.float64)
           * (n / n_value)).long().clamp(max=n - 1)
    for f in range(F):
        if is_cat[f]:
            nvb[f] = 2
            continue
        col = torch.sort(X[:, f]).values
        e = np.unique(col[cut].double().cpu().numpy())
        edges[f, :e.size] = e
        nvb[f] = e.size + 1
    return edges, nvb

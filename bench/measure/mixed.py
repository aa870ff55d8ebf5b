"""Seeded tables of numeric and many-category fields with missing values,
made on the device, and their quantile edges.

A frozen, benchmark-owned copy of the recipe of the port's
``data/synthetic.make_tabular`` at a configuration's shape
(``n_numeric`` normal fields, then ``n_categorical`` fields uniform over
their ``n_categories`` categories, ``missing_rate`` of the values
missing), rewritten in torch so that a 10 M-record table is made on the
card in a few large calls.  The label is a random shallow-tree function
of six fields plus noise (a categorical field gives one value a
category): the margin itself for a regression objective, a Bernoulli of
its sigmoid for a binary one.  The missing values are drawn after the
label, over every field, so the label still depends on the values they
hide.  The label function's few constants come from a host generator;
every large tensor from a ``torch.Generator`` on the device.  The same
seed gives the same table on the same device.

The edges are the benchmark's input to binning, handed to the program
and to the reference alike: for a numeric field, the order statistics of
its non-missing values at the ``max_bins - 1`` equal-count cut points,
deduplicated; a categorical field holds its ``n_categories`` categories.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from bench.measure.data import (LABEL_FIELDS, NOISE, Table, _label_rng,
                                device_generator)

# the objectives whose labels the recipe makes, and the task of each
TASKS = {"reg:squarederror": "regression", "binary:logistic": "binary"}


def n_fields(config: Dict) -> int:
    return int(config["n_numeric"]) + int(config["n_categorical"])


def task(config: Dict) -> str:
    objective = config["train"]["objective"]
    if objective not in TASKS:
        raise SystemExit(f"the mixed-field table makes labels for "
                         f"{sorted(TASKS)}, not {objective!r}")
    return TASKS[objective]


def _planted(X: torch.Tensor, is_cat: np.ndarray, n_cats: int, rng,
             picks) -> torch.Tensor:
    """The planted shallow-tree function of the ``picks`` fields."""
    margin = torch.zeros(X.shape[0], dtype=torch.float32, device=X.device)
    for f in picks:
        if is_cat[f]:
            vals = torch.as_tensor(rng.normal(size=n_cats),
                                   dtype=torch.float32, device=X.device)
            margin += vals[X[:, f].long()]
        else:
            thr, lo, hi = rng.normal(size=3)
            margin += torch.where(X[:, f] > float(thr), float(hi), float(lo))
    return margin


def make_table(config: Dict, n: int, seed: int, device) -> Table:
    """The config's table of ``n`` records from ``seed`` on ``device``;
    NaN marks a missing value."""
    n_num, n_cat = int(config["n_numeric"]), int(config["n_categorical"])
    n_cats = int(config["n_categories"])
    kind = task(config)
    F = n_num + n_cat
    gen = device_generator(seed, device)
    rng = _label_rng(seed)
    X = torch.empty((n, F), dtype=torch.float32, device=device)
    if n_num:
        X[:, :n_num] = torch.randn((n, n_num), generator=gen, device=device)
    for f in range(n_num, F):          # a field at a time: int64 draws
        X[:, f] = torch.randint(0, n_cats, (n,), generator=gen,
                                device=device)
    is_cat = np.zeros(F, dtype=bool)
    is_cat[n_num:] = True
    picks = rng.choice(F, size=min(F, LABEL_FIELDS), replace=False)
    margin = _planted(X, is_cat, n_cats, rng, picks)
    margin += 0.5 * torch.sin(2.0 * X[:, picks[0]]) * (X[:, picks[-1]] > 0)
    margin += NOISE * torch.randn(n, generator=gen, device=device)
    if kind == "binary":
        y = (torch.rand(n, generator=gen, device=device)
             < torch.sigmoid(margin)).float()
    else:
        y = margin
    rate = float(config["missing_rate"])
    if rate > 0:
        for f in range(F):
            miss = torch.rand(n, generator=gen, device=device) < rate
            X[:, f].masked_fill_(miss, float("nan"))
    return Table(X, y, is_cat)


def quantile_edges(X: torch.Tensor, is_cat: np.ndarray, n_categories: int,
                   max_bins: int):
    """(edges (F, max_bins - 2) float64 padded with inf, n_value_bins (F,))
    for a ``Binner.from_arrays``: the order statistics of each numeric
    field's non-missing values at ``max_bins - 1`` equal-count cut points,
    deduplicated (one value bin where every value is missing);
    categorical fields hold ``n_categories`` categories."""
    F = X.shape[1]
    n_value = max_bins - 1                  # the last code marks missing
    if n_categories > n_value:
        raise SystemExit(f"{n_categories} categories exceed the {n_value} "
                         f"value bins of {max_bins} bins")
    edges = np.full((F, n_value - 1), np.inf)
    nvb = np.zeros(F, dtype=np.int64)
    steps = torch.arange(1, n_value, device=X.device, dtype=torch.float64)
    for f in range(F):
        if is_cat[f]:
            nvb[f] = n_categories
            continue
        col = X[:, f]
        col = torch.sort(col[~torch.isnan(col)]).values
        m = col.shape[0]
        if m == 0:
            nvb[f] = 1
            continue
        cut = (steps * (m / n_value)).long().clamp(max=m - 1)
        e = np.unique(col[cut].double().cpu().numpy())
        edges[f, :e.size] = e
        nvb[f] = e.size + 1
    return edges, nvb

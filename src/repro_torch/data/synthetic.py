"""Synthetic tabular datasets shaped like the paper's five benchmarks.

A numpy-only copy of the generator in :mod:`repro.data.synthetic` (the port
keeps its own copy and imports nothing of the JAX package): same field mix,
missing values and a planted tree-structured target, so the same seed gives
the same data in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    n_records: int           # scaled-down default (paper sizes in comments)
    n_numeric: int
    n_categorical: int
    n_cats: int              # categories per categorical field
    task: str                # "binary" | "regression"
    missing_rate: float
    comment: str


# paper Table III, record counts scaled 1000x down; ``scale`` or
# ``n_override`` restores the full size
PAPER_DATASETS = {
    "iot": DatasetSpec("iot", 7_000, 115, 0, 0, "binary", 0.0,
                       "Botnet attack detection (7M records full-scale)"),
    "higgs": DatasetSpec("higgs", 10_000, 28, 0, 0, "binary", 0.0,
                         "Exotic particle collider data (10M full-scale)"),
    "allstate": DatasetSpec("allstate", 10_000, 16, 16, 40, "regression",
                            0.05, "Insurance claims (10M; 16 categorical)"),
    "mq2008": DatasetSpec("mq2008", 1_000, 46, 0, 0, "regression", 0.0,
                          "Supervised ranking (1M full-scale)"),
    "flight": DatasetSpec("flight", 10_000, 1, 7, 95, "binary", 0.02,
                          "Flight delay prediction (10M; 7 categorical)"),
}


def make_tabular(n: int, n_numeric: int, n_categorical: int = 0,
                 n_cats: int = 8, task: str = "regression",
                 missing_rate: float = 0.0, seed: int = 0,
                 n_classes: int = 4,
                 ) -> Tuple[np.ndarray, np.ndarray, list]:
    """Returns (X, y, categorical_field_ids); NaN marks missing values.

    The target is a random shallow-tree function of a feature subset plus
    noise.  ``task="multiclass"`` draws integer labels 0..n_classes-1 from
    a per-class margin softmax.
    """
    rng = np.random.default_rng(seed)
    F = n_numeric + n_categorical
    X = np.empty((n, F), dtype=np.float64)
    X[:, :n_numeric] = rng.normal(size=(n, n_numeric))
    cat_ids = list(range(n_numeric, F))
    for f in cat_ids:
        X[:, f] = rng.integers(0, n_cats, size=n)

    # planted piecewise-constant target over a handful of fields
    margin = np.zeros(n)
    k = min(F, 6)
    picks = rng.choice(F, size=k, replace=False)
    for f in picks:
        if f in cat_ids:
            vals = rng.normal(size=n_cats)
            margin += vals[X[:, f].astype(int)]
        else:
            thr = rng.normal()
            margin += np.where(X[:, f] > thr, rng.normal(), rng.normal())
    margin += 0.5 * np.sin(X[:, picks[0]] * 2.0) * (X[:, picks[-1]] > 0)
    margin += 0.1 * rng.normal(size=n)

    if task == "binary":
        p = 1.0 / (1.0 + np.exp(-margin))
        y = (rng.uniform(size=n) < p).astype(np.float64)
    elif task == "multiclass":
        m = np.zeros((n, n_classes))
        for c in range(n_classes):
            for f in picks:
                if f in cat_ids:
                    vals = rng.normal(size=n_cats)
                    m[:, c] += vals[np.nan_to_num(X[:, f]).astype(int)]
                else:
                    thr = rng.normal()
                    m[:, c] += np.where(X[:, f] > thr, rng.normal(),
                                        rng.normal())
        m = 2.0 * (m - m.mean(axis=0, keepdims=True))
        z = np.exp(m - m.max(axis=1, keepdims=True))
        p = z / z.sum(axis=1, keepdims=True)
        y = (p.cumsum(axis=1) < rng.uniform(size=(n, 1))).sum(
            axis=1).astype(np.float64)
    else:
        y = margin

    if missing_rate > 0:
        miss = rng.uniform(size=X.shape) < missing_rate
        X[miss] = np.nan
    return X, y, cat_ids


def paper_dataset(name: str, scale: float = 1.0, seed: int = 0,
                  n_override: Optional[int] = None):
    """Instantiate a paper-benchmark analog; returns (X, y, cat_ids, spec)."""
    spec = PAPER_DATASETS[name]
    n = n_override if n_override is not None else int(spec.n_records * scale)
    X, y, cat_ids = make_tabular(
        n, spec.n_numeric, spec.n_categorical, max(spec.n_cats, 2),
        task=spec.task, missing_rate=spec.missing_rate, seed=seed)
    return X, y, cat_ids, spec

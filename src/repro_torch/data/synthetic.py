"""Synthetic tabular datasets shaped like the paper's five benchmarks.

A numpy-only copy of the generator in :mod:`repro.data.synthetic` (the port
keeps its own copy and imports nothing of the JAX package): same field mix,
missing values and a planted tree-structured target, so the same seed gives
the same data in both packages; :class:`SyntheticSource` streams such data
chunk by chunk, bit-equal under every chunking.
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


class SyntheticSource:
    """Deterministic larger-than-memory synthetic stream (DataSource).

    A planted piecewise-constant target is drawn ONCE at construction;
    feature rows are then (re)generated per fixed-size internal block from
    counter-based RNG streams, so every pass — and every chunking — yields
    bit-identical data without ever materializing the (n_rows, n_fields)
    matrix.  It is a ``data=`` source that can exceed device memory at will.
    """

    _BLOCK = 4096        # internal generation granularity (chunk-invariant)

    def __init__(self, n_rows: int, n_fields: int, task: str = "regression",
                 noise: float = 0.1, missing_rate: float = 0.0,
                 seed: int = 0):
        if task not in ("regression", "binary"):
            raise ValueError(f"unknown task {task!r}")
        self.n_rows, self._n_fields = int(n_rows), int(n_fields)
        self.task, self.noise, self.missing_rate = task, noise, missing_rate
        self.seed = seed
        rng = np.random.default_rng(seed)
        k = min(n_fields, 6)
        self._picks = rng.choice(n_fields, size=k, replace=False)
        self._thr = rng.normal(size=k)
        self._w_left = rng.normal(size=k)
        self._w_right = rng.normal(size=k)

    @property
    def n_fields(self) -> int:
        return self._n_fields

    def _block(self, b: int) -> Tuple[np.ndarray, np.ndarray]:
        lo = b * self._BLOCK
        rows = min(self._BLOCK, self.n_rows - lo)
        rng = np.random.default_rng([self.seed, 7919, b])
        X = rng.normal(size=(rows, self._n_fields))
        margin = np.zeros(rows)
        for j, f in enumerate(self._picks):
            margin += np.where(X[:, f] > self._thr[j], self._w_right[j],
                               self._w_left[j])
        margin += 0.5 * np.sin(2.0 * X[:, self._picks[0]]) * (
            X[:, self._picks[-1]] > 0)
        margin += self.noise * rng.normal(size=rows)
        if self.task == "binary":
            p = 1.0 / (1.0 + np.exp(-margin))
            y = (rng.uniform(size=rows) < p).astype(np.float64)
        else:
            y = margin
        if self.missing_rate > 0:
            miss = rng.uniform(size=X.shape) < self.missing_rate
            X[miss] = np.nan
        return X, y

    def chunks(self, rows: int):
        """Yield (X, y) chunks of ``rows`` rows, assembled from the fixed
        internal blocks so the stream is chunk-size invariant."""
        n_blocks = -(-self.n_rows // self._BLOCK)
        bx, by = [], []
        have = 0
        for b in range(n_blocks):
            X, y = self._block(b)
            bx.append(X)
            by.append(y)
            have += X.shape[0]
            while have >= rows:
                X_all = np.concatenate(bx) if len(bx) > 1 else bx[0]
                y_all = np.concatenate(by) if len(by) > 1 else by[0]
                yield X_all[:rows], y_all[:rows]
                bx, by = [X_all[rows:]], [y_all[rows:]]
                have -= rows
        if have > 0:
            yield (np.concatenate(bx) if len(bx) > 1 else bx[0],
                   np.concatenate(by) if len(by) > 1 else by[0])


def paper_dataset(name: str, scale: float = 1.0, seed: int = 0,
                  n_override: Optional[int] = None):
    """Instantiate a paper-benchmark analog; returns (X, y, cat_ids, spec)."""
    spec = PAPER_DATASETS[name]
    n = n_override if n_override is not None else int(spec.n_records * scale)
    X, y, cat_ids = make_tabular(
        n, spec.n_numeric, spec.n_categorical, max(spec.n_cats, 2),
        task=spec.task, missing_rate=spec.missing_rate, seed=seed)
    return X, y, cat_ids, spec

"""Offline pre-processing: quantile discretization into bin codes.

The counterpart of :mod:`repro.core.binning`.  ``Binner.fit`` and
``Binner.transform_codes`` are the same host numpy code, so both packages
produce bit-equal codes; ``transform_codes_device`` searches float32 edge
tables with ``torch.searchsorted``.

Bin-code conventions (per field, ``n_bins = max_bins`` total):
  * numeric field:  codes 0..n_value_bins-1 from quantile edges,
                    missing  -> code ``max_bins - 1``
  * categorical:    codes 0..n_categories-1,
                    missing/absent -> code ``max_bins - 1``

4-bit packed codes (``PackedCodes``) are not ported yet (ROADMAP Queue 1:
PackedCodes): codes are always stored as uint8, which every consumer reads
bit-equal to the packed layout.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.api.plan import resolve_device

_PACKED_TODO = ("4-bit PackedCodes are not ported yet (ROADMAP Queue 1: "
                "PackedCodes)")


@dataclasses.dataclass(frozen=True)
class BinnedDataset:
    """A pre-processed dataset: bin codes in the redundant dual layout.

    ``codes`` is the row-major (records, fields) uint8 copy consumed by
    histogram binning (step ①); ``codes_cm`` the (fields, records) copy
    consumed by partition (step ③) and the renumbered traversal (step ⑤).
    """

    codes: torch.Tensor          # (n, F) uint8 row-major
    codes_cm: torch.Tensor       # (F, n) uint8 column-major
    is_categorical: torch.Tensor  # (F,) bool
    n_bins: int                  # total bins per field incl. the missing bin
    bin_edges: np.ndarray        # (F, n_bins-2) float64 upper edges
    n_value_bins: np.ndarray     # (F,) int, live value bins per field

    @property
    def n_records(self) -> int:
        return self.codes.shape[0]

    @property
    def n_fields(self) -> int:
        return self.codes.shape[1]

    @property
    def missing_bin(self) -> int:
        return self.n_bins - 1

    def to(self, device) -> "BinnedDataset":
        """This dataset with its tensors on ``device`` (self if already)."""
        device = torch.device(device)
        if self.codes.device == device:
            return self
        return dataclasses.replace(
            self, codes=self.codes.to(device),
            codes_cm=self.codes_cm.to(device),
            is_categorical=self.is_categorical.to(device))


class Binner:
    """Quantile binner (fit on the host with numpy, apply with torch)."""

    def __init__(self, max_bins: int = 256,
                 categorical_fields: Optional[Sequence[int]] = None):
        if not (2 <= max_bins <= 256):
            raise ValueError("max_bins must be in [2, 256] for uint8 codes")
        self.max_bins = max_bins
        self.categorical_fields = frozenset(categorical_fields or ())
        self._edges: Optional[np.ndarray] = None
        self._is_cat: Optional[np.ndarray] = None
        self._n_value_bins: Optional[np.ndarray] = None

    @classmethod
    def from_arrays(cls, max_bins: int, edges, is_cat,
                    n_value_bins) -> "Binner":
        """A fitted binner from another binner's tables (for instance a
        fitted ``repro.core.binning.Binner``'s ``_edges``, ``_is_cat`` and
        ``_n_value_bins``)."""
        is_cat = np.asarray(is_cat, bool)
        binner = cls(max_bins, np.flatnonzero(is_cat).tolist())
        binner._edges = np.asarray(edges, np.float64)
        binner._is_cat = is_cat
        binner._n_value_bins = np.asarray(n_value_bins, np.int64)
        return binner

    # -- fit ---------------------------------------------------------------
    def fit(self, X: np.ndarray) -> "Binner":
        """Compute per-field quantile edges / category tables.

        ``X`` is (n, F) float; NaN marks a missing value.  Categorical fields
        must already hold small non-negative integer category ids.
        """
        X = np.asarray(X, dtype=np.float64)
        n, F = X.shape
        n_value_bins = self.max_bins - 1  # last code reserved for missing
        edges = np.full((F, n_value_bins - 1), np.inf, dtype=np.float64)
        is_cat = np.zeros((F,), dtype=bool)
        nvb = np.zeros((F,), dtype=np.int64)
        for f in range(F):
            col = X[:, f]
            valid = col[~np.isnan(col)]
            if f in self.categorical_fields:
                is_cat[f] = True
                ncat = int(valid.max()) + 1 if valid.size else 1
                if ncat > n_value_bins:
                    raise ValueError(
                        f"field {f}: {ncat} categories exceed {n_value_bins} "
                        "value bins; raise max_bins or re-map categories")
                nvb[f] = ncat
                continue
            if valid.size == 0:
                nvb[f] = 1
                continue
            qs = np.linspace(0.0, 1.0, n_value_bins + 1)[1:-1]
            e = np.unique(np.quantile(valid, qs))
            edges[f, : e.size] = e
            nvb[f] = e.size + 1
        self._edges, self._is_cat, self._n_value_bins = edges, is_cat, nvb
        return self

    # -- transform ----------------------------------------------------------
    def _require_fit(self) -> None:
        if self._edges is None:
            raise RuntimeError("Binner.fit must run before transform")

    def transform_codes(self, X: np.ndarray) -> np.ndarray:
        """Raw (n, F) uint8 bin codes on the host."""
        self._require_fit()
        X = np.asarray(X, dtype=np.float64)
        n, F = X.shape
        codes = np.zeros((n, F), dtype=np.uint8)
        missing_code = self.max_bins - 1
        for f in range(F):
            col = X[:, f]
            nan = np.isnan(col)
            if self._is_cat[f]:
                c = np.where(nan, 0, col).astype(np.int64)
                c = np.clip(c, 0, self._n_value_bins[f] - 1)
            else:
                c = np.searchsorted(self._edges[f], np.where(nan, 0.0, col),
                                    side="right")
            codes[:, f] = np.where(nan, missing_code, c).astype(np.uint8)
        return codes

    def transform_codes_device(self, X, device=None) -> torch.Tensor:
        """(n, F) uint8 bin codes computed on ``device`` (CUDA by default).

        ``X`` is searched against float32 copies of the edge tables.  Codes
        match :meth:`transform_codes` except for raw values whose float64
        and float32 roundings straddle a bin edge (distinct float64 values
        that collapse in float32).
        """
        self._require_fit()
        device = resolve_device(device)
        X = torch.as_tensor(X, dtype=torch.float32, device=device)
        edges = torch.as_tensor(self._edges, dtype=torch.float32,
                                device=device)
        is_cat = torch.as_tensor(self._is_cat, device=device)
        nvb = torch.as_tensor(self._n_value_bins, dtype=torch.int32,
                              device=device)
        nan = torch.isnan(X)
        filled = torch.where(nan, torch.zeros((), device=device), X)
        num = torch.searchsorted(edges, filled.T.contiguous(),
                                 right=True).T.to(torch.int32)      # (n, F)
        cat = torch.minimum(filled.to(torch.int32).clamp(min=0),
                            nvb[None, :] - 1)
        codes = torch.where(is_cat[None, :], cat, num)
        return torch.where(nan, self.max_bins - 1, codes).to(torch.uint8)

    def transform(self, X: np.ndarray, packed: Optional[bool] = None,
                  device=None) -> BinnedDataset:
        """Binned dataset in the redundant dual layout on ``device`` (CUDA
        by default).  ``packed=True`` raises: 4-bit packing is not ported;
        ``None`` and ``False`` store uint8."""
        if packed:
            raise NotImplementedError(_PACKED_TODO)
        device = resolve_device(device)
        return _dataset(self.transform_codes(X), self._is_cat, self.max_bins,
                        self._edges, self._n_value_bins, device)


def _dataset(codes_np: np.ndarray, is_cat, n_bins: int, edges, nvb,
             device: torch.device) -> BinnedDataset:
    """Ship host codes to ``device`` and build the column-major twin
    there."""
    codes = torch.from_numpy(np.ascontiguousarray(codes_np, np.uint8)).to(
        device)
    return BinnedDataset(codes=codes, codes_cm=codes.T.contiguous(),
                         is_categorical=torch.as_tensor(
                             np.asarray(is_cat, bool), device=device),
                         n_bins=n_bins, bin_edges=edges, n_value_bins=nvb)


def bin_dataset(X: np.ndarray, max_bins: int = 256,
                categorical_fields: Optional[Sequence[int]] = None,
                packed: Optional[bool] = None, device=None) -> BinnedDataset:
    return Binner(max_bins, categorical_fields).fit(X).transform(
        X, packed=packed, device=device)


def dataset_from_codes(codes, is_categorical=None, n_bins: int = 256,
                       packed: Optional[bool] = None,
                       device=None) -> BinnedDataset:
    """Wrap pre-binned integer codes (tests / synthetic data) as a dataset."""
    if packed:
        raise NotImplementedError(_PACKED_TODO)
    codes_np = np.asarray(codes, dtype=np.uint8)
    F = codes_np.shape[1]
    if is_categorical is None:
        is_categorical = np.zeros((F,), dtype=bool)
    return _dataset(codes_np, is_categorical, n_bins,
                    np.zeros((F, n_bins - 2)), np.full((F,), n_bins - 1),
                    resolve_device(device))

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

When the bin count fits a nibble (``n_bins <= 16``) both copies of the
dual layout are stored as :class:`PackedCodes`, two 4-bit codes per byte
(paper §III-B's compressed representation); every consumer reads them
bit-equal to the uint8 layout.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.api.plan import resolve_device

# --------------------------------------------------------------------------
# 4-bit packed codes.  Two bin codes per byte along the LAST axis whenever
# the bin count fits a nibble: the low nibble holds the even index, the high
# nibble the odd one; an odd-length axis carries one zero pad nibble.
# Packing is lossless, so every consumer stays bit-equal to the uint8 path.
# --------------------------------------------------------------------------
PACK_MAX_BINS = 16      # nibble capacity: codes 0..15


def pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """Pack integer codes <= 15 two-per-byte along the last axis, on the
    tensor's device: (..., n) -> (..., ceil(n/2)) uint8, contiguous."""
    codes = codes.to(torch.uint8)
    if codes.shape[-1] % 2:
        codes = torch.nn.functional.pad(codes, (0, 1))
    return (codes[..., 0::2] | (codes[..., 1::2] << 4)).contiguous()


def unpack_nibbles(data: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_nibbles`: (..., ceil(n/2)) -> (..., n)."""
    full = torch.stack([data & 0xF, data >> 4], dim=-1)
    return full.reshape(data.shape[:-1] + (-1,))[..., :n].contiguous()


def pack_nibbles_np(codes: np.ndarray) -> np.ndarray:
    """Host (numpy) twin of :func:`pack_nibbles`."""
    codes = np.ascontiguousarray(codes, np.uint8)
    if codes.shape[-1] % 2:
        pad = [(0, 0)] * (codes.ndim - 1) + [(0, 1)]
        codes = np.pad(codes, pad)
    return codes[..., 0::2] | (codes[..., 1::2] << 4)


@dataclasses.dataclass(frozen=True)
class PackedCodes:
    """4-bit bin codes, two per byte along the last axis.

    ``data`` holds the packed bytes (..., ceil(n/2)) and ``n`` the logical
    last-axis length.  Leading-axis indexing (``pc[idx]``) selects rows
    without unpacking: the packed axis is the last one in both layouts
    (row-major packs fields, column-major packs records).
    """

    data: torch.Tensor   # (..., ceil(n/2)) uint8 packed bytes
    n: int               # logical last-axis length
    bits: int = 4

    @property
    def shape(self) -> torch.Size:
        return torch.Size(self.data.shape[:-1] + (self.n,))

    @property
    def ndim(self) -> int:
        return self.data.ndim

    @property
    def dtype(self) -> torch.dtype:
        return torch.uint8

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def nbytes(self) -> int:
        return self.data.numel()        # uint8: 1 byte per element

    def unpack(self) -> torch.Tensor:
        return unpack_nibbles(self.data, self.n)

    def __getitem__(self, idx) -> "PackedCodes":
        """Leading-axis selection; the packed last axis is never indexed."""
        return PackedCodes(self.data[idx], self.n, self.bits)

    def __array__(self, dtype=None, copy=None):
        """numpy conversion yields the UNPACKED logical matrix, so
        ``np.asarray(codes)`` reads the same either layout."""
        out = self.unpack().cpu().numpy()
        return out if dtype is None else out.astype(dtype)

    def to(self, device) -> "PackedCodes":
        return PackedCodes(self.data.to(device), self.n, self.bits)

    @classmethod
    def pack(cls, codes: torch.Tensor) -> "PackedCodes":
        """Pack a (..., n) code tensor on its device."""
        return cls(pack_nibbles(codes), int(codes.shape[-1]))

    @classmethod
    def pack_np(cls, codes: np.ndarray) -> "PackedCodes":
        """Pack on the host; the bytes stay on the CPU until ``to``."""
        codes = np.asarray(codes, np.uint8)
        return cls(torch.from_numpy(pack_nibbles_np(codes)),
                   int(codes.shape[-1]))


def as_unpacked(codes) -> torch.Tensor:
    """``codes`` as a plain (..., n) uint8 tensor, whatever the layout."""
    if isinstance(codes, PackedCodes):
        return codes.unpack()
    return codes


@dataclasses.dataclass(frozen=True)
class BinnedDataset:
    """A pre-processed dataset: bin codes in the redundant dual layout.

    ``codes`` is the row-major (records, fields) copy consumed by histogram
    binning (step ①); ``codes_cm`` the (fields, records) copy consumed by
    partition (step ③) and the renumbered traversal (step ⑤).  When
    ``n_bins <= 16`` both are :class:`PackedCodes`.
    """

    codes: torch.Tensor          # (n, F) uint8, or PackedCodes over F
    codes_cm: torch.Tensor       # (F, n) uint8, or PackedCodes over n
    is_categorical: torch.Tensor  # (F,) bool
    n_bins: int                  # total bins per field incl. the missing bin
    bin_edges: np.ndarray        # (F, n_bins-2) float64 upper edges
    n_value_bins: np.ndarray     # (F,) int, live value bins per field

    @property
    def n_records(self) -> int:
        return self.codes.shape[0]      # the logical shape, packed or not

    @property
    def n_fields(self) -> int:
        return self.codes.shape[1]

    @property
    def missing_bin(self) -> int:
        return self.n_bins - 1

    def to(self, device) -> "BinnedDataset":
        """This dataset with its tensors, packed copies included, on
        ``device`` (self if already)."""
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
        by default).

        ``packed=None`` (auto) bit-packs both copies whenever the codes fit
        a nibble (``max_bins <= 16``); ``False`` forces plain uint8, and
        ``True`` requires packing (``ValueError`` above 16 bins).
        """
        device = resolve_device(device)
        rm, cm = _dual_layout(self.transform_codes(X), self.max_bins, packed,
                              device)
        return BinnedDataset(codes=rm, codes_cm=cm,
                             is_categorical=torch.as_tensor(self._is_cat,
                                                            device=device),
                             n_bins=self.max_bins, bin_edges=self._edges,
                             n_value_bins=self._n_value_bins)


def _dual_layout(codes_np: np.ndarray, n_bins: int, packed: Optional[bool],
                 device: torch.device):
    """Ship host codes to ``device`` and build the (row-major, column-major)
    pair there, bit-packing both copies when the bin count fits a
    nibble."""
    if packed is None:
        packed = n_bins <= PACK_MAX_BINS
    if packed and n_bins > PACK_MAX_BINS:
        raise ValueError(
            f"packed codes need n_bins <= {PACK_MAX_BINS}, got {n_bins}")
    codes = torch.from_numpy(np.ascontiguousarray(codes_np, np.uint8)).to(
        device)
    if packed:
        return PackedCodes.pack(codes), PackedCodes.pack(codes.T)
    return codes, codes.T.contiguous()


def bin_dataset(X: np.ndarray, max_bins: int = 256,
                categorical_fields: Optional[Sequence[int]] = None,
                packed: Optional[bool] = None, device=None) -> BinnedDataset:
    return Binner(max_bins, categorical_fields).fit(X).transform(
        X, packed=packed, device=device)


def dataset_from_codes(codes, is_categorical=None, n_bins: int = 256,
                       packed: Optional[bool] = None,
                       device=None) -> BinnedDataset:
    """Wrap pre-binned integer codes (tests / synthetic data) as a dataset;
    ``packed`` as in :meth:`Binner.transform`."""
    device = resolve_device(device)
    codes_np = np.asarray(codes, dtype=np.uint8)
    F = codes_np.shape[1]
    if is_categorical is None:
        is_categorical = np.zeros((F,), dtype=bool)
    rm, cm = _dual_layout(codes_np, n_bins, packed, device)
    return BinnedDataset(codes=rm, codes_cm=cm,
                         is_categorical=torch.as_tensor(
                             np.asarray(is_categorical, bool), device=device),
                         n_bins=n_bins, bin_edges=np.zeros((F, n_bins - 2)),
                         n_value_bins=np.full((F,), n_bins - 1))

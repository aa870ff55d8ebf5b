"""Offline pre-processing: quantile discretization into bin codes.

The counterpart of :mod:`repro.core.binning`.  ``Binner.fit`` and
``Binner.transform_codes`` are the same host numpy code, so both packages
produce bit-equal codes; ``transform_codes_device`` searches float32 edge
tables with ``torch.searchsorted`` (the serving path), and
``transform_chunk`` bins a streamed chunk on its device against float64
edge tables, bit-equal to ``transform_codes``.  :class:`StreamingBinner`
fits the same tables from quantile sketches over a chunked source.

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

from repro_torch import obs
from repro_torch.api.plan import resolve_device

# --------------------------------------------------------------------------
# 4-bit packed codes.  Two bin codes per byte along the LAST axis whenever
# the bin count fits a nibble: the low nibble holds the even index, the high
# nibble the odd one; an odd-length axis carries one zero pad nibble.
# Packing is lossless, so every consumer stays bit-equal to the uint8 path.
# --------------------------------------------------------------------------
PACK_MAX_BINS = 16      # nibble capacity: codes 0..15
UNPACK_SPAN = "codes.unpack"    # the span of every unpack of PackedCodes
# rows of a streamed chunk that ``transform_chunk`` casts to float64 at once
_BIN_BLOCK_BYTES = 1 << 25


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
        """The plain (..., n) uint8 codes; every unpack of packed codes
        (``as_unpacked``, ``np.asarray``, a field gather) passes here and
        is one ``codes.unpack`` span."""
        with obs.span(UNPACK_SPAN):
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
    binning (step ①) and traversal (step ⑤, prediction); ``codes_cm`` the
    (fields, records) copy consumed by partition (step ③).  When
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

    def _device_tables(self, device: torch.device):
        """The edge and category tables on ``device``, kept per fit and
        device: the lookup state of :meth:`transform_codes_device`, sent
        once instead of once a request."""
        cached = self.__dict__.get("_dev_tables")
        if cached is None or cached[0] is not self._edges \
                or cached[1] != device:
            tables = (torch.as_tensor(self._edges, dtype=torch.float32,
                                      device=device),
                      torch.as_tensor(self._is_cat, device=device),
                      torch.as_tensor(self._n_value_bins, dtype=torch.int32,
                                      device=device))
            self._dev_tables = cached = (self._edges, device, tables)
        return cached[2]

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
        edges, is_cat, nvb = self._device_tables(device)
        nan = torch.isnan(X)
        filled = torch.where(nan, torch.zeros((), device=device), X)
        num = torch.searchsorted(edges, filled.T.contiguous(),
                                 right=True).T.to(torch.int32)      # (n, F)
        cat = torch.minimum(filled.to(torch.int32).clamp(min=0),
                            nvb[None, :] - 1)
        codes = torch.where(is_cat[None, :], cat, num)
        return torch.where(nan, self.max_bins - 1, codes).to(torch.uint8)

    def _exact_tables(self, device: torch.device):
        """float64 edges, categorical flags and value-bin counts on
        ``device``, kept per fit and device (the lookup state of
        :meth:`transform_chunk`)."""
        cached = self.__dict__.get("_exact")
        if cached is None or cached[0] is not self._edges \
                or cached[1] != device:
            tables = (torch.as_tensor(self._edges, dtype=torch.float64,
                                      device=device).contiguous(),
                      torch.as_tensor(self._is_cat, device=device),
                      torch.as_tensor(self._n_value_bins, dtype=torch.float64,
                                      device=device))
            self._exact = cached = (self._edges, device, tables)
        return cached[2]

    def transform_chunk(self, X: torch.Tensor) -> torch.Tensor:
        """(n, F) uint8 bin codes of the raw chunk ``X`` (a float tensor, in
        the source's own dtype), computed on ``X``'s device and bit-equal to
        :meth:`transform_codes`.

        Values are cast exactly to float64 and searched in float64 edge
        tables, as the host does; float32 tables (``transform_codes_device``)
        would misplace a value that lies between an edge and its float32
        rounding.  Categorical values truncate toward zero and clip to the
        field's categories, with the host cast's rule for values no int64
        holds (NaN, ±inf and |x| >= 2^63 become INT64_MIN, so category 0).
        The float64 temporaries cover ``_BIN_BLOCK_BYTES`` of rows at a
        time, so a chunk's footprint stays its raw floats and its codes.
        """
        self._require_fit()
        n, F = X.shape
        edges, is_cat, nvb = self._exact_tables(X.device)
        out = torch.empty((n, F), dtype=torch.uint8, device=X.device)
        rows = max(1, _BIN_BLOCK_BYTES // (8 * max(F, 1)))
        for lo in range(0, n, rows):
            x = X[lo:lo + rows].to(torch.float64)
            nan = torch.isnan(x)
            x = torch.where(nan, 0.0, x)
            if edges.shape[1]:
                num = torch.searchsorted(edges, x.T.contiguous(), right=True,
                                         out_int32=True).T
            else:
                num = torch.zeros(x.shape, dtype=torch.int32,
                                  device=x.device)
            cat = torch.where(x < 2.0 ** 63, torch.trunc(x).clamp(min=0.0),
                              0.0)
            cat = torch.minimum(cat, nvb - 1.0).to(torch.int32)
            codes = torch.where(is_cat, cat, num)
            out[lo:lo + rows] = torch.where(nan, self.max_bins - 1,
                                            codes).to(torch.uint8)
        return out

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


class _QuantileSketch:
    """Bounded-memory weighted quantile summary (merge and compress), the
    numpy code of ``repro``'s.

    Values are buffered verbatim until ``capacity`` is exceeded; then the
    summary is compressed to ``capacity`` support points evenly spaced by
    cumulative weight.  While uncompressed the summary is exact:
    ``quantiles`` reproduces ``np.quantile`` of the whole stream bit for
    bit.
    """

    __slots__ = ("capacity", "values", "weights", "exact", "_buf")

    def __init__(self, capacity: int):
        if capacity < 8:
            raise ValueError("sketch capacity must be >= 8")
        self.capacity = capacity
        self.values = np.empty((0,), np.float64)
        self.weights = np.empty((0,), np.float64)
        self.exact = True
        self._buf: list = []

    @property
    def n_support(self) -> int:
        return self.values.size + sum(b.size for b in self._buf)

    def update(self, vals: np.ndarray) -> None:
        if vals.size == 0:
            return
        self._buf.append(np.asarray(vals, np.float64))
        if self.n_support > 2 * self.capacity:
            self._compress()

    def _flush(self) -> None:
        if self._buf:
            self.values = np.concatenate([self.values] + self._buf)
            self.weights = np.concatenate(
                [self.weights] + [np.ones((b.size,)) for b in self._buf])
            self._buf = []

    def _compress(self) -> None:
        self._flush()
        if self.values.size <= self.capacity:
            return
        order = np.argsort(self.values, kind="stable")
        v, w = self.values[order], self.weights[order]
        total = float(w.sum())
        mid = np.cumsum(w) - 0.5 * w          # midpoint cumulative weight
        pts = (np.arange(self.capacity) + 0.5) / self.capacity * total
        self.values = np.interp(pts, mid, v)
        self.weights = np.full((self.capacity,), total / self.capacity)
        self.exact = False

    def quantiles(self, qs: np.ndarray) -> np.ndarray:
        """Quantile estimates; exact (``np.quantile``) when uncompressed."""
        self._flush()
        if self.values.size == 0:
            return np.empty((0,), np.float64)
        if self.exact:
            return np.quantile(self.values, qs)
        order = np.argsort(self.values, kind="stable")
        v, w = self.values[order], self.weights[order]
        total = float(w.sum())
        mid = (np.cumsum(w) - 0.5 * w) / total
        return np.interp(qs, mid, v)


class StreamingBinner(Binner):
    """Out-of-core binner: quantile sketches over a stream of chunks.

    A drop-in for :class:`Binner` when ``X`` cannot be materialized: feed
    chunks through ``partial_fit`` (or a whole
    :class:`repro_torch.data.DataSource` through ``fit_source``), then
    ``finalize`` computes the edge and category tables ``Binner.fit``
    produces; every transform is inherited.  For streams no longer than
    ``sketch_size`` the sketch never compresses and the edges are
    bit-identical to ``Binner.fit`` on the concatenated stream; beyond it
    they are approximate quantiles with bounded summary error.
    """

    def __init__(self, max_bins: int = 256,
                 categorical_fields: Optional[Sequence[int]] = None,
                 sketch_size: int = 32768):
        super().__init__(max_bins, categorical_fields)
        self.sketch_size = sketch_size
        self._sketches: Optional[list] = None
        self._cat_max: Optional[np.ndarray] = None
        self._n_seen = 0

    @property
    def n_rows_seen(self) -> int:
        return self._n_seen

    def _reset(self) -> None:
        """Start a fresh stream: ``fit``/``fit_source`` recompute, as
        ``Binner.fit`` does, and do not accumulate."""
        self._sketches, self._cat_max, self._n_seen = None, None, 0

    def partial_fit(self, X_chunk: np.ndarray) -> "StreamingBinner":
        X = np.asarray(X_chunk, dtype=np.float64)
        if X.ndim != 2:
            raise ValueError("partial_fit expects a 2-D (rows, fields) chunk")
        n, F = X.shape
        if self._sketches is None:
            self._sketches = [None if f in self.categorical_fields
                              else _QuantileSketch(self.sketch_size)
                              for f in range(F)]
            self._cat_max = np.full((F,), -1, np.int64)
        elif len(self._sketches) != F:
            raise ValueError(
                f"chunk has {F} fields; earlier chunks had "
                f"{len(self._sketches)}")
        self._n_seen += n
        for f in range(F):
            col = X[:, f]
            valid = col[~np.isnan(col)]
            if self._sketches[f] is None:      # categorical: track max id
                if valid.size:
                    self._cat_max[f] = max(self._cat_max[f],
                                           int(valid.max()))
            else:
                self._sketches[f].update(valid)
        return self

    def finalize(self) -> "StreamingBinner":
        """Turn the accumulated sketches into ``Binner``'s tables."""
        if self._sketches is None:
            raise RuntimeError("finalize called before any partial_fit")
        F = len(self._sketches)
        n_value_bins = self.max_bins - 1
        edges = np.full((F, n_value_bins - 1), np.inf, dtype=np.float64)
        is_cat = np.zeros((F,), dtype=bool)
        nvb = np.zeros((F,), dtype=np.int64)
        qs = np.linspace(0.0, 1.0, n_value_bins + 1)[1:-1]
        for f in range(F):
            sk = self._sketches[f]
            if sk is None:
                is_cat[f] = True
                ncat = int(self._cat_max[f]) + 1 if self._cat_max[f] >= 0 \
                    else 1
                if ncat > n_value_bins:
                    raise ValueError(
                        f"field {f}: {ncat} categories exceed {n_value_bins} "
                        "value bins; raise max_bins or re-map categories")
                nvb[f] = ncat
                continue
            q = sk.quantiles(qs)
            if q.size == 0:
                nvb[f] = 1
                continue
            e = np.unique(q)
            edges[f, : e.size] = e
            nvb[f] = e.size + 1
        self._edges, self._is_cat, self._n_value_bins = edges, is_cat, nvb
        return self

    def fit(self, X: np.ndarray) -> "StreamingBinner":
        """Sketch the whole matrix, then finalize; like ``Binner.fit``,
        refitting recomputes from scratch."""
        self._reset()
        return self.partial_fit(X).finalize()

    def fit_source(self, source, chunk_rows: int) -> "StreamingBinner":
        """Sketch every chunk of a :class:`repro_torch.data.DataSource` (a
        fresh fit; accumulate across calls with ``partial_fit``)."""
        self._reset()
        for X_chunk, _ in source.chunks(chunk_rows):
            self.partial_fit(X_chunk)
        return self.finalize()


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

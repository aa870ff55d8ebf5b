"""Chunked data sources and the prefetching record stream.

The counterpart of :mod:`repro.data.pipeline`: the out-of-core path and
the LM substrate's synthetic token stream (:func:`token_batches`).

The :class:`DataSource` protocol is the out-of-core entry point: anything
that can re-iterate ``(X_chunk, y_chunk)`` numpy pairs feeds the streaming
trainer (:func:`repro_torch.core.gbdt.train_streaming`) and the sketch
binner (:class:`repro_torch.core.binning.StreamingBinner`) without the full
matrix ever being materialized.  Three implementations ship here and in
:mod:`repro_torch.data.synthetic`: in-memory arrays, a directory of npz
shards (raw or binned, verified against a crc32 manifest) and a
deterministic synthetic generator.  Shards and manifests are the files
``repro`` writes and reads.

:class:`PrefetchIterator` keeps ``depth`` batches in flight on a worker
thread.  ``repro`` places each batch with ``device_put`` (under optional
shardings); on one card the port takes a ``device`` instead: the worker
stages each array in a pinned host buffer (a ring of ``depth + 1``) and
uploads it on a copy stream, so batch i + 1 crosses to the card while
batch i is consumed.
"""
from __future__ import annotations

import contextlib
import dataclasses
import glob
import io
import json
import os
import queue
import threading
import zlib
from typing import (Iterable, Iterator, Optional, Protocol, Tuple,
                    runtime_checkable)

import numpy as np
import torch

from repro_torch.resilience.errors import ShardCorruptionError

MANIFEST_NAME = "manifest.json"


# --------------------------------------------------------------------------
# shard integrity: crc32 sidecar manifest
# --------------------------------------------------------------------------
def write_shard_manifest(directory: str, paths: Iterable[str]) -> str:
    """Write ``manifest.json`` next to the shards: per-shard crc32 and byte
    count, keyed by basename.  The shard sources verify every read against
    it, so bit-rot or a torn write surfaces as :class:`ShardCorruptionError`
    instead of feeding garbage into a fit."""
    shards = {}
    for path in paths:
        with open(path, "rb") as f:
            data = f.read()
        shards[os.path.basename(path)] = {
            "crc32": zlib.crc32(data) & 0xFFFFFFFF,
            "bytes": len(data),
        }
    manifest_path = os.path.join(directory, MANIFEST_NAME)
    tmp = manifest_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"version": 1, "shards": shards}, f, indent=1)
    os.replace(tmp, manifest_path)
    return manifest_path


def _load_manifest(directory: str) -> Optional[dict]:
    """The shard table from ``manifest.json``, or None when the directory
    predates checksumming (verification is then skipped)."""
    path = os.path.join(directory, MANIFEST_NAME)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)["shards"]
    except (OSError, json.JSONDecodeError, KeyError) as e:
        raise ShardCorruptionError(
            f"unreadable shard manifest {path!r}: {e}") from e


def _open_verified(path: str, manifest: Optional[dict]):
    """``np.load`` the shard, crc32-verified against the manifest when one
    exists.  The file is read once and loaded from the verified bytes, so
    the checked bytes are the loaded bytes."""
    if manifest is None:
        return np.load(path)
    entry = manifest.get(os.path.basename(path))
    if entry is None:
        raise ShardCorruptionError(
            f"shard {path!r} is not in the directory manifest — stale or "
            "foreign file; re-export the shard directory")
    with open(path, "rb") as f:
        data = f.read()
    if len(data) != entry["bytes"] or \
            (zlib.crc32(data) & 0xFFFFFFFF) != entry["crc32"]:
        raise ShardCorruptionError(
            f"shard {path!r} failed crc32 verification "
            f"({len(data)} bytes vs {entry['bytes']} expected) — the file "
            "was corrupted after export; re-stage it")
    return np.load(io.BytesIO(data))


# --------------------------------------------------------------------------
# chunked data sources (the out-of-core record stream)
# --------------------------------------------------------------------------
@runtime_checkable
class DataSource(Protocol):
    """A re-iterable chunked dataset: raw float features and labels.

    ``chunks(rows)`` yields ``(X_chunk, y_chunk)`` numpy pairs, ``X_chunk``
    of shape (<= rows, n_fields) float (NaN == missing) and ``y_chunk`` the
    aligned labels (or ``None`` for an unlabeled source).  The iterator
    must be restartable — streaming training makes one pass per tree level
    — and successive passes must yield identical chunks in identical order.
    """

    @property
    def n_fields(self) -> int: ...

    def chunks(self, rows: int
               ) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray]]]: ...


@dataclasses.dataclass
class ArraySource:
    """In-memory (X, y) pair presented through the DataSource protocol;
    chunks are views, no copy."""

    X: np.ndarray
    y: Optional[np.ndarray] = None

    def __post_init__(self):
        self.X = np.asarray(self.X)
        if self.X.ndim != 2:
            raise ValueError("ArraySource expects a 2-D feature matrix")
        if self.y is not None:
            self.y = np.asarray(self.y)
            if self.y.shape[0] != self.X.shape[0]:
                raise ValueError(
                    f"X has {self.X.shape[0]} rows but y has "
                    f"{self.y.shape[0]}")

    @property
    def n_rows(self) -> int:
        return self.X.shape[0]

    @property
    def n_fields(self) -> int:
        return self.X.shape[1]

    def chunks(self, rows: int):
        for lo in range(0, self.X.shape[0], rows):
            hi = min(lo + rows, self.X.shape[0])
            yield (self.X[lo:hi],
                   self.y[lo:hi] if self.y is not None else None)


class NpzShardSource:
    """A directory of ``*.npz`` shards, each holding ``X`` (and optionally
    ``y``).  One shard is resident at a time; shards are re-sliced to the
    requested chunk size, so shard and chunk boundaries need not align.
    Write shards with :func:`write_npz_shards`."""

    def __init__(self, directory: str, x_key: str = "X", y_key: str = "y",
                 verify: bool = True):
        self.directory = str(directory)
        self.x_key, self.y_key = x_key, y_key
        self.paths = sorted(glob.glob(os.path.join(self.directory, "*.npz")))
        if not self.paths:
            raise FileNotFoundError(f"no .npz shards under {directory!r}")
        self.manifest = _load_manifest(self.directory) if verify else None
        with _open_verified(self.paths[0], self.manifest) as z:
            if x_key not in z:
                raise KeyError(f"shard {self.paths[0]!r} has no {x_key!r} "
                               f"array (found {sorted(z.files)})")
            self._n_fields = int(z[x_key].shape[1])

    @property
    def n_fields(self) -> int:
        return self._n_fields

    def chunks(self, rows: int):
        for path in self.paths:
            with _open_verified(path, self.manifest) as z:
                if self.x_key not in z:
                    raise KeyError(
                        f"shard {path!r} has no {self.x_key!r} array "
                        f"(found {sorted(z.files)})")
                X = z[self.x_key]
                y = z[self.y_key] if self.y_key in z.files else None
            if X.ndim != 2 or X.shape[1] != self._n_fields:
                raise ValueError(
                    f"shard {path!r} has X of shape {X.shape}; expected "
                    f"(*, {self._n_fields}) to match the first shard — "
                    "mixed-width shard directories cannot feed one model")
            if y is not None and y.shape[0] != X.shape[0]:
                raise ValueError(
                    f"shard {path!r} has {X.shape[0]} rows of X but "
                    f"{y.shape[0]} labels")
            for lo in range(0, X.shape[0], rows):
                hi = min(lo + rows, X.shape[0])
                yield X[lo:hi], (y[lo:hi] if y is not None else None)


def _clear_shards(directory: str) -> None:
    """The directory is the dataset (sources glob every shard), so a
    shorter re-export must not leave stale shards mixed in."""
    os.makedirs(directory, exist_ok=True)
    for stale in glob.glob(os.path.join(directory, "*.npz")):
        os.remove(stale)


def write_npz_shards(directory: str, source: "DataSource",
                     rows_per_shard: int = 65536) -> list:
    """Materialize a DataSource as a directory of npz shards and return the
    shard paths: the inverse of :class:`NpzShardSource`, used to stage a
    generator-backed dataset onto disk once, then train out-of-core.
    Existing ``*.npz`` files are removed first; a crc32 ``manifest.json`` is
    written last."""
    _clear_shards(directory)
    paths = []
    for i, (X, y) in enumerate(source.chunks(rows_per_shard)):
        path = os.path.join(directory, f"shard_{i:05d}.npz")
        arrays = {"X": np.asarray(X)}
        if y is not None:
            arrays["y"] = np.asarray(y)
        np.savez(path, **arrays)
        paths.append(path)
    write_shard_manifest(directory, paths)
    return paths


def write_binned_shards(directory: str, source: "DataSource", binner,
                        rows_per_shard: int = 65536,
                        packed: Optional[bool] = None) -> list:
    """Bin a DataSource through a fitted binner (on the host) and stage the
    code matrix as npz shards: the compressed working set staged once (paper
    §III-B).  With ``packed`` (default: ``binner.max_bins <= 16``) the codes
    are 4-bit packed, half the bytes of uint8.  Shard keys: ``codes``,
    ``rows`` (logical records), ``n_fields``, ``packed`` and optional ``y``,
    as ``repro`` writes them.  Read back with :class:`BinnedShardSource`."""
    from repro_torch.core.binning import PACK_MAX_BINS, pack_nibbles_np
    if packed is None:
        packed = binner.max_bins <= PACK_MAX_BINS
    elif packed and binner.max_bins > PACK_MAX_BINS:
        raise ValueError(
            f"4-bit packing requires max_bins <= {PACK_MAX_BINS}; "
            f"binner has {binner.max_bins}")
    _clear_shards(directory)
    paths = []
    for i, (X, y) in enumerate(source.chunks(rows_per_shard)):
        codes = binner.transform_codes(np.asarray(X))
        arrays = {
            "codes": pack_nibbles_np(codes) if packed else codes,
            "rows": np.int64(codes.shape[0]),
            "n_fields": np.int64(codes.shape[1]),
            "packed": np.bool_(packed),
        }
        if y is not None:
            arrays["y"] = np.asarray(y)
        path = os.path.join(directory, f"binned_{i:05d}.npz")
        np.savez(path, **arrays)
        paths.append(path)
    write_shard_manifest(directory, paths)
    return paths


class BinnedShardSource:
    """Chunked stream over shards written by :func:`write_binned_shards`.

    ``chunks(rows)`` yields ``(codes, y)``: ``codes`` a host
    :class:`repro_torch.core.binning.PackedCodes` when the shards were
    written packed, else a uint8 array.  Packed shards are sliced without
    unpacking: packing is row-major, so a row slice of the logical matrix
    is a row slice of the packed bytes.
    """

    def __init__(self, directory: str, verify: bool = True):
        self.directory = str(directory)
        self.paths = sorted(glob.glob(
            os.path.join(self.directory, "binned_*.npz")))
        if not self.paths:
            raise FileNotFoundError(
                f"no binned_*.npz shards under {directory!r}")
        self.manifest = _load_manifest(self.directory) if verify else None
        with _open_verified(self.paths[0], self.manifest) as z:
            self._n_fields = int(z["n_fields"])
            self.packed = bool(z["packed"])

    @property
    def n_fields(self) -> int:
        return self._n_fields

    def chunks(self, rows: int):
        from repro_torch.core.binning import PackedCodes
        for path in self.paths:
            with _open_verified(path, self.manifest) as z:
                if int(z["n_fields"]) != self._n_fields or \
                        bool(z["packed"]) != self.packed:
                    raise ValueError(
                        f"shard {path!r} has n_fields={int(z['n_fields'])} "
                        f"packed={bool(z['packed'])}; expected "
                        f"n_fields={self._n_fields} packed={self.packed}")
                codes = z["codes"]
                n = int(z["rows"])
                y = z["y"] if "y" in z.files else None
            for lo in range(0, n, rows):
                hi = min(lo + rows, n)
                chunk = (PackedCodes(torch.from_numpy(codes[lo:hi]),
                                     self._n_fields)
                         if self.packed else codes[lo:hi])
                yield chunk, (y[lo:hi] if y is not None else None)


def as_source(data) -> "DataSource":
    """Coerce ``fit(data=...)`` inputs: a DataSource passes through, an
    ``(X, y)`` tuple wraps as :class:`ArraySource`, a string or path opens
    an :class:`NpzShardSource` directory."""
    if isinstance(data, (str, os.PathLike)):
        return NpzShardSource(data)
    if isinstance(data, tuple) and len(data) == 2:
        return ArraySource(*data)
    if isinstance(data, DataSource):
        return data
    raise TypeError(
        f"cannot build a DataSource from {type(data).__name__}; pass a "
        "DataSource, an (X, y) tuple, or an npz-shard directory path")


def token_batches(rng: np.random.Generator, vocab: int, batch: int,
                  seq: int, n_batches: int) -> Iterator[dict]:
    """Synthetic LM token stream (tokens/labels shifted by one), as numpy
    int32: the arrays ``repro``'s stream draws from the same generator."""
    for _ in range(n_batches):
        seqs = rng.integers(0, vocab, (batch, seq + 1), dtype=np.int64)
        yield {"tokens": seqs[:, :-1].astype(np.int32),
               "labels": seqs[:, 1:].astype(np.int32)}


def record_shards(codes: np.ndarray, g: np.ndarray, h: np.ndarray,
                  shard_size: int) -> Iterator[dict]:
    """Stream record blocks of a GBDT dataset (the step-① input stream)."""
    n = codes.shape[0]
    for lo in range(0, n, shard_size):
        hi = min(lo + shard_size, n)
        yield {"codes": codes[lo:hi], "g": g[lo:hi], "h": h[lo:hi]}


# --------------------------------------------------------------------------
# prefetch: a worker thread keeps batches in flight
# --------------------------------------------------------------------------
def _tree_map(fn, batch, path=()):
    """``fn(path, leaf)`` over the leaves of nested dicts, lists and
    tuples."""
    if isinstance(batch, dict):
        return {k: _tree_map(fn, v, path + (k,)) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        out = [_tree_map(fn, v, path + (i,)) for i, v in enumerate(batch)]
        return type(batch)(out)
    return fn(path, batch)


class _PinnedSlot:
    """One slot of the staging ring: a pinned host buffer per array leaf
    and the event that marks the end of the slot's last upload."""

    def __init__(self):
        self.buffers = {}
        self.event: Optional[torch.cuda.Event] = None

    def stage(self, path, array: np.ndarray, stream) -> torch.Tensor:
        """Copy ``array`` into this slot's pinned buffer for ``path`` (grown
        when too small) and enqueue its upload on ``stream``."""
        src = torch.from_numpy(np.ascontiguousarray(array))
        buf = self.buffers.get(path)
        if buf is None or buf.dtype != src.dtype \
                or buf.numel() < src.numel():
            buf = torch.empty((src.numel(),), dtype=src.dtype,
                              pin_memory=True)
            self.buffers[path] = buf
        host = buf[:src.numel()].view(src.shape)
        host.copy_(src)
        with torch.cuda.stream(stream):
            return host.to(stream.device, non_blocking=True)


class PrefetchIterator:
    """Wrap a host batch generator; keep ``depth`` batches in flight.

    Without a ``device`` batches pass through as the generator yields them.
    With a CPU ``device`` numpy leaves become tensors (no copy).  With a
    CUDA ``device`` the worker copies every numpy leaf into a pinned host
    buffer — a ring of ``depth + 1`` slots, a slot reused only after its
    last upload's event has completed — and uploads it on a copy stream;
    :meth:`__next__` makes the consumer's current stream wait on the
    batch's upload event and ``record_stream``s each tensor on it, so the
    caching allocator cannot hand the memory out while the consumer still
    reads it.  ``repro``'s ``shardings`` (a JAX placement) has no meaning
    on one card; ``device`` takes its place.

    The worker blocks once ``depth`` batches are staged, so a consumer that
    abandons the iterator early would leave it parked: call :meth:`close`
    — or use the iterator as a context manager — on every early exit.  It
    stops the worker, drains staged batches and closes the generator, so
    its ``finally`` blocks run.
    """

    def __init__(self, gen: Iterator, device=None, depth: int = 2):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self._gen = gen
        self._device = None if device is None else torch.device(device)
        self.depth = depth
        self._cuda = self._device is not None and self._device.type == "cuda"
        self._stream = (torch.cuda.Stream(self._device) if self._cuda
                        else None)
        self._ring = ([_PinnedSlot() for _ in range(depth + 1)]
                      if self._cuda else [])
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _place(self, batch, index: int):
        """The batch as the consumer receives it, and the event its uploads
        end with (None off the card)."""
        if self._device is None:
            return batch, None
        if not self._cuda:
            return _tree_map(lambda _, a: torch.as_tensor(a)
                             if isinstance(a, np.ndarray) else a,
                             batch), None
        slot = self._ring[index % len(self._ring)]
        if slot.event is not None:
            slot.event.synchronize()       # its last upload has landed

        def stage(path, leaf):
            if isinstance(leaf, np.ndarray):
                return slot.stage(path, leaf, self._stream)
            return leaf

        placed = _tree_map(stage, batch)
        slot.event = torch.cuda.Event()
        slot.event.record(self._stream)
        return placed, slot.event

    def _worker(self):
        try:
            ctx = (torch.cuda.device(self._device) if self._cuda
                   else contextlib.nullcontext())
            with ctx:
                for i, batch in enumerate(self._gen):
                    if self._stop.is_set():
                        break
                    self._q.put(self._place(batch, i))
                    if self._stop.is_set():
                        break
        except BaseException as e:  # noqa: BLE001 — surfaced on next()
            self._err = e
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            if self._err is not None:
                raise self._err
            raise StopIteration
        batch, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(event)

            def adopt(_, leaf):
                if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
                    leaf.record_stream(stream)
                return leaf

            _tree_map(adopt, batch)
        return batch

    def close(self):
        """Stop the worker and release staged batches.  Idempotent; safe
        after normal exhaustion too."""
        self._stop.set()
        # drain so a put-blocked worker wakes, sees the stop flag and exits
        while self._thread.is_alive():
            try:
                self._q.get(timeout=0.1)
            except queue.Empty:
                continue
        while True:     # leftovers, the sentinel included, so buffers free
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        close = getattr(self._gen, "close", None)
        if close is not None:
            close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

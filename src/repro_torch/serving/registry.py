"""Multi-model tenancy: named ensembles with hot swap and no recapture.

The counterpart of :mod:`repro.serving.registry`.  A
:class:`ModelRegistry` keeps N named :class:`~repro_torch.core.inference.
GBDTPipeline` bundles resident at once, each with its OWN
:class:`~repro_torch.core.inference.PredictCache`: captured graphs are
keyed per model *name*, so tenants never share a graph's buffers and
``unpublish`` frees exactly one tenant's graphs.

Hot-swap contract (``publish`` on a name already published): the cache
survives the swap.  A graph's trees live in static buffers that a request
refills when another version last used them, so a new version in the same
shape buckets (depth, class count, missing bin, ``bucket_trees`` tree
bucket and field count) replays every warm graph as it is: no capture.
Where the buckets differ, ``publish`` warms the new version over every
row bucket the old one served *before* swapping the entry, so the
captures happen off the serving path, and requests keep reaching the old
version until the swap, which is atomic under the registry lock.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set

import numpy as np

from repro_torch.api.plan import ExecutionPlan, resolve_plan
from repro_torch.core.inference import GBDTPipeline, PredictCache


def _as_pipeline(model, device=None) -> GBDTPipeline:
    """Coerce a publishable object: a bundle directory path (of either
    package; loaded onto ``device``), an estimator (anything exposing
    ``to_pipeline()``), or a ready pipeline."""
    if isinstance(model, str):
        from repro_torch.api.serialize import load
        model = load(model, device=device)
    if isinstance(model, GBDTPipeline):
        return model
    to_pipeline = getattr(model, "to_pipeline", None)
    if callable(to_pipeline):
        return to_pipeline()
    raise TypeError(
        f"cannot publish {type(model).__name__!r}: expected a bundle "
        "directory path, a fitted estimator, or a GBDTPipeline")


class _Entry:
    """One resident model version + its private graph cache."""

    __slots__ = ("pipeline", "cache", "version", "seen_buckets")

    def __init__(self, pipeline: GBDTPipeline, cache: PredictCache,
                 version: int, seen_buckets: Set[int]):
        self.pipeline = pipeline
        self.cache = cache
        self.version = version
        self.seen_buckets = seen_buckets     # row buckets served/warmed


class ModelRegistry:
    """Named, hot-swappable ensembles behind one predict plan.

    ``plan`` is resolved once, here; every lookup, warm-up and serve path
    reuses it.  ``device`` is where a published bundle path is loaded
    (CUDA by default); a published pipeline or estimator stays where its
    model lies.
    """

    def __init__(self, plan: Optional[ExecutionPlan] = None, device=None):
        self.plan = resolve_plan(plan)
        self.device = device
        self._lock = threading.Lock()
        self._entries: Dict[str, _Entry] = {}

    # -- tenancy ------------------------------------------------------------
    def publish(self, name: str, model, *, warm: bool = True) -> int:
        """Make ``model`` the live version under ``name``; returns the new
        version number (1 for a first publish).

        Replacing an existing name keeps its :class:`PredictCache`, and
        (with ``warm=True``) runs the new version through every row bucket
        the old one served before the atomic swap.
        """
        pipeline = _as_pipeline(model, self.device)
        with self._lock:
            old = self._entries.get(name)
            cache = old.cache if old is not None else PredictCache()
            version = old.version + 1 if old is not None else 1
            seen = set(old.seen_buckets) if old is not None else set()
        if warm and seen:
            self._warm(pipeline, cache, sorted(seen))
        with self._lock:
            self._entries[name] = _Entry(pipeline, cache, version, seen)
        return version

    def unpublish(self, name: str) -> None:
        """Drop a tenant and free its captured graphs."""
        with self._lock:
            entry = self._entries.pop(name, None)
        if entry is None:
            raise KeyError(name)
        entry.cache.clear()

    def entry(self, name: str) -> _Entry:
        with self._lock:
            try:
                return self._entries[name]
            except KeyError:
                raise KeyError(
                    f"no model published under {name!r} "
                    f"(published: {sorted(self._entries)})") from None

    def pipeline(self, name: str) -> GBDTPipeline:
        return self.entry(name).pipeline

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._entries)

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._entries

    # -- warmup ---------------------------------------------------------------
    def _warm(self, pipeline: GBDTPipeline, cache: PredictCache,
              buckets) -> None:
        """Capture ``pipeline``'s graphs for the given row buckets (zero
        batches: only shapes matter to the cache)."""
        F = pipeline.model.n_fields
        for b in buckets:
            pipeline.predict_margin(np.zeros((int(b), F), np.float32),
                                    plan=self.plan, mode="cached",
                                    cache=cache).cpu()

    def warm(self, name: str, buckets) -> None:
        """Warm the live version of ``name`` over explicit row buckets."""
        entry = self.entry(name)
        self._warm(entry.pipeline, entry.cache, buckets)
        entry.seen_buckets.update(int(b) for b in buckets)

    # -- observability ------------------------------------------------------
    def stats(self) -> Dict[str, Dict]:
        """Per-model view: live version + graph-cache counters."""
        with self._lock:
            entries = dict(self._entries)
        return {name: {"version": e.version,
                       "cache": e.cache.stats(),
                       "warm_buckets": sorted(e.seen_buckets)}
                for name, e in entries.items()}

"""One serialization story for every GBDT artifact (npz + json meta).

The counterpart of :mod:`repro.api.serialize`, writing the same
``repro-gbdt-bundle`` v1 format (the same array names and meta), so a
bundle written by either package loads in the other.  A *bundle* is a
directory holding ``arrays.npz`` (slash-named arrays) and
``manifest.json`` (meta + a sha256 of the payload), written with the
checkpoint layer's two-phase atomic commit.  One format covers:

  * a bare :class:`~repro_torch.core.gbdt.GBDTModel`     (arrays + model meta)
  * a :class:`~repro_torch.core.inference.GBDTPipeline`  (+ binner state)
  * a fitted estimator of :mod:`repro_torch.api.estimator` (+ its params)

:func:`save` / :func:`load` write and read a standalone bundle;
:func:`save_checkpoint` / :func:`load_checkpoint` ride
:func:`repro_torch.distributed.checkpoint.save_named` (atomic rename,
sha256 verification, ``keep_last``, fallback past a corrupt step).  The
loaders take ``device=``, where the model's tensors go (CUDA by default).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.api.plan import resolve_device
from repro_torch.core.binning import Binner
from repro_torch.core.gbdt import GBDTModel, model_from_meta
from repro_torch.core.inference import GBDTPipeline
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.kernels.ref import TreeArrays

FORMAT = "repro-gbdt-bundle"
VERSION = 1
# runtime choices, not model state: a bundle never carries them
RUNTIME_PARAMS = ("plan", "device")


# --------------------------------------------------------------------------
# pack / unpack — the canonical in-memory form
# --------------------------------------------------------------------------
def _pack_parts(model: GBDTModel, binner: Optional[Binner] = None,
                estimator_meta: Optional[Dict] = None
                ) -> Tuple[Dict[str, np.ndarray], Dict]:
    arrays = {f"model/trees/{k}": v.cpu().numpy()
              for k, v in model.trees._asdict().items()}
    meta: Dict[str, Any] = {
        "format": FORMAT, "version": VERSION,
        "model": model.meta(),
    }
    if binner is not None:
        arrays["binner/edges"] = np.asarray(binner._edges)
        arrays["binner/is_cat"] = np.asarray(binner._is_cat)
        arrays["binner/n_value_bins"] = np.asarray(binner._n_value_bins)
        meta["binner"] = {
            "max_bins": int(binner.max_bins),
            "categorical_fields": sorted(int(c)
                                         for c in binner.categorical_fields),
        }
    if estimator_meta is not None:
        meta["estimator"] = estimator_meta
    return arrays, meta


def pack(obj: Any) -> Tuple[Dict[str, np.ndarray], Dict]:
    """Decompose a model / pipeline / fitted estimator into the canonical
    ``(arrays, meta)`` pair (arrays npz-able, meta pure JSON)."""
    from repro_torch.api.estimator import BoosterEstimator  # import cycle
    if isinstance(obj, BoosterEstimator):
        return obj._pack()
    if isinstance(obj, GBDTPipeline):
        return _pack_parts(obj.model, obj.binner)
    if isinstance(obj, GBDTModel):
        return _pack_parts(obj)
    raise TypeError(f"cannot serialize {type(obj).__name__}; expected a "
                    "GBDTModel, GBDTPipeline, or fitted estimator")


def _unpack_model(arrays: Dict[str, np.ndarray], meta: Dict,
                  device: torch.device) -> GBDTModel:
    trees = TreeArrays(**{f: torch.as_tensor(arrays[f"model/trees/{f}"],
                                             device=device)
                          for f in TreeArrays._fields})
    return model_from_meta(trees, meta["model"])


def _unpack_binner(arrays: Dict[str, np.ndarray], meta: Dict) -> Binner:
    b = Binner(int(meta["binner"]["max_bins"]),
               [int(c) for c in meta["binner"]["categorical_fields"]])
    b._edges = np.asarray(arrays["binner/edges"])
    b._is_cat = np.asarray(arrays["binner/is_cat"])
    b._n_value_bins = np.asarray(arrays["binner/n_value_bins"])
    return b


def unpack(arrays: Dict[str, np.ndarray], meta: Dict, device=None) -> Any:
    """Rebuild the richest artifact the payload describes: an estimator
    when its params are present, else a pipeline when the binner is, else
    the bare model; its tensors on ``device`` (CUDA by default)."""
    if meta.get("format") != FORMAT:
        raise ValueError(f"not a {FORMAT} payload: "
                         f"format={meta.get('format')!r}")
    device = resolve_device(device)
    model = _unpack_model(arrays, meta, device)
    binner = _unpack_binner(arrays, meta) if "binner" in meta else None
    if "estimator" in meta:
        from repro_torch.api.estimator import BoosterEstimator
        if binner is None:
            raise ValueError("estimator payload is missing its binner state")
        return BoosterEstimator._from_parts(meta["estimator"], model, binner,
                                            device)
    if binner is not None:
        return GBDTPipeline(binner=binner, model=model)
    return model


# --------------------------------------------------------------------------
# standalone bundles — save(path) / load(path)
# --------------------------------------------------------------------------
def save(path: str, obj: Any) -> str:
    """Atomically write ``obj`` as a bundle directory at ``path``."""
    arrays, meta = pack(obj)
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    return ckpt.write_payload_dir(os.path.abspath(path), arrays,
                                  {"names": sorted(arrays), "meta": meta})


def load(path: str, device=None) -> Any:
    """Load a bundle written by either package's ``save`` (sha256-
    verified), its tensors on ``device`` (CUDA by default)."""
    manifest = ckpt.validate_payload_dir(path)
    if manifest is None:
        raise FileNotFoundError(f"no valid bundle at {path!r}")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {k: z[k] for k in manifest["names"]}
    return unpack(arrays, manifest["meta"], device)


# --------------------------------------------------------------------------
# step checkpoints — the fault-tolerant training flow
# --------------------------------------------------------------------------
def save_checkpoint(directory: str, obj: Any, step: int, *,
                    keep_last: int = 3) -> str:
    """Checkpoint ``obj`` under ``directory/step_<k>`` (atomic, GC'd)."""
    arrays, meta = pack(obj)
    return ckpt.save_named(directory, arrays, step, keep_last=keep_last,
                           extra_meta=meta)


def load_checkpoint(directory: str, *, step: Optional[int] = None,
                    device=None) -> Tuple[Any, int]:
    """Restore the newest valid step checkpoint; returns ``(obj, step)``."""
    arrays, s, meta = ckpt.restore_named(directory, step=step)
    return unpack(arrays, meta, device), s


def has_checkpoint(directory: str) -> bool:
    return bool(ckpt.list_steps(directory))


def _json_safe(value: Any) -> Any:
    """Coerce estimator params to JSON-stable types (sequences of
    categorical field ids become int lists, numpy scalars python)."""
    if isinstance(value, (list, tuple, np.ndarray, frozenset, set)):
        return sorted(int(v) for v in value)
    if isinstance(value, np.generic):
        return value.item()
    return value


def estimator_params_to_meta(params: Dict[str, Any]) -> Dict[str, Any]:
    """The params a bundle carries: all but the runtime choices (``plan``,
    ``device``), which ``repro``'s estimator would refuse as unknown."""
    out = {k: _json_safe(v) for k, v in params.items()
           if k not in RUNTIME_PARAMS}
    json.dumps(out)  # fail fast on anything non-serializable
    return out

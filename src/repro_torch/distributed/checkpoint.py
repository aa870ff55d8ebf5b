"""Atomic, content-verified checkpoints of named array payloads.

The counterpart of the named-payload half of
:mod:`repro.distributed.checkpoint`, in the same on-disk format, so either
package reads what the other wrote.  Layout per step:
``<dir>/step_<k>/arrays.npz + manifest.json``.

  * two-phase commit: write into ``step_<k>.tmp``, fsync, atomic rename;
    a crash mid-write never corrupts the latest valid checkpoint;
  * the manifest stores a sha256 of the array payload; restore verifies it
    and skips a torn or corrupt step, falling back to the next-newest;
  * ``keep_last`` bounds disk usage.

Two payload kinds share the layout: named payloads (:func:`save_named`,
:func:`restore_named`), which restore self-describing, and positional
ones (:func:`save`, :func:`restore`), whose leaves are stored as
``leaf_00000``, ``leaf_00001``, ... in the order ``jax.tree_util`` flattens
a nested state (dict keys sorted, lists, tuples and named tuples in
order, ``None`` holding no leaf), so that a ``like`` state of either
package restores what the other wrote.  A restored state lands on any
device, or on the devices of a changed mesh: the elastic path.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import re
import shutil
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_STEP_RE = re.compile(r"^step_(\d+)$")


def write_payload_dir(path: str, arrays: Dict[str, np.ndarray],
                      manifest: Dict) -> str:
    """Two-phase atomic write of ``arrays.npz`` + ``manifest.json`` at
    ``path``: write into ``path.tmp``, fsync, atomic rename.  The payload
    sha256 is stamped into the manifest.  Shared by step checkpoints and
    the model bundles of :mod:`repro_torch.api.serialize`."""
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    payload = buf.getvalue()
    manifest = dict(manifest, sha256=hashlib.sha256(payload).hexdigest())

    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)  # atomic commit
    return path


def _leaves(state: Any) -> List[Any]:
    """The leaves of a nested state in ``jax.tree_util``'s order."""
    if state is None:
        return []
    if isinstance(state, dict):
        return [x for k in sorted(state) for x in _leaves(state[k])]
    if isinstance(state, (list, tuple)):
        return [x for v in state for x in _leaves(v)]
    return [state]


def _rebuild(like: Any, leaves) -> Any:
    """``like``'s structure with its leaves taken from the iterator
    ``leaves`` (numpy arrays), each converted to its ``like`` leaf's kind:
    a tensor on that tensor's device, a Python scalar or string, or an
    array."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        kids = [_rebuild(v, leaves) for v in like]
        return type(like)(*kids) if hasattr(like, "_fields") \
            else type(like)(kids)
    arr = next(leaves)
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(arr, device=like.device)
    if isinstance(like, (bool, int, float, str)):
        return type(like)(arr.item())
    return arr


def save(directory: str, state: Any, step: int, *,
         keep_last: int = 3, extra_meta: Optional[Dict] = None) -> str:
    """Two-phase atomic write of a nested state's leaves, positionally
    (``leaf_<i>``, ``repro``'s format); returns the step's path."""
    arrays = {f"leaf_{i:05d}": (x.detach().cpu().numpy()
                                if isinstance(x, torch.Tensor)
                                else np.asarray(x))
              for i, x in enumerate(_leaves(state))}
    os.makedirs(directory, exist_ok=True)
    final = write_payload_dir(
        os.path.join(directory, f"step_{step}"), arrays,
        {"step": step, "n_leaves": len(arrays), "meta": extra_meta or {}})
    _gc(directory, keep_last)
    return final


def restore(directory: str, like: Any, *, step: Optional[int] = None,
            device=None) -> Tuple[Any, int, Dict]:
    """Restore the newest valid positional checkpoint (or an explicit
    ``step``) into ``like``'s structure: ``(state, step, meta)``.  Tensor
    leaves land on ``like``'s devices, or on ``device`` (one device, or a
    structure like ``like``'s: a changed mesh's devices)."""
    steps = list_steps(directory)
    if step is not None:
        steps = [s for s in steps if s == step]
    n_like = len(_leaves(like))
    for s in reversed(steps):
        path = os.path.join(directory, f"step_{s}")
        manifest = _validate(path)
        if manifest is None:
            continue  # corrupt or partial: fall back to an older step
        if manifest["n_leaves"] != n_like:
            raise ValueError(f"checkpoint step_{s} under {directory!r} "
                             f"holds {manifest['n_leaves']} leaves; the "
                             f"like state has {n_like}")
        try:
            with np.load(os.path.join(path, "arrays.npz")) as z:
                arrays = [z[f"leaf_{i:05d}"]
                          for i in range(manifest["n_leaves"])]
        except Exception as e:  # noqa: BLE001 — torn step, use next-newest
            warnings.warn(
                f"checkpoint step_{s} under {directory!r} passed sha "
                f"validation but failed to load ({type(e).__name__}: {e}); "
                "falling back to the next-newest step", RuntimeWarning)
            continue
        state = _rebuild(like, iter(arrays))
        if device is not None:
            from repro_torch.distributed.elastic import reshard_tree
            state = reshard_tree(state, device)
        return state, s, manifest["meta"]
    raise FileNotFoundError(f"no valid checkpoint under {directory!r}")


def save_named(directory: str, arrays: Dict[str, np.ndarray], step: int, *,
               keep_last: int = 3, extra_meta: Optional[Dict] = None) -> str:
    """Checkpoint a flat ``{name: array}`` dict with its names preserved,
    as ``directory/step_<step>``; keeps the newest ``keep_last`` steps."""
    os.makedirs(directory, exist_ok=True)
    final = write_payload_dir(
        os.path.join(directory, f"step_{step}"), arrays,
        {"step": step, "n_leaves": len(arrays),
         "names": sorted(arrays), "meta": extra_meta or {}})
    _gc(directory, keep_last)
    return final


def _gc(directory: str, keep_last: int) -> None:
    steps = list_steps(directory)
    for s in steps[:-keep_last]:
        shutil.rmtree(os.path.join(directory, f"step_{s}"),
                      ignore_errors=True)


def list_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = _STEP_RE.match(name)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def _validate(path: str) -> Optional[Dict]:
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with open(os.path.join(path, "arrays.npz"), "rb") as f:
            payload = f.read()
        if hashlib.sha256(payload).hexdigest() != manifest["sha256"]:
            return None
        return manifest
    except (OSError, json.JSONDecodeError, KeyError):
        return None


def validate_payload_dir(path: str) -> Optional[Dict]:
    """The manifest of the payload at ``path`` if its sha256 holds, else
    None."""
    return _validate(path)


def restore_named(directory: str, *, step: Optional[int] = None
                  ) -> Tuple[Dict[str, np.ndarray], int, Dict]:
    """Restore the newest valid named checkpoint (or an explicit
    ``step``) as ``({name: array}, step, meta)``."""
    steps = list_steps(directory)
    if step is not None:
        steps = [s for s in steps if s == step]
    for s in reversed(steps):
        path = os.path.join(directory, f"step_{s}")
        manifest = _validate(path)
        if manifest is None or "names" not in manifest:
            continue  # corrupt, partial or positional: fall back to older
        try:
            with np.load(os.path.join(path, "arrays.npz")) as z:
                arrays = {k: z[k] for k in manifest["names"]}
        except Exception as e:  # noqa: BLE001 — torn step, use next-newest
            warnings.warn(
                f"checkpoint step_{s} under {directory!r} passed sha "
                f"validation but failed to load ({type(e).__name__}: {e}); "
                "falling back to the next-newest step", RuntimeWarning)
            continue
        return arrays, s, manifest["meta"]
    raise FileNotFoundError(f"no valid named checkpoint under {directory!r}")

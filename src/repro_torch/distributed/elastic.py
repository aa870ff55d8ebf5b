"""Elastic scaling: re-mesh live training state onto a changed device set.

The counterpart of :mod:`repro.distributed.elastic`.  A shrink (a worker
lost) or grow (capacity arrived) event gives a new device list; the
largest usable (data x model) mesh is rebuilt from it and tensors are
re-placed on the new mesh's devices.  Training state and checkpoints do
not depend on the mesh, so shrink -> restore -> grow round-trips are
exact.  :func:`~repro_torch.distributed.trainer.train_distributed` does
this inside a fit; :class:`ElasticContext` is the same bookkeeping for a
caller's own loop.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import torch

from repro_torch.launch.mesh import Mesh, cuda_devices, make_mesh


def largest_mesh_shape(n_devices: int, model_parallel: int
                       ) -> Tuple[int, int]:
    """The largest (data, model) grid on at most ``n_devices`` devices at a
    fixed model width: the workload fixes the field sharding, so
    elasticity moves along the data axis."""
    if n_devices < model_parallel:
        raise ValueError(
            f"need ≥ {model_parallel} devices for model_parallel="
            f"{model_parallel}, have {n_devices}")
    return n_devices // model_parallel, model_parallel


def remesh(devices: Sequence, model_parallel: int) -> Mesh:
    """The largest (data, model) mesh on the surviving devices."""
    d, m = largest_mesh_shape(len(devices), model_parallel)
    return make_mesh((d, m), ("data", "model"), devices=list(devices)[:d * m])


def reshard_tree(state: Any, devices: Any) -> Any:
    """Tensors of a nested ``state`` (dicts, lists, tuples, named tuples)
    moved onto ``devices``: one device for every tensor, or a structure
    like ``state``'s holding a device per tensor.  Other leaves pass as
    they are."""
    per_leaf = isinstance(devices, (dict, list, tuple))
    if isinstance(state, torch.Tensor):
        return state.to(torch.device(devices))
    if isinstance(state, dict):
        return {k: reshard_tree(v, devices[k] if per_leaf else devices)
                for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        kids = [reshard_tree(v, devices[i] if per_leaf else devices)
                for i, v in enumerate(state)]
        return type(state)(*kids) if hasattr(state, "_fields") \
            else type(state)(kids)
    return state


class ElasticContext:
    """Tracks the live mesh; ``resize`` rebuilds it from a device list.

        ctx = ElasticContext(model_parallel=2, devices=["cpu"] * 8)
        mesh = ctx.mesh                          # (4, 2)
        mesh = ctx.resize(survivors)             # after a failure
        state = reshard_tree(state, ctx.owner)   # re-place tensors
    """

    def __init__(self, model_parallel: int,
                 devices: Optional[List] = None):
        self.model_parallel = model_parallel
        self.devices = list(devices) if devices else cuda_devices()
        self.mesh = remesh(self.devices, model_parallel)

    def resize(self, devices: Sequence) -> Mesh:
        self.devices = list(devices)
        self.mesh = remesh(self.devices, self.model_parallel)
        return self.mesh

    @property
    def owner(self) -> torch.device:
        """The mesh's first device, where replicated state lives."""
        return self.mesh.devices.flat[0]

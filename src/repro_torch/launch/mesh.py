"""Device meshes for the single-controller distributed path.

The counterpart of :mod:`repro.launch.mesh`.  A :class:`Mesh` is a grid of
torch devices with named axes, held by one process:

  * ``pod``   — cross-pod data parallelism (only histogram sums cross it)
  * ``data``  — data parallelism (records)
  * ``model`` — field (intra-record) and tree parallelism

Every axis but ``"model"`` carries records (:func:`data_axes`).  A mesh
may repeat a device: ``[cuda:0] * 4`` runs four data shards on one card
and ``["cpu"] * 8`` eight on the host, the port's counterpart of
``repro``'s forced host device count.  A mesh of ``meta`` devices
(:func:`meta_mesh`) is the dry runs' production mesh, as ``repro``'s are
of placeholder devices: it places nothing and only its shape is read.
Building a mesh touches no device state beyond counting the CUDA devices
when none are given.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

SINGLE_POD_SHAPE: Tuple[int, int] = (16, 16)          # 256 cards a pod
MULTI_POD_SHAPE: Tuple[int, int, int] = (2, 16, 16)   # 2 pods = 512 cards


class Mesh:
    """A device grid with named axes.

    ``devices`` is an object ndarray of ``torch.device`` of the mesh's
    shape, ``axis_names`` its axes in order, ``shape`` the ordered
    ``{axis: size}`` mapping.  Meshes compare and hash by their axes and
    devices, so a plan that carries one stays a usable cache key.
    """

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        self.devices = np.empty(arr.shape, dtype=object)
        for idx, d in np.ndenumerate(arr):
            self.devices[idx] = torch.device(d)
        self.axis_names = tuple(str(a) for a in axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} needs "
                             f"{self.devices.ndim} axis names, got "
                             f"{self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated mesh axis in {self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def _key(self):
        return (self.axis_names, self.devices.shape,
                tuple(str(d) for d in self.devices.flat))

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        devs = sorted({str(d) for d in self.devices.flat})
        return f"Mesh({self.shape}, devices={devs})"


def cuda_devices() -> list:
    """Every visible CUDA device, in index order."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``shape`` over ``devices`` (the first prod(shape) of them);
    by default over the visible CUDA devices, raising when there are too
    few."""
    shape = tuple(int(s) for s in shape)
    need = int(np.prod(shape))
    devs = list(devices) if devices is not None else cuda_devices()
    if len(devs) < need:
        where = "given" if devices is not None else "visible CUDA"
        raise ValueError(f"a {shape} mesh needs {need} devices; "
                         f"{len(devs)} {where} device(s)")
    grid = np.empty(need, dtype=object)
    for i, d in enumerate(devs[:need]):
        grid[i] = d
    return Mesh(grid.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence] = None) -> Mesh:
    """The 256-card (16 x 16) or 512-card (2 x 16 x 16) mesh."""
    shape = MULTI_POD_SHAPE if multi_pod else SINGLE_POD_SHAPE
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices=devices)


def meta_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """A mesh of ``shape`` over ``meta`` devices (a plan's mesh)."""
    n = int(np.prod(tuple(shape)))
    return make_mesh(shape, axes, devices=[torch.device("meta")] * n)


def meta_production_mesh(multi_pod: bool = False) -> Mesh:
    """The production mesh over ``meta`` devices (the dry runs' mesh)."""
    n = int(np.prod(MULTI_POD_SHAPE if multi_pod else SINGLE_POD_SHAPE))
    return make_production_mesh(multi_pod=multi_pod,
                                devices=[torch.device("meta")] * n)


def axis_size(mesh: Mesh, axes) -> int:
    """The shards of ``axes`` (``None``, one axis, or a tuple of them)."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return int(np.prod([mesh.shape[a] for a in axes]))


def shard_shape(mesh: Mesh, spec: Sequence, shape: Sequence[int]) -> tuple:
    """One card's shape of a ``shape`` tensor laid out by ``spec`` (per
    dimension ``None`` or the axes that shard it); a dimension that its
    axes do not divide takes the ceiling, the largest shard."""
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec} for a tensor of shape {shape}")
    return tuple(-(-int(d) // axis_size(mesh, a)) for d, a in
                 zip(shape, spec))


def data_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Axes carrying records (everything but ``"model"``)."""
    return tuple(a for a in mesh.axis_names if a != "model")


def spec_data_axes(mesh: Mesh):
    """The data axes as a spec names them: one axis, or a tuple of axes
    when there are several."""
    da = data_axes(mesh)
    return da if len(da) > 1 else da[0]


def model_axis(mesh: Mesh) -> str:
    return "model"


def n_data_shards(mesh: Mesh) -> int:
    return int(np.prod([mesh.shape[a] for a in data_axes(mesh)]))

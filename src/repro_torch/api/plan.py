"""ExecutionPlan — which implementation runs each GBDT step.

The PyTorch counterpart of :mod:`repro.api.plan`.  ``"cuda"`` sends a step
to its hand-written CUDA kernel, ``"reference"`` to the kernel's plain
PyTorch version, and ``"auto"`` resolves to ``"cuda"``.  The kernel
wrappers themselves take the plain version for tensors that lie on the
CPU and launch the kernel (or raise) for CUDA tensors, so ``"auto"`` means
the kernel on the card and the plain version on the CPU.  Nothing probes a
kernel or falls back from it: on a CUDA tensor the kernel runs or the call
raises.

Step ① also takes ``"cuda_packed"``, the counterpart of ``repro``'s
``"pallas_packed"``: the naive-packing histogram of the paper's Fig. 9
ablation, a twin for comparison that is never the default; and the plain
PyTorch baselines of ``repro``'s software strategies, ``"scatter"``,
``"scatter_private"``, ``"sort"`` and ``"onehot"``
(:mod:`repro_torch.kernels.ops`).  Step ⑤'s batch inference also takes
``"scan"``, the one-tree-at-a-time baseline.

``chunk_bytes`` and ``packed_codes`` size and lay out the out-of-core
stream (:func:`repro_torch.core.gbdt.train_streaming`).  ``repro``'s Pallas
grid knobs (``records_per_block``, ``fields_per_block``,
``trees_per_block``, ``interpret``) size TPU launches and have no meaning
here.  ``mesh`` (a :class:`repro_torch.launch.mesh.Mesh`) routes training
through the data-parallel trainer and batch inference through
``sharded_predict``.  Saved
``repro`` configs name the Pallas strategies: :func:`lift_legacy_strategy` maps them onto
the CUDA kernels where a legacy setting is lifted into a plan.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.launch.mesh import Mesh

STRATEGIES = ("cuda", "reference")
PLAIN_HIST_STRATEGIES = ("scatter", "scatter_private", "sort", "onehot")
HIST_STRATEGIES = STRATEGIES + ("cuda_packed",) + PLAIN_HIST_STRATEGIES
TRAVERSAL_STRATEGIES = STRATEGIES + ("scan",)
# repro's Pallas strategy names -> the CUDA kernel that replaces each
LEGACY_STRATEGIES = {"pallas_grouped": "cuda", "pallas_packed": "cuda_packed",
                     "pallas": "cuda"}
_STRATEGY_FIELDS = ("hist_strategy", "partition_strategy",
                    "traversal_strategy")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Without a CUDA device this raises rather than quietly running
    on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    return dev


def lift_legacy_strategy(name):
    """A strategy name of a saved ``repro`` config or a legacy keyword, as
    the port spells it: the Pallas names become their CUDA kernels, every
    other value passes as it is."""
    return LEGACY_STRATEGIES.get(name, name)


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Kernel selection for step ① (histogram), ② (split search), ③
    (partition) and ⑤ (traversal and batch inference).

    Fields
    ------
    hist_strategy:       step ① — ``"cuda"``, ``"reference"``,
                         ``"cuda_packed"`` or a plain baseline of
                         ``PLAIN_HIST_STRATEGIES``; or ``"auto"``
    partition_strategy:  step ③ — ``"cuda"`` | ``"reference"`` | ``"auto"``
    traversal_strategy:  step ⑤ / batch inference — ``"cuda"``,
                         ``"reference"``, ``"scan"`` (batch inference one
                         tree at a time; a single walk is the plain one) or
                         ``"auto"``
    host_offload_split:  run step ② on the host (the paper's offload): one
                         copy of the level's histogram to the host, numpy,
                         one copy of the decisions back
    hist_subtraction:    at each level > 0 of the depthwise grower bin only
                         the smaller child of every split parent and derive
                         the sibling as ``parent − smaller`` (paper §II-A)
                         in float32, where that changes the numbers: on the
                         CPU, the chunked and sharded layouts, the naive
                         ``"cuda_packed"`` kernel and the lossguide grower.
                         ``None`` resolves to ``False``: a derived sibling
                         reassociates the parent's sum, so the direct pass
                         stays the default there.  The in-memory grower on
                         the card's ``"cuda"`` kernel always derives every
                         level > 0 so, exactly in int64 (bit-equal to the
                         direct pass), whatever this field says
    packed_codes:        stream bin codes 4-bit packed (two per byte).
                         ``None`` = auto: pack whenever the binner's
                         ``max_bins <= 16``; ``True`` forces packing
                         (errors above 16 bins); ``False`` forces uint8.
                         Sets the resident-bytes model of
                         :meth:`chunk_rows`; results are bit-equal either
                         way
    chunk_bytes:         out-of-core budget of binned records resident on
                         the device at once; when set, ``fit`` streams
                         chunk-sized passes instead of materializing the
                         matrix (None = in-memory)
    mesh:                optional :class:`repro_torch.launch.mesh.Mesh`;
                         when set, ``train``/``fit`` route through the
                         data-parallel trainer (paper §III-B: per-shard
                         histograms, one sum a level) and the estimator's
                         batch inference shards trees over ``"model"`` and
                         records over the data axes (paper §III-D)
    data_axes:           mesh axes carrying records in distributed
                         training; ``None`` resolves to every axis but
                         ``"model"``.  Only meaningful with ``mesh``
    """

    hist_strategy: str = "auto"
    partition_strategy: str = "auto"
    traversal_strategy: str = "auto"
    host_offload_split: bool = False
    hist_subtraction: Optional[bool] = None
    packed_codes: Optional[bool] = None
    chunk_bytes: Optional[int] = None
    mesh: Optional[object] = None
    data_axes: Optional[Tuple[str, ...]] = None

    DEFAULT_CHUNK_BYTES = 1 << 26          # 64 MiB of resident chunk state

    def __post_init__(self):
        if self.chunk_bytes is not None and self.chunk_bytes <= 0:
            raise ValueError("chunk_bytes must be positive (or None for "
                             "in-memory training)")
        if self.mesh is not None and not isinstance(self.mesh, Mesh):
            raise TypeError(f"mesh must be a repro_torch.launch.mesh.Mesh, "
                            f"not {type(self.mesh).__name__}")
        if self.data_axes is not None:
            # a tuple keeps plans hashable
            object.__setattr__(self, "data_axes",
                               tuple(str(a) for a in self.data_axes))
            if self.mesh is None:
                raise ValueError("data_axes only applies together with a "
                                 "mesh (the distributed-training record "
                                 "axes)")
            missing = set(self.data_axes) - set(self.mesh.axis_names)
            if missing:
                raise ValueError(
                    f"data_axes {sorted(missing)} not present on the mesh "
                    f"(axes: {self.mesh.axis_names})")
        for name, allowed in (("hist_strategy", HIST_STRATEGIES),
                              ("partition_strategy", STRATEGIES),
                              ("traversal_strategy", TRAVERSAL_STRATEGIES)):
            value = getattr(self, name)
            if value not in allowed + ("auto",):
                raise ValueError(f"unknown {name} {value!r}; choose from "
                                 f"{allowed + ('auto',)}")

    @classmethod
    def from_config(cls, config) -> "ExecutionPlan":
        """Lift a ``GBDTConfig``'s legacy per-step fields (deprecated where
        the config is built) into one resolved plan; ``repro``'s Pallas
        names map onto the CUDA kernels."""
        return cls(**{name: lift_legacy_strategy(getattr(config, name))
                      for name in _STRATEGY_FIELDS},
                   host_offload_split=bool(config.host_offload_split)
                   ).resolved()

    def resolved(self) -> "ExecutionPlan":
        """Replace every ``"auto"`` with ``"cuda"`` and an unset
        ``hist_subtraction`` with ``False``."""
        kw = {name: "cuda" for name in _STRATEGY_FIELDS
              if getattr(self, name) == "auto"}
        if self.hist_subtraction is None:
            kw["hist_subtraction"] = False
        return dataclasses.replace(self, **kw) if kw else self

    def replace(self, **changes) -> "ExecutionPlan":
        return dataclasses.replace(self, **changes)

    # -- out-of-core chunking ----------------------------------------------
    def chunk_rows(self, n_fields: int, n_classes: int = 1) -> int:
        """Rows per streamed chunk under the ``chunk_bytes`` budget, by
        ``repro``'s resident-bytes model: the code row and its column-major
        copy (2F bytes, F when ``packed_codes`` halves both) and the
        per-class float32 g, h and int32 node id (12K bytes).  The raw
        floats a chunk arrives in, and their float64 cast while it is
        binned on the device, are not in the model."""
        budget = self.chunk_bytes or self.DEFAULT_CHUNK_BYTES
        code_bytes = (1 if self.packed_codes else 2) * max(n_fields, 1)
        per_row = code_bytes + 12 * max(n_classes, 1)
        return max(256, budget // per_row)

    def without_chunking(self) -> "ExecutionPlan":
        """This plan without ``chunk_bytes`` (the kernels' view of it)."""
        if self.chunk_bytes is None:
            return self
        return dataclasses.replace(self, chunk_bytes=None)

    def describe(self) -> str:
        sub = "+sub" if self.hist_subtraction else ""
        if self.packed_codes is not None:
            sub += f", packed={self.packed_codes}"
        split = "host" if self.host_offload_split else "device"
        where = ("single-device" if self.mesh is None
                 else f"mesh={dict(self.mesh.shape)}")
        return (f"ExecutionPlan(hist={self.hist_strategy}{sub}, "
                f"split={split}, partition={self.partition_strategy}, "
                f"traversal={self.traversal_strategy}, {where})")


def resolve_plan(plan: Optional[ExecutionPlan] = None,
                 **loose) -> ExecutionPlan:
    """A concrete plan from ``plan`` (the default plan when None) and
    legacy loose settings: entries that are ``None``, ``"auto"`` or
    ``False`` are ignored, any other value (a Pallas name lifted by
    :func:`lift_legacy_strategy`) overrides the plan field of the same
    name."""
    loose = {k: lift_legacy_strategy(v) for k, v in loose.items()
             if v is not None and v != "auto" and v is not False}
    base = plan if plan is not None else ExecutionPlan()
    if loose:
        base = dataclasses.replace(base, **loose)
    return base.resolved()

"""ExecutionPlan — which implementation runs each GBDT step.

The PyTorch counterpart of :mod:`repro.api.plan`, cut to the three step
strategies.  ``"cuda"`` sends a step to its hand-written CUDA kernel,
``"reference"`` to the kernel's plain PyTorch version, and ``"auto"``
resolves to ``"cuda"``.  The kernel wrappers themselves take the plain
version for tensors that lie on the CPU and launch the kernel (or raise)
for CUDA tensors, so ``"auto"`` means the kernel on the card and the plain
version on the CPU.  Nothing probes a kernel or falls back from it: on a
CUDA tensor the kernel runs or the call raises.

Step ① also takes ``"cuda_packed"``, the counterpart of ``repro``'s
``"pallas_packed"``: the naive-packing histogram of the paper's Fig. 9
ablation, a twin for comparison that is never the default.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

STRATEGIES = ("cuda", "reference")
HIST_STRATEGIES = STRATEGIES + ("cuda_packed",)


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


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Kernel selection for step ① (histogram), ③ (partition) and ⑤
    (traversal and batch inference).  Each field is ``"auto"``, ``"cuda"``
    or ``"reference"``, and ``hist_strategy`` may also be
    ``"cuda_packed"``; ``mesh`` exists to refuse multi-device plans."""

    hist_strategy: str = "auto"
    partition_strategy: str = "auto"
    traversal_strategy: str = "auto"
    mesh: Optional[object] = None

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "multi-device plans are not ported yet (ROADMAP Queue 1: "
                "Distributed)")
        for name, allowed in (("hist_strategy", HIST_STRATEGIES),
                              ("partition_strategy", STRATEGIES),
                              ("traversal_strategy", STRATEGIES)):
            value = getattr(self, name)
            if value not in allowed + ("auto",):
                raise ValueError(f"unknown {name} {value!r}; choose from "
                                 f"{allowed + ('auto',)}")

    def resolved(self) -> "ExecutionPlan":
        """Replace every ``"auto"`` with ``"cuda"``."""
        kw = {name: "cuda" for name in ("hist_strategy", "partition_strategy",
                                        "traversal_strategy")
              if getattr(self, name) == "auto"}
        return dataclasses.replace(self, **kw) if kw else self

    def replace(self, **changes) -> "ExecutionPlan":
        return dataclasses.replace(self, **changes)


def resolve_plan(plan: Optional[ExecutionPlan] = None) -> ExecutionPlan:
    return (plan if plan is not None else ExecutionPlan()).resolved()

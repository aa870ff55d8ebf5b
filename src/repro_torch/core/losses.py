"""Differentiable losses for gradient boosting.

The counterpart of :mod:`repro.core.losses`.  Training only consumes the
per-record first/second order statistics (g_i, h_i) of the loss at the
current margin, which are closed-form and elementwise.  ``multi:softmax``
has (n, K) margins and statistics, one column per class.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Loss:
    """A boosting loss: value + (g, h) statistics at the current margin.
    Scalar-margin losses leave ``n_outputs`` at ``None``; multi-class
    losses set it to K (margins are then (n, K))."""

    name: str
    value_fn: Callable[[Tensor, Tensor], Tensor]
    grad_hess_fn: Callable[[Tensor, Tensor], Tuple[Tensor, Tensor]]
    transform_fn: Callable[[Tensor], Tensor]
    base_margin_fn: Callable[[Tensor], Tensor]
    n_outputs: Optional[int] = None

    def value(self, margin: Tensor, y: Tensor) -> Tensor:
        return self.value_fn(margin, y)

    def grad_hess(self, margin: Tensor, y: Tensor) -> Tuple[Tensor, Tensor]:
        return self.grad_hess_fn(margin, y)

    def transform(self, margin: Tensor) -> Tensor:
        return self.transform_fn(margin)

    def base_margin(self, y: Tensor) -> Tensor:
        return self.base_margin_fn(y)


def _sq_value(margin, y):
    return 0.5 * (margin - y) ** 2


def _sq_grad_hess(margin, y):
    return margin - y, torch.ones_like(margin)


squared_error = Loss(
    name="reg:squarederror",
    value_fn=_sq_value,
    grad_hess_fn=_sq_grad_hess,
    transform_fn=lambda m: m,
    base_margin_fn=lambda y: torch.mean(y),
)


def _logistic_value(margin, y):
    # numerically stable log(1 + exp(-y'm)) with y in {0, 1}
    return torch.logaddexp(torch.zeros_like(margin), margin) - y * margin


def _logistic_grad_hess(margin, y):
    p = torch.sigmoid(margin)
    return p - y, torch.clamp(p * (1.0 - p), min=1e-16)


def _logistic_base(y):
    p = torch.clamp(torch.mean(y), 1e-6, 1.0 - 1e-6)
    return torch.log(p / (1.0 - p))


binary_logistic = Loss(
    name="binary:logistic",
    value_fn=_logistic_value,
    grad_hess_fn=_logistic_grad_hess,
    transform_fn=torch.sigmoid,
    base_margin_fn=_logistic_base,
)


def _huber_value(margin, y, delta=1.0):
    r = margin - y
    a = torch.abs(r)
    return torch.where(a <= delta, 0.5 * r * r, delta * (a - 0.5 * delta))


def _huber_grad_hess(margin, y, delta=1.0):
    r = margin - y
    g = torch.clamp(r, -delta, delta)
    h = torch.where(torch.abs(r) <= delta, torch.ones_like(r),
                    torch.full_like(r, 1e-2))
    return g, h


def _median(y):
    """The median with the mean of the two middle values for even sizes
    (``torch.median`` returns the lower one)."""
    s = torch.sort(y.reshape(-1)).values
    k = s.shape[0] // 2
    return s[k] if s.shape[0] % 2 else 0.5 * (s[k - 1] + s[k])


pseudo_huber = Loss(
    name="reg:huber",
    value_fn=_huber_value,
    grad_hess_fn=_huber_grad_hess,
    transform_fn=lambda m: m,
    base_margin_fn=_median,
)

# --------------------------------------------------------------------------
# multi-class softmax (vector margins, K per-class trees per round)
# --------------------------------------------------------------------------
def _softmax_value(margin, y):
    # cross-entropy: logsumexp(m) - m[y], numerically stable
    picked = torch.gather(margin, -1, y.long()[:, None])[:, 0]
    return torch.logsumexp(margin, dim=-1) - picked


def _softmax_grad_hess(margin, y):
    """Diagonal of the softmax cross-entropy Hessian:
    g_k = p_k - 1[y == k],  h_k = max(p_k (1 - p_k), 1e-16)."""
    K = margin.shape[-1]
    p = torch.softmax(margin, dim=-1)
    g = p - torch.nn.functional.one_hot(y.long(), K).to(p.dtype)
    h = torch.clamp(p * (1.0 - p), min=1e-16)
    return g, h


def multi_softmax(n_classes: int) -> Loss:
    """The ``multi:softmax`` objective for a fixed class count ``K``."""
    if n_classes < 2:
        raise ValueError(f"multi:softmax needs n_classes >= 2, "
                         f"got {n_classes}")

    def base_margin(y):
        # log class priors, centred (softmax is shift-invariant)
        counts = torch.bincount(y.long(), minlength=n_classes)[:n_classes]
        p = torch.clamp(counts / max(y.shape[0], 1), 1e-6, 1.0)
        logp = torch.log(p.to(torch.float32))
        return logp - torch.mean(logp)

    return Loss(
        name="multi:softmax",
        value_fn=_softmax_value,
        grad_hess_fn=_softmax_grad_hess,
        transform_fn=lambda m: torch.softmax(m, dim=-1),
        base_margin_fn=base_margin,
        n_outputs=int(n_classes),
    )


LOSSES = {
    squared_error.name: squared_error,
    binary_logistic.name: binary_logistic,
    pseudo_huber.name: pseudo_huber,
}

MULTICLASS_OBJECTIVES = ("multi:softmax",)


def get_loss(name: str, n_classes: Optional[int] = None) -> Loss:
    if name in MULTICLASS_OBJECTIVES:
        if n_classes is None:
            raise ValueError(f"{name!r} requires n_classes")
        return multi_softmax(n_classes)
    if name not in LOSSES:
        raise KeyError(f"unknown loss {name!r}; available: "
                       f"{sorted(LOSSES) + list(MULTICLASS_OBJECTIVES)}")
    return LOSSES[name]

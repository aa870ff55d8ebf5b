"""The plain reference of a squared-error fit, in plain PyTorch.

It imports nothing of the program.  The loss's pieces in float64 (or in
the margins' dtype): the base margin is the mean label, g = m − y, h = 1,
and the loss is mean(½ (m − y)²), as the port's ``reg:squarederror``
states them.  Binning, the depthwise grower, the judge of a tree and the
walk of an ensemble are those of :mod:`.gbdt`, which do not depend on
the loss, and are re-exported here so that a kind takes every piece of
its reference from one module.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .gbdt import bin_codes, grow_tree, judge_tree, stack_trees, walk

__all__ = ["bin_codes", "grow_tree", "judge_tree", "stack_trees", "walk",
           "base_margin", "grad_hess", "loss"]

Tensor = torch.Tensor


def base_margin(y: Tensor, K: int = 1) -> Tensor:
    """(1,) float64 base margin: the mean label."""
    if K != 1:
        raise ValueError(f"squared error has one output, not {K}")
    return y.to(torch.float64).mean().reshape(1)


def grad_hess(margins: Tensor, y: Tensor) -> Tuple[Tensor, Tensor]:
    """g, h of (n, 1) ``margins``: m − y and 1, in the margins' dtype."""
    g = margins - y.to(margins.dtype)[:, None]
    return g, torch.ones_like(g)


def loss(margins: Tensor, y: Tensor) -> float:
    """The mean of ½ (m − y)² over (n, 1) float64 ``margins``."""
    r = margins[:, 0] - y.to(margins.dtype)
    return float((0.5 * r * r).mean())

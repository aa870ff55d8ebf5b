"""AdamW and the LR schedules (cosine and MiniCPM's WSD): the counterpart
of :mod:`repro.models.optim`, as plain PyTorch.

``repro`` maps the update over a parameter pytree and returns new arrays.
Here it updates an ``nn.Module``'s parameters in place from their
``.grad``, under ``torch.no_grad()``, with ``repro``'s arithmetic in
``repro``'s order: a global-norm clip, bias corrections from an int32
step counter on the device, the update applied in float32 and cast back
to the parameter's dtype, weight decay on every leaf.  The moments are
float32 whatever the parameter dtype (``torch.optim.AdamW`` keeps them in
the parameter's, bfloat16 for bfloat16 weights).  Nothing reads a value
back to the host: the step counter, the learning rate and the gradient
norm stay 0-d device tensors.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch
from torch import nn

# elements updated at once: a leaf is updated in flat slices of this size,
# so the float32 temporaries of one slice are all the update allocates
# (the update is elementwise, so slicing changes no bit)
_SLICE = 1 << 26


class AdamWState(NamedTuple):
    step: torch.Tensor               # 0-d int32, on the parameters' device
    m: Dict[str, torch.Tensor]       # float32, by parameter name
    v: Dict[str, torch.Tensor]


def adamw_init(params: nn.Module) -> AdamWState:
    named = list(params.named_parameters())
    if not named:
        raise ValueError("adamw_init: the module has no parameters")
    dev = named[0][1].device

    def zeros():
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in named}
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=zeros(), v=zeros())


@torch.no_grad()
def adamw_update(params: nn.Module, state: AdamWState, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float = 1.0):
    """One AdamW step on ``params`` from their ``.grad`` (a parameter
    without one counts as a zero gradient), in place; ``lr`` a float or a
    0-d tensor.  Returns (params, the new state, the gradient's global
    norm as a 0-d float32 tensor)."""
    named = list(params.named_parameters())
    grads = [p.grad for _, p in named]
    gnorm = torch.zeros((), dtype=torch.float32, device=state.step.device)
    for g in grads:
        for gs in (() if g is None else g.reshape(-1).split(_SLICE)):
            gs = gs.float()
            gnorm = gnorm + torch.sum(gs * gs)
    gnorm = torch.sqrt(gnorm)
    scale = torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    t = step.float()
    c1 = 1.0 - b1 ** t
    c2 = 1.0 - b2 ** t
    for (name, p), g in zip(named, grads):
        m, v = state.m[name], state.v[name]
        if g is None:
            g = torch.zeros_like(p)
        for ps, gs, ms, vs in zip(*(x.reshape(-1).split(_SLICE)
                                    for x in (p, g, m, v))):
            gs = gs.float() * scale
            ms.mul_(b1).add_(gs, alpha=1 - b1)
            vs.mul_(b2).addcmul_(gs, gs, value=1 - b2)
            u = (ms / c1).div_((vs / c2).sqrt_().add_(eps))
            p32 = ps.float()                  # ps itself when float32
            u.add_(p32, alpha=weight_decay).mul_(lr)
            if p32 is ps:
                ps.sub_(u)
            else:
                ps.copy_(p32.sub_(u))
    return params, AdamWState(step=step, m=state.m, v=state.v), gnorm


def cosine_schedule(step, *, base_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1):
    step = torch.as_tensor(step).float()
    warm = base_lr * step / max(warmup, 1)
    t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5
                     * (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup, warm, cos)


def wsd_schedule(step, *, base_lr: float, warmup: int, total: int,
                 decay_frac: float = 0.1, min_ratio: float = 0.01):
    """MiniCPM's Warmup-Stable-Decay: linear warmup, long flat stage, short
    exponential-ish decay tail (arXiv:2404.06395 §4)."""
    step = torch.as_tensor(step).float()
    decay_start = total * (1.0 - decay_frac)
    warm = base_lr * step / max(warmup, 1)
    t = torch.clamp((step - decay_start) / max(total - decay_start, 1),
                    0.0, 1.0)
    decay = base_lr * (min_ratio ** t)
    return torch.where(step < warmup, warm,
                       torch.where(step < decay_start, base_lr, decay))


def get_schedule(name: str):
    return {"cosine": cosine_schedule, "wsd": wsd_schedule}[name]

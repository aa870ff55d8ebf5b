"""Mixture-of-Experts layer (Mixtral / Llama-4 / Jamba style).

The counterpart of :mod:`repro.models.moe`, as plain PyTorch: top-k
routing in float32, then the capacity-buffer dispatch (GShard-style).
Each (token, choice) pair takes the next free slot of its expert's
``(E, C, d)`` buffer, counted over dispatch order (token-major, choice
minor); pairs past the capacity are dropped.  Every expert runs on its
whole buffer, and each token sums its choices' outputs, weighted by the
renormalized router probabilities.

The sum over a token's ``k`` choices is a reduction over a ``(T, k, d)``
view: ``repro``'s ``segment_sum`` over ``repeat(arange(T), k)`` adds the
same terms, and the view is deterministic on the card where an
``index_add_`` of atomics is not.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import mlp


def _one_hot(idx, n: int):
    """(len(idx), n) int64 one-hot; unlike ``F.one_hot`` it reads no index
    back to the host (no synchronisation on the card)."""
    return (idx[:, None] == torch.arange(n, device=idx.device)).long()


def moe_ffn(params, x, *, n_experts: int, top_k: int,
            capacity_factor: float = 1.25, act: str = "silu",
            return_aux: bool = False):
    """params: router (d, E), w_in/w_gate (E, d, ff), w_out (E, ff, d),
    optional shared_* (plain MLP applied to every token).

    x: (B, S, d) -> (B, S, d).
    """
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)

    logits = xf.float() @ params["router"].float()               # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, top_k, dim=-1, sorted=True)  # (T, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    capacity = max(int(t * top_k * capacity_factor / n_experts), 4)

    e_flat = top_e.reshape(-1)                                    # (T*k,)
    w_flat = top_p.reshape(-1)
    # position-in-expert via a cumulative count over dispatch order
    oh = _one_hot(e_flat, n_experts)                              # (T*k, E)
    pos_flat = torch.gather(torch.cumsum(oh, dim=0) - oh, 1,
                            e_flat[:, None])[:, 0]
    keep = pos_flat < capacity
    pos_c = torch.clamp(pos_flat, max=capacity - 1)

    # dispatch: each kept (expert, slot) is unique; a dropped pair adds zeros
    xk = xf.repeat_interleave(top_k, dim=0) * keep[:, None].to(x.dtype)
    buf = torch.zeros((n_experts, capacity, d), dtype=x.dtype,
                      device=x.device)
    buf.index_put_((e_flat, pos_c), xk, accumulate=True)

    if "w_gate" in params:
        hidden = F.silu(torch.einsum("ecd,edf->ecf", buf, params["w_gate"])) \
            * torch.einsum("ecd,edf->ecf", buf, params["w_in"])
    else:
        hidden = F.silu(torch.einsum("ecd,edf->ecf", buf, params["w_in"]))
    out_buf = torch.einsum("ecf,efd->ecd", hidden, params["w_out"])

    # combine: gather each token's expert outputs, weight, and sum over k
    y_flat = out_buf[e_flat, pos_c] * (w_flat * keep)[:, None].to(x.dtype)
    y = y_flat.view(t, top_k, d).sum(1)

    if "shared_w_in" in params:
        shared = {k[len("shared_"):]: v for k, v in params.items()
                  if k.startswith("shared_")}
        y = y + mlp(shared, xf, act=act)
    y = y.reshape(b, s, d)
    if return_aux:
        return y, moe_aux_loss(logits, top_e, n_experts)
    return y


def moe_aux_loss(logits, top_e, n_experts: int):
    """Load-balancing auxiliary loss (Switch-style): E * sum(f_i * p_i),
    where f_i is the fraction of tokens whose top-1 pick is expert i and
    p_i the mean router probability of expert i.  Minimized (=1) at a
    perfectly uniform load."""
    probs = torch.softmax(logits.float(), -1)
    me = probs.mean(0)
    ce = _one_hot(top_e[:, 0], n_experts).float().mean(0)
    return n_experts * torch.sum(me * ce)

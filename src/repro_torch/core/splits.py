"""Step ② — evaluating histogram bins to pick split points.

The counterpart of :func:`repro.core.splits.find_best_splits`, in PyTorch
on the histogram's device.

Split semantics (paper Fig 3 + missing-value handling):
  numeric field f, bin t:  "code <= t" goes left;
  categorical field f, category c: "code == c" goes left (one-vs-rest);
  the missing bin is tried on BOTH sides and the better direction is
      stored as ``default_left``.

gain = 1/2 [ GL²/(HL+λ) + GR²/(HR+λ) − Gp²/(Hp+λ) ] − γ   (XGBoost eq. 7)
"""
from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


class SplitDecision(NamedTuple):
    gain: Tensor          # (NN,) float32; <= 0 means "do not split"
    feature: Tensor       # (NN,) int32 global field id
    threshold: Tensor     # (NN,) int32 bin code (numeric: <=, cat: ==)
    is_cat: Tensor        # (NN,) int32
    default_left: Tensor  # (NN,) int32 missing direction
    node_g: Tensor        # (NN,) float32 parent G (for leaf weights)
    node_h: Tensor        # (NN,) float32 parent H
    left_h: Tensor        # (NN,) float32 hessian mass routed left


def leaf_weight(G, H, lambda_):
    return -G / (H + lambda_)


def _pick(a: Tensor, idx: Tensor) -> Tensor:
    return torch.gather(a, -1, idx[..., None])[..., 0]


def find_best_splits(hist: Tensor, is_cat_field: Tensor, field_mask: Tensor,
                     lambda_: float, gamma: float,
                     min_child_weight: float) -> SplitDecision:
    """hist: (NN, F, NB, 2); the last bin of every field is the missing bin.

    field_mask: (F,) bool — colsample / field-availability mask.  Per
    candidate the better missing direction is chosen, then the argmax over
    bins, then over fields; ties take the first index.
    """
    NN, F, NB, _ = hist.shape
    G = hist[..., 0].sum(-1)                               # (NN, F)
    H = hist[..., 1].sum(-1)
    # every record carries every field once, so field 0 gives the parent
    Gp, Hp = G[:, 0], H[:, 0]                              # (NN,)
    Gm = hist[:, :, NB - 1, 0]                             # (NN, F) missing
    Hm = hist[:, :, NB - 1, 1]
    v = hist[:, :, : NB - 1, :]                            # value bins
    parent_score = (Gp ** 2 / (Hp + lambda_))[:, None, None]
    neg = float("-inf")      # a Python scalar: no host-to-device copy

    def gain_of(GL, HL):
        GR = Gp[:, None, None] - GL
        HR = Hp[:, None, None] - HL
        ok = (HL >= min_child_weight) & (HR >= min_child_weight)
        gain = 0.5 * (GL ** 2 / (HL + lambda_) + GR ** 2 / (HR + lambda_)
                      - parent_score) - gamma
        return torch.where(ok, gain, neg)

    cumG = torch.cumsum(v[..., 0], dim=-1)                 # (NN, F, NB-1)
    cumH = torch.cumsum(v[..., 1], dim=-1)
    num_dr = gain_of(cumG, cumH)                           # missing -> right
    num_dl = gain_of(cumG + Gm[..., None], cumH + Hm[..., None])
    cat_dr = gain_of(v[..., 0], v[..., 1])
    cat_dl = gain_of(v[..., 0] + Gm[..., None], v[..., 1] + Hm[..., None])

    cat_f = is_cat_field.to(torch.bool)[None, :, None]
    cand_dr = torch.where(cat_f, cat_dr, num_dr)
    cand_dl = torch.where(cat_f, cat_dl, num_dl)
    go_dl = cand_dl > cand_dr
    cand = torch.maximum(cand_dl, cand_dr)                 # (NN, F, NB-1)
    cand = torch.where(field_mask.to(torch.bool)[None, :, None], cand, neg)

    # hessian routed left per candidate (counts channel)
    HL = torch.where(cat_f, v[..., 1], cumH)
    HL = HL + torch.where(go_dl, Hm[..., None], 0.0)

    t_best = torch.argmax(cand, dim=-1)                    # (NN, F)
    gain_f = _pick(cand, t_best)
    dl_f = _pick(go_dl, t_best)
    hl_f = _pick(HL, t_best)
    f_best = torch.argmax(gain_f, dim=-1)                  # (NN,)
    gain = _pick(gain_f, f_best)
    thr = _pick(t_best, f_best)
    dl = _pick(dl_f, f_best)
    hl = _pick(hl_f, f_best)
    gain = torch.where(torch.isfinite(gain), gain, -1.0)
    return SplitDecision(
        gain=gain.to(torch.float32),
        feature=f_best.to(torch.int32),
        threshold=thr.to(torch.int32),
        is_cat=is_cat_field[f_best].to(torch.int32),
        default_left=dl.to(torch.int32),
        node_g=Gp.to(torch.float32),
        node_h=Hp.to(torch.float32),
        left_h=hl.to(torch.float32),
    )

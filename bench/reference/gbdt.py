"""The plain reference of the GBDT workloads, in plain PyTorch.

It imports nothing of the program.  It bins raw values against the
benchmark's edges, computes the loss's g and h, builds level histograms
by ``bincount``, evaluates every split candidate, walks ensembles, and
grows depthwise trees; by default in float64 on whatever device its
tensors lie on, or in any ``dtype`` (the control computes in bfloat16).

Semantics, as the configuration states them (XGBoost's exact depthwise
grower over binned values):
  numeric field f, bin t: "code <= t" goes left; indicator field f,
  category c: "code == c" goes left; the missing bin (the last) goes the
  better way, kept as ``default_left``;
  gain = 1/2 [GL²/(HL+λ) + GR²/(HR+λ) − Gp²/(Hp+λ)] − γ, a candidate valid
  where both sides hold at least ``min_child_weight`` of hessian;
  a node splits where its best gain is > 0, else it is a leaf of weight
  −G/(H+λ), and records under a leaf go left at every level below it;
  leaves are stored times the learning rate.

A tree is a dict of tensors: ``feature`` (N_int,), -1 where a node does
not split, ``threshold``, ``is_cat``, ``default_left`` (N_int,) and
``leaf_value`` (2^D,); stacked ensembles carry a leading tree axis, tree
t adding into class t % K.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

Tensor = torch.Tensor
BIN_BLOCK = 1 << 20          # rows binned at once
WALK_ELEMS = 1 << 25         # (row, tree) pairs walked at once


# -- binning -----------------------------------------------------------------
def bin_codes(X: Tensor, edges, is_cat, n_value_bins, max_bins: int
              ) -> Tensor:
    """(n, F) uint8 codes of raw ``X`` against float64 ``edges`` (F, E):
    a numeric value's code counts the edges <= it; an indicator's code is
    its category, cut to the field's; NaN takes the missing code."""
    dev = X.device
    edges = torch.as_tensor(edges, dtype=torch.float64, device=dev)
    is_cat = torch.as_tensor(is_cat, dtype=torch.bool, device=dev)
    nvb = torch.as_tensor(n_value_bins, dtype=torch.float64, device=dev)
    n, F = X.shape
    out = torch.empty((n, F), dtype=torch.uint8, device=dev)
    for lo in range(0, n, BIN_BLOCK):
        x = X[lo:lo + BIN_BLOCK].to(torch.float64)
        nan = torch.isnan(x)
        x = torch.where(nan, 0.0, x)
        cols = []
        for f in range(F):
            if is_cat[f]:
                c = torch.minimum(torch.trunc(x[:, f]).clamp(min=0.0),
                                  nvb[f] - 1.0)
            else:
                c = torch.searchsorted(edges[f], x[:, f].contiguous(),
                                       right=True).to(torch.float64)
            cols.append(c)
        codes = torch.stack(cols, dim=1)
        codes = torch.where(nan, float(max_bins - 1), codes)
        out[lo:lo + BIN_BLOCK] = codes.to(torch.uint8)
    return out


# -- the loss ------------------------------------------------------------------
def base_margin(y: Tensor, K: int) -> Tensor:
    """(K,) float64 base margin: the log-odds of the mean label, or the
    centred log class priors."""
    y = y.to(torch.float64)
    if K == 1:
        p = y.mean().clamp(1e-6, 1.0 - 1e-6)
        return torch.log(p / (1.0 - p)).reshape(1)
    counts = torch.bincount(y.long(), minlength=K)[:K].to(torch.float64)
    logp = torch.log((counts / y.shape[0]).clamp(1e-6, 1.0))
    return logp - logp.mean()


def grad_hess(margins: Tensor, y: Tensor) -> Tuple[Tensor, Tensor]:
    """g, h of (n, K) ``margins``: the logistic loss at K = 1, the softmax
    cross entropy's diagonal otherwise; in the margins' dtype."""
    K = margins.shape[1]
    if K == 1:
        p = torch.sigmoid(margins)
        g = p - y.to(margins.dtype)[:, None]
    else:
        p = torch.softmax(margins, dim=1)
        hot = torch.zeros_like(p).scatter_(1, y.long()[:, None], 1.0)
        g = p - hot
    return g, torch.clamp(p * (1.0 - p), min=1e-16)


def loss(margins: Tensor, y: Tensor) -> float:
    """The mean loss of (n, K) float64 ``margins``."""
    if margins.shape[1] == 1:
        m = margins[:, 0]
        return float((torch.logaddexp(torch.zeros_like(m), m)
                      - y.to(m.dtype) * m).mean())
    picked = margins.gather(1, y.long()[:, None])[:, 0]
    return float((torch.logsumexp(margins, dim=1) - picked).mean())


# -- one level -------------------------------------------------------------------
def level_hist(codes: Tensor, g: Tensor, h: Tensor, node: Tensor,
               nodes: int, n_bins: int, dtype=torch.float64) -> Tensor:
    """(nodes, F, n_bins, 2) sums of (n,) g and h by node and bin, summed
    in float64 (float32 below it) and returned in ``dtype``."""
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    n, F = codes.shape
    g, h = g.to(acc), h.to(acc)
    base = node.long() * n_bins
    out = torch.empty((F, nodes * n_bins, 2), dtype=acc, device=codes.device)
    for f in range(F):
        key = base + codes[:, f].long()
        out[f, :, 0] = torch.bincount(key, weights=g, minlength=nodes * n_bins)
        out[f, :, 1] = torch.bincount(key, weights=h, minlength=nodes * n_bins)
    out = out.reshape(F, nodes, n_bins, 2).permute(1, 0, 2, 3)
    return out.to(dtype).contiguous()


def candidates(hist: Tensor, is_cat: Tensor, lambda_: float, gamma: float,
               min_child_weight: float) -> Dict[str, Tensor]:
    """Every split candidate of (NN, F, NB, 2) ``hist``: the gain with the
    missing bin sent the better way (-inf where a side is too light), the
    way it went, the left sums, and the parent's sums and score."""
    NN, F, NB, _ = hist.shape
    G, H = hist[..., 0].sum(-1), hist[..., 1].sum(-1)
    Gp, Hp = G[:, 0], H[:, 0]          # every record carries field 0
    Gm, Hm = hist[:, :, NB - 1, 0], hist[:, :, NB - 1, 1]
    v = hist[:, :, :NB - 1, :]
    cat = is_cat.to(torch.bool)[None, :, None]
    GL = torch.where(cat, v[..., 0], torch.cumsum(v[..., 0], -1))
    HL = torch.where(cat, v[..., 1], torch.cumsum(v[..., 1], -1))
    parent = Gp ** 2 / (Hp + lambda_)

    def gain(gl, hl):
        gr, hr = Gp[:, None, None] - gl, Hp[:, None, None] - hl
        raw = 0.5 * (gl ** 2 / (hl + lambda_) + gr ** 2 / (hr + lambda_)
                     - parent[:, None, None]) - gamma
        ok = (hl >= min_child_weight) & (hr >= min_child_weight)
        return raw, ok

    raw_r, ok_r = gain(GL, HL)
    raw_l, ok_l = gain(GL + Gm[..., None], HL + Hm[..., None])
    neg = torch.tensor(float("-inf"), dtype=hist.dtype, device=hist.device)
    gr, gl = torch.where(ok_r, raw_r, neg), torch.where(ok_l, raw_l, neg)
    go_dl = gl > gr
    return {"gain": torch.maximum(gl, gr), "go_dl": go_dl,
            "raw_r": raw_r, "raw_l": raw_l,
            "GL": torch.where(go_dl, GL + Gm[..., None], GL),
            "HL": torch.where(go_dl, HL + Hm[..., None], HL),
            "Gp": Gp, "Hp": Hp, "parent": parent}


def route(codes: Tensor, node: Tensor, feature: Tensor, threshold: Tensor,
          is_cat: Tensor, default_left: Tensor, missing_bin: int) -> Tensor:
    """Each record's level-local child: ``2 * node + (0 left, 1 right)``
    under the level's (NN,) splits; a node with feature -1 sends all left."""
    idx = node.long()
    f = feature[idx].long()
    code = codes.gather(1, f.clamp(min=0)[:, None])[:, 0].long()
    thr = threshold[idx].long()
    left = torch.where(is_cat[idx] == 1, code == thr, code <= thr)
    left = torch.where(code == missing_bin, default_left[idx] == 1, left)
    left = torch.where(f < 0, True, left)
    return 2 * node + (~left).long()


# -- whole trees ---------------------------------------------------------------------
def grow_tree(codes: Tensor, g: Tensor, h: Tensor, *, depth: int,
              n_bins: int, is_cat: Tensor, lambda_: float, gamma: float,
              min_child_weight: float, learning_rate: float,
              dtype=torch.float64) -> Dict[str, Tensor]:
    """One depthwise tree over (n,) g and h, its sums in ``dtype``; ties
    take the first field and bin."""
    dev, n = codes.device, codes.shape[0]
    n_int, n_leaf = 2 ** depth - 1, 2 ** depth
    i32 = dict(dtype=torch.int32, device=dev)
    tree = {"feature": torch.full((n_int,), -1, **i32),
            "threshold": torch.zeros((n_int,), **i32),
            "is_cat": torch.zeros((n_int,), **i32),
            "default_left": torch.zeros((n_int,), **i32)}
    leaf = torch.zeros(n_leaf, dtype=dtype, device=dev)
    settled = torch.zeros(n_leaf, dtype=torch.bool, device=dev)
    node = torch.zeros(n, dtype=torch.long, device=dev)
    is_cat = is_cat.to(device=dev, dtype=torch.bool)
    for level in range(depth):
        nn = 2 ** level
        reps = 2 ** (depth - level)
        hist = level_hist(codes, g, h, node, nn, n_bins, dtype)
        c = candidates(hist, is_cat, lambda_, gamma, min_child_weight)
        flat = c["gain"].reshape(nn, -1)
        best = flat.argmax(dim=1)
        f_best, t_best = best // (n_bins - 1), best % (n_bins - 1)
        gain = flat.gather(1, best[:, None])[:, 0]
        gain = torch.where(torch.isfinite(gain), gain, -1.0)
        resolved = settled[torch.arange(nn, device=dev) * reps]
        split = (gain > 0) & ~resolved
        new_leaf = (~split & ~resolved).repeat_interleave(reps)
        w = -c["Gp"] / (c["Hp"] + lambda_)
        leaf = torch.where(new_leaf & ~settled, w.repeat_interleave(reps)
                           .to(dtype), leaf)
        settled = settled | new_leaf
        off = nn - 1
        tree["feature"][off:off + nn] = torch.where(split, f_best, -1).int()
        tree["threshold"][off:off + nn] = t_best.int()
        tree["is_cat"][off:off + nn] = is_cat[f_best].int()
        go = c["go_dl"].reshape(nn, -1).gather(1, best[:, None])[:, 0]
        tree["default_left"][off:off + nn] = go.int()
        node = route(codes, node, *[tree[k][off:off + nn] for k in
                                    ("feature", "threshold", "is_cat",
                                     "default_left")], n_bins - 1)
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    G = torch.bincount(node, weights=g.to(acc), minlength=n_leaf)
    H = torch.bincount(node, weights=h.to(acc), minlength=n_leaf)
    bottom = (-G / (H + lambda_)).to(dtype)
    leaf = torch.where(settled, leaf, bottom)
    tree["leaf_value"] = (leaf * learning_rate).to(dtype)
    return tree


def judge_tree(codes: Tensor, g: Tensor, h: Tensor, tree: Dict[str, Tensor],
               *, n_bins: int, is_cat: Tensor, lambda_: float, gamma: float,
               min_child_weight: float, learning_rate: float
               ) -> Tuple[List[float], Tensor]:
    """Follow ``tree``'s own splits over the records, with float64 sums.

    Returns (gaps, expected leaves).  A gap is, at each node a split or
    a leaf was decided, how far the gain of what the tree chose lies below
    the best candidate's gain, over the larger of the parent's score and
    the best candidate's children's scores (the size of the terms whose
    rounding a gain inherits).  The expected leaves (2^D,) are the
    weights of the tree's own leaves from float64 sums, times the rate.
    """
    dev, n = codes.device, codes.shape[0]
    depth = int(tree["leaf_value"].shape[-1]).bit_length() - 1
    n_leaf = 2 ** depth
    is_cat = is_cat.to(device=dev, dtype=torch.bool)
    g, h = g.to(torch.float64), h.to(torch.float64)
    node = torch.zeros(n, dtype=torch.long, device=dev)
    resolved = torch.zeros(1, dtype=torch.bool, device=dev)
    expected = torch.full((n_leaf,), float("nan"), dtype=torch.float64,
                          device=dev)
    gaps: List[Tensor] = []
    for level in range(depth):
        nn = 2 ** level
        reps = 2 ** (depth - level)
        off = nn - 1
        tab = {k: tree[k][off:off + nn].to(dev) for k in
               ("feature", "threshold", "is_cat", "default_left")}
        c = candidates(level_hist(codes, g, h, node, nn, n_bins), is_cat,
                       lambda_, gamma, min_child_weight)
        flat = c["gain"].reshape(nn, -1)
        best_i = flat.argmax(dim=1)
        best = flat.gather(1, best_i[:, None])[:, 0]
        gl = c["GL"].reshape(nn, -1).gather(1, best_i[:, None])[:, 0]
        hl = c["HL"].reshape(nn, -1).gather(1, best_i[:, None])[:, 0]
        gr, hr = c["Gp"] - gl, c["Hp"] - hl
        children = gl ** 2 / (hl + lambda_) + gr ** 2 / (hr + lambda_)
        scale = torch.maximum(c["parent"],
                              torch.where(torch.isfinite(best), children, 0))
        best = torch.where(torch.isfinite(best), best, 0.0)
        f = tab["feature"].long().clamp(min=0)
        t = tab["threshold"].long().clamp(0, n_bins - 2)
        pick = (torch.arange(nn, device=dev), f, t)
        chosen = torch.where(tab["default_left"] == 1, c["raw_l"][pick],
                             c["raw_r"][pick])
        split = tab["feature"] >= 0
        shortfall = torch.where(split, best - chosen, best.clamp(min=0.0))
        live = ~resolved & (scale > 0)
        gaps.append(torch.where(live, shortfall / torch.where(
            scale > 0, scale, 1.0), 0.0))
        leaf_here = (~split & ~resolved)
        w = (-c["Gp"] / (c["Hp"] + lambda_)) * learning_rate
        fill = leaf_here.repeat_interleave(reps)
        expected = torch.where(fill & torch.isnan(expected),
                               w.repeat_interleave(reps), expected)
        resolved = (resolved | ~split).repeat_interleave(2)
        node = route(codes, node, tab["feature"], tab["threshold"],
                     tab["is_cat"], tab["default_left"], n_bins - 1)
    G = torch.bincount(node, weights=g, minlength=n_leaf)
    H = torch.bincount(node, weights=h, minlength=n_leaf)
    expected = torch.where(torch.isnan(expected),
                           -G / (H + lambda_) * learning_rate, expected)
    return [float(x) for x in torch.cat(gaps).cpu()], expected


def stack_trees(trees: List[Dict[str, Tensor]]) -> Dict[str, Tensor]:
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def walk(trees: Dict[str, Tensor], codes: Tensor, base: Tensor, K: int,
         missing_bin: int, dtype=torch.float64) -> Tensor:
    """(n, K) margins of stacked ``trees`` over ``codes``: ``base`` plus
    each record's leaves in ``dtype``; in float64 the leaves of a block
    of rows are summed at once, below it added tree by tree in tree
    order."""
    dev = codes.device
    T = trees["feature"].shape[0]
    depth = int(trees["leaf_value"].shape[-1]).bit_length() - 1
    n_int = 2 ** depth - 1
    tab = {k: trees[k].to(dev).T.long() for k in
           ("feature", "threshold", "is_cat", "default_left")}
    leaves_t = trees["leaf_value"].to(dev).T.to(dtype)      # (2^D, T)
    n = codes.shape[0]
    out = torch.empty((n, K), dtype=dtype, device=dev)
    block = max(1, WALK_ELEMS // max(T, 1))
    for lo in range(0, n, block):
        c = codes[lo:lo + block].long()
        node = torch.zeros((c.shape[0], T), dtype=torch.long, device=dev)
        for _ in range(depth):
            f = tab["feature"].gather(0, node)
            code = c.gather(1, f.clamp(min=0))
            thr = tab["threshold"].gather(0, node)
            left = torch.where(tab["is_cat"].gather(0, node) == 1,
                               code == thr, code <= thr)
            left = torch.where(code == missing_bin,
                               tab["default_left"].gather(0, node) == 1, left)
            left = torch.where(f < 0, True, left)
            node = 2 * node + 2 - left.long()
        vals = leaves_t.gather(0, node - n_int)             # (b, T)
        m = base.to(device=dev, dtype=dtype).reshape(1, K).repeat(
            vals.shape[0], 1)
        if dtype == torch.float64:
            m += vals.reshape(-1, T // K, K).sum(1)
        else:
            for t in range(T):
                m[:, t % K] += vals[:, t]
        out[lo:lo + block] = m
    return out

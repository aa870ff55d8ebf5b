"""Missing values, many-category fields and a squared-error loss: the
port's binning, split search, partition and step ⑤ held against the plain
float64 reference (``bench/reference``: ``gbdt`` for binning, the grower's
judge and the walk, ``squared`` for the loss).

Seeded tables are the port's ``make_tabular`` at a small size (4 numeric
and 4 categorical fields of 40 categories, 5 % of every field missing,
``reg:squarederror``, depth 4, 3 rounds); two hand-built tables force a
split whose missing bin has to go one way, and a categorical split on a
category other than 0 or 1.  Each check takes the device it runs on: the
card's twins in ``tests/test_torch_cuda.py`` call them on CUDA.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from bench.reference import gbdt as ref  # noqa: E402
from bench.reference import squared  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core.binning import Binner  # noqa: E402
from repro_torch.core.gbdt import GBDTConfig, train  # noqa: E402
from repro_torch.data import make_tabular  # noqa: E402

N_BINS = 256
DEPTH = 4
ROUNDS = 3
CONFIG = GBDTConfig(objective="reg:squarederror", n_trees=ROUNDS,
                    max_depth=DEPTH, learning_rate=0.1, lambda_=1.0,
                    gamma=0.0, min_child_weight=1.0)
SEEDS = [2 ** 31 + 5, 2 ** 33 + 17]
TREE_FIELDS = ("feature", "threshold", "is_cat", "default_left",
               "leaf_value")


def seeded_table(seed, n=20_000):
    """The raw table in float32, as the card holds it."""
    X, y, cats = make_tabular(n, 4, 4, n_cats=40, task="regression",
                              missing_rate=0.05, seed=seed)
    return X.astype(np.float32), y, cats


def _binned(X, cats, device):
    """The port's binner fitted on the host, the table binned on
    ``device`` by ``transform_chunk``, and the reference's codes."""
    binner = Binner(N_BINS, cats).fit(X)
    ds = binner.transform(X, packed=False, device=device)
    Xt = torch.as_tensor(X, dtype=torch.float32)
    want = ref.bin_codes(Xt, binner._edges, binner._is_cat,
                         binner._n_value_bins, N_BINS)
    return binner, ds, want


def _kw(cats, F):
    is_cat = torch.zeros(F, dtype=torch.bool)
    is_cat[list(cats)] = True
    return dict(n_bins=N_BINS, is_cat=is_cat, lambda_=CONFIG.lambda_,
                gamma=CONFIG.gamma, min_child_weight=CONFIG.min_child_weight,
                learning_rate=CONFIG.learning_rate)


def _trees(res):
    return {k: getattr(res.model.trees, k).cpu() for k in TREE_FIELDS}


def check_codes(seed, device):
    X, _, cats = seeded_table(seed)
    binner, ds, want = _binned(X, cats, device)
    assert torch.equal(ds.codes.cpu(), want)
    assert torch.equal(ds.codes_cm.cpu(), want.T)
    chunk = binner.transform_chunk(
        torch.as_tensor(X, dtype=torch.float32, device=device))
    assert torch.equal(chunk.cpu(), want)
    # every field holds missing values, every categorical field 40 codes
    assert bool((want == N_BINS - 1).any(0).all())
    for f in cats:
        assert want[:, f][want[:, f] != N_BINS - 1].unique().numel() == 40


def check_fit(seed, device):
    """Each judged node's gain within rounding of the reference's best
    candidate, the leaves, the loss after each round and the final
    margins against float64 walks of the port's own trees."""
    X, y, cats = seeded_table(seed)
    _, ds, codes = _binned(X, cats, device)
    yt = torch.as_tensor(y, dtype=torch.float32)
    res = train(CONFIG, ds, yt, device=device)
    trees, kw = _trees(res), _kw(cats, X.shape[1])
    assert float(res.model.base_margin) == pytest.approx(
        float(squared.base_margin(yt)), rel=1e-6)
    m = squared.base_margin(yt).reshape(1, 1).repeat(len(y), 1)
    zero = torch.zeros(1, dtype=torch.float64)
    splits = {"cat": 0, "left": 0}
    for r in range(ROUNDS):
        g, h = squared.grad_hess(m, yt)
        tree = {k: v[r] for k, v in trees.items()}
        gaps, expected = ref.judge_tree(codes, g[:, 0], h[:, 0], tree, **kw)
        assert max(gaps) <= 1e-5, (r, max(gaps))
        assert torch.allclose(tree["leaf_value"].double(), expected,
                              rtol=1e-4, atol=1e-6), r
        split = tree["feature"] >= 0
        splits["cat"] += int((split & (tree["is_cat"] == 1)).sum())
        splits["left"] += int((split & (tree["default_left"] == 1)).sum())
        m = m + ref.walk({k: v[r:r + 1] for k, v in trees.items()}, codes,
                         zero, 1, N_BINS - 1)
        want = squared.loss(m, yt)
        assert res.history["train_loss"][r] == pytest.approx(want, rel=1e-5)
    # the fit decides on categories and on missing directions
    assert splits["cat"] > 0 and splits["left"] > 0, splits
    assert torch.allclose(res.margins.cpu().double().reshape(-1, 1), m,
                          rtol=0, atol=1e-5)
    scored = res.model.predict_margin(ds)
    assert torch.allclose(scored.cpu().double().reshape(-1, 1), m, rtol=0,
                          atol=1e-5)


def missing_table(way, n=4000, seed=11):
    """Field 0 (whole numbers from -20 to 19) splits the label between
    -1 and 0; its missing records carry the label of the side ``way``, so
    the best split sends them there.  Field 1 is numeric noise, field 2
    categorical noise."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.integers(-20, 20, n).astype(np.float64),
                  rng.normal(size=n),
                  rng.integers(0, 40, n).astype(np.float64)], 1)
    y = np.where(X[:, 0] < 0.0, 5.0, -5.0) + 0.01 * rng.normal(size=n)
    miss = rng.uniform(size=n) < 0.2
    X[miss, 0] = np.nan
    y[miss] = (5.0 if way == "left" else -5.0) + 0.01 * rng.normal(
        size=miss.sum())
    return X.astype(np.float32), y, [2], miss


def category_table(cat, n=4000, seed=13):
    """Field 2 (40 categories) marks category ``cat`` and its missing
    records with a high label; fields 0 and 1 are numeric noise."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.normal(size=n), rng.normal(size=n),
                  rng.integers(0, 40, n).astype(np.float64)], 1)
    y = np.where(X[:, 2] == cat, 8.0, 0.0) + 0.01 * rng.normal(size=n)
    miss = rng.uniform(size=n) < 0.05
    X[miss, 2] = np.nan
    y[miss] = 8.0 + 0.01 * rng.normal(size=miss.sum())
    return X.astype(np.float32), y, [2], miss | (X[:, 2] == cat)


def check_root(X, y, cats, left, want_root, device):
    """The port's root split is ``want_root`` (feature, threshold, is_cat,
    default_left), as the float64 reference grower's is, and the records
    ``left`` are routed left, at training and at scoring, as the
    reference routes them."""
    _, ds, codes = _binned(X, cats, device)
    yt = torch.as_tensor(y, dtype=torch.float32)
    res = train(GBDTConfig(objective="reg:squarederror", n_trees=1,
                           max_depth=1), ds, yt, device=device)
    trees = _trees(res)
    root = tuple(int(trees[k][0, 0]) for k in TREE_FIELDS[:4])
    assert root == want_root
    m = squared.base_margin(yt).reshape(1, 1).repeat(len(y), 1)
    g, h = squared.grad_hess(m, yt)
    mine = ref.grow_tree(codes, g[:, 0], h[:, 0], depth=1,
                         **_kw(cats, X.shape[1]))
    assert tuple(int(mine[k][0]) for k in TREE_FIELDS[:4]) == want_root
    leaves = trees["leaf_value"][0].double()
    base = float(res.model.base_margin)
    want = base + torch.where(torch.as_tensor(left), leaves[0], leaves[1])
    walked = ref.walk({k: v for k, v in trees.items()}, codes,
                      torch.tensor([base], dtype=torch.float64), 1,
                      N_BINS - 1)[:, 0]
    assert torch.allclose(walked, want, rtol=0, atol=1e-6)
    for got in (res.margins, res.model.predict_margin(ds)):
        assert torch.allclose(got.cpu().double(), want, rtol=0, atol=1e-5)


def check_missing_split(way, device):
    X, y, cats, miss = missing_table(way)
    binner = Binner(N_BINS, cats).fit(X)
    # field 0's threshold: the code of -1, the largest value sent left
    thr = int(binner.transform_codes(np.array([[-1.0, 0.0, 0.0]]))[0, 0])
    left = np.where(miss, way == "left", X[:, 0] < 0.0)
    check_root(X, y, cats, left, (0, thr, 0, int(way == "left")), device)


def check_category_split(cat, device):
    X, y, cats, left = category_table(cat)
    check_root(X, y, cats, left, (2, cat, 1, 1), device)


def check_counters(device):
    """A fit adds its splits, its categorical splits and its splits that
    send the missing bin left to the process's counters, once; on the card
    also the levels its histogram built by exact subtraction and their
    pairs, and nothing else."""
    X, y, cats = seeded_table(SEEDS[0], n=5000)
    _, ds, _ = _binned(X, cats, device)
    before = obs.counts()
    res = train(CONFIG, ds, torch.as_tensor(y, dtype=torch.float32),
                device=device)
    grown = obs.delta(before)
    hist = {k: grown.pop(k) for k in ("hist.levels_subtracted",
                                      "hist.pairs_binned", "hist.pairs_total")
            if k in grown}
    if torch.device(device).type == "cuda":
        levels = ROUNDS * (DEPTH - 1)
        assert hist["hist.levels_subtracted"] == levels
        assert hist["hist.pairs_total"] == levels * len(y)
        assert 0 < 2 * hist["hist.pairs_binned"] <= hist["hist.pairs_total"]
    else:
        assert hist == {}
    t = res.model.trees
    split = t.feature >= 0
    assert grown == {
        "tree.splits": int(split.sum()),
        "tree.splits_categorical": int((split & (t.is_cat == 1)).sum()),
        "tree.splits_default_left": int((split & (t.default_left == 1))
                                        .sum())}
    assert 0 < grown["tree.splits_categorical"] < grown["tree.splits"]
    assert 0 < grown["tree.splits_default_left"] < grown["tree.splits"]


@pytest.mark.parametrize("seed", SEEDS)
def test_codes_equal_the_reference_binning(seed):
    check_codes(seed, "cpu")


@pytest.mark.parametrize("seed", SEEDS)
def test_fit_holds_to_the_float64_reference(seed):
    check_fit(seed, "cpu")


@pytest.mark.parametrize("way", ["left", "right"])
def test_missing_records_follow_the_better_side(way):
    check_missing_split(way, "cpu")


@pytest.mark.parametrize("cat", [17, 39])
def test_categorical_split_on_a_high_category(cat):
    check_category_split(cat, "cpu")


def test_fit_counts_its_splits():
    check_counters("cpu")

"""The plain reference held against the port's plain CPU path at tiny
sizes: binning, the loss, the grower and its judge, the ensemble walk."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import load
from bench.measure import data
from bench.reference import gbdt as ref
from repro_torch.core import losses
from repro_torch.core.gbdt import train

ROOT = Path(__file__).resolve().parents[2]
CONFIGS = {c: json.loads((ROOT / f"bench/configs/{c}.json").read_text())
           for c in ("higgs", "covertype")}


def _table(name, n=3000, seed=2 ** 31 + 3):
    cfg = CONFIGS[name]
    t = data.make_table(cfg, n, seed, "cpu")
    edges, nvb = data.quantile_edges(t.X, t.is_cat, cfg["max_bins"])
    return cfg, t, edges, nvb


@pytest.mark.parametrize("name", ["higgs", "covertype"])
def test_binning_equals_the_port(name):
    cfg, t, edges, nvb = _table(name)
    X = t.X.clone()
    X[::7, 0] = float("nan")                  # missing values take the last bin
    binner, _ = load.program_dataset(t.X, t.is_cat, edges, nvb, 256)
    got = ref.bin_codes(X, edges, t.is_cat, nvb, 256)
    assert torch.equal(got, binner.transform_chunk(X))
    assert np.array_equal(got.numpy(), binner.transform_codes(X.numpy()))
    assert torch.equal(got, binner.transform_codes_device(X, device="cpu"))


@pytest.mark.parametrize("K", [1, 5])
def test_loss_pieces_equal_the_port(K):
    gen = torch.Generator().manual_seed(1)
    m = torch.randn(500, K, generator=gen, dtype=torch.float64)
    y = torch.randint(0, max(K, 2), (500,), generator=gen).double()
    loss = losses.get_loss("binary:logistic" if K == 1 else "multi:softmax",
                           K if K > 1 else None)
    g, h = ref.grad_hess(m, y)
    pg, ph = loss.grad_hess(m[:, 0] if K == 1 else m, y)
    assert torch.allclose(g, pg.reshape(g.shape), rtol=0, atol=1e-15)
    assert torch.allclose(h, ph.reshape(h.shape), rtol=0, atol=1e-15)
    assert ref.loss(m, y) == pytest.approx(
        float(loss.value(m[:, 0] if K == 1 else m, y).mean()), rel=1e-12)
    assert torch.allclose(ref.base_margin(y, K).float(),
                          torch.as_tensor(loss.base_margin(y.float()))
                          .reshape(-1).float(), atol=1e-6)


def _port_fit(name, rounds=3):
    cfg, t, edges, nvb = _table(name)
    _, ds = load.program_dataset(t.X, t.is_cat, edges, nvb, 256)
    res = train(load.gbdt_config(cfg, {}, 0, rounds), ds, t.y, device="cpu")
    codes = ref.bin_codes(t.X, edges, t.is_cat, nvb, 256)
    return cfg, t, codes, res, ds


def _kw(cfg, t):
    tr = cfg["train"]
    return dict(n_bins=256, is_cat=torch.as_tensor(t.is_cat),
                lambda_=tr["lambda_"], gamma=tr["gamma"],
                min_child_weight=tr["min_child_weight"],
                learning_rate=tr["learning_rate"])


@pytest.mark.parametrize("name", ["higgs", "covertype"])
def test_grower_grows_the_ports_trees(name):
    """Round 0 of the port's fit and the reference's trees: the same
    splits at the top (deeper, a few thousand records leave near-ties that
    float32 sums may break either way), and under the float64 judge no
    node of either lies more than rounding below its best gain; the
    reference's float64 tree is its judge's own choice exactly."""
    cfg, t, codes, res, _ = _port_fit(name, rounds=1)
    K = load.n_classes(cfg)
    m = ref.base_margin(t.y, K).reshape(1, K).repeat(t.y.shape[0], 1)
    g, h = ref.grad_hess(m, t.y)
    trees = load.tree_dict(res.model.trees)
    for k in range(K):
        port = {f: v[k] for f, v in trees.items()}
        mine = ref.grow_tree(codes, g[:, k].float(), h[:, k].float(),
                             depth=cfg["train"]["max_depth"],
                             dtype=torch.float32,
                             **_kw(cfg, t))
        exact = ref.grow_tree(codes, g[:, k], h[:, k],
                              depth=cfg["train"]["max_depth"], **_kw(cfg, t))
        assert torch.equal(mine["feature"][:3], port["feature"][:3])
        for tree, most in ((port, 1e-5), (mine, 1e-5), (exact, 0.0)):
            gaps, expected = ref.judge_tree(codes, g[:, k], h[:, k], tree,
                                            **_kw(cfg, t))
            assert max(gaps) <= most
            assert torch.allclose(expected.float(), tree["leaf_value"].float(),
                                  rtol=1e-4, atol=1e-7)


def test_judge_finds_a_wrong_split():
    cfg, t, codes, res, _ = _port_fit("higgs", rounds=1)
    m = ref.base_margin(t.y, 1).reshape(1, 1).repeat(t.y.shape[0], 1)
    g, h = ref.grad_hess(m, t.y)
    tree = {f: v[0].clone() for f, v in load.tree_dict(res.model.trees).items()}
    tree["threshold"][0] = (tree["threshold"][0] + 60) % 250
    gaps, _ = ref.judge_tree(codes, g[:, 0], h[:, 0], tree, **_kw(cfg, t))
    assert gaps[0] > 1e-3


@pytest.mark.parametrize("name", ["higgs", "covertype"])
def test_walk_equals_the_ports_margins(name):
    cfg, t, codes, res, ds = _port_fit(name)
    K = load.n_classes(cfg)
    base = ref.base_margin(t.y, K)
    walked = ref.walk(load.tree_dict(res.model.trees), codes, base, K, 255)
    port = res.model.predict_margin(ds)
    assert torch.allclose(port.double().reshape(walked.shape), walked,
                          rtol=0, atol=1e-5)
    assert torch.allclose(res.margins.double().reshape(walked.shape), walked,
                          rtol=0, atol=1e-5)
    low = ref.walk(load.tree_dict(res.model.trees), codes, base, K, 255,
                   dtype=torch.bfloat16)
    assert (low.double() - walked).abs().max() > 1e-4

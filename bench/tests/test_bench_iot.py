"""The ``iot`` configuration and its cell ``iot.train``: 115 numeric
fields at 16 bins, so both copies of the codes are 4-bit packed.  The
generator keeps its shape; the plain reference holds the port's packed
path at tiny sizes; the cell's check passes the program and fails the
control and each planted fault; the 4-bit counts of
``bench/measure/packed.py``; the ``unpacks_per_round`` reader."""
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import load
from bench.faults import FAULTS, planted
from bench.measure import data, packed, roofline
from bench.reference import gbdt as ref
from bench.run import Context, run_cell
from bench.spec import Spec
from repro_torch import obs
from repro_torch.core.binning import PackedCodes, as_unpacked
from repro_torch.core.gbdt import train

ROOT = Path(__file__).resolve().parents[2]
IOT = json.loads((ROOT / "bench/configs/iot.json").read_text())
# the tiny shape: the 115 fields and 16 bins kept, records and rounds cut
TINY_IOT = {"n_records": 4000, "train": {"n_trees": 4}}
CELL = "iot.train"
SEED = 2 ** 31 + 977


def test_generator_is_seeded_and_keeps_the_published_shape():
    a = data.make_table(IOT, 3000, 2 ** 31 + 11, "cpu")
    b = data.make_table(IOT, 3000, 2 ** 31 + 11, "cpu")
    c = data.make_table(IOT, 3000, 2 ** 31 + 12, "cpu")
    assert torch.equal(a.X, b.X) and torch.equal(a.y, b.y)
    assert not torch.equal(a.X, c.X)
    assert a.X.shape == (3000, 115) and a.X.dtype == torch.float32
    assert not np.any(a.is_cat)
    assert set(a.y.unique().tolist()) == {0.0, 1.0}


# --- the plain reference against the port's packed path -----------------

def _table(n=3000, seed=2 ** 31 + 3):
    t = data.make_table(IOT, n, seed, "cpu")
    edges, nvb = data.quantile_edges(t.X, t.is_cat, IOT["max_bins"])
    return t, edges, nvb


def test_binning_equals_the_ports_packed_codes():
    t, edges, nvb = _table()
    X = t.X.clone()
    X[::7, 0] = float("nan")                  # missing values take the last bin
    nb = IOT["max_bins"]
    binner, ds = load.program_dataset(X, t.is_cat, edges, nvb, nb)
    assert isinstance(ds.codes, PackedCodes)
    assert isinstance(ds.codes_cm, PackedCodes)
    got = ref.bin_codes(X, edges, t.is_cat, nvb, nb)
    assert torch.equal(got, as_unpacked(ds.codes))
    assert torch.equal(got.T, as_unpacked(ds.codes_cm))
    assert torch.equal(got, binner.transform_chunk(X))
    assert np.array_equal(got.numpy(), binner.transform_codes(X.numpy()))
    assert torch.equal(got, binner.transform_codes_device(X, device="cpu"))


def _port_fit(rounds=3):
    t, edges, nvb = _table()
    nb = IOT["max_bins"]
    _, ds = load.program_dataset(t.X, t.is_cat, edges, nvb, nb)
    res = train(load.gbdt_config(IOT, {}, 0, rounds), ds, t.y, device="cpu")
    codes = ref.bin_codes(t.X, edges, t.is_cat, nvb, nb)
    return t, codes, res, ds


def _kw(t):
    tr = IOT["train"]
    return dict(n_bins=IOT["max_bins"], is_cat=torch.as_tensor(t.is_cat),
                lambda_=tr["lambda_"], gamma=tr["gamma"],
                min_child_weight=tr["min_child_weight"],
                learning_rate=tr["learning_rate"])


def test_grower_grows_the_ports_trees():
    """Round 0 of the port's fit on packed codes and the reference's
    trees: the same splits at the top, and under the float64 judge no node
    of either lies more than rounding below its best gain."""
    t, codes, res, _ = _port_fit(rounds=1)
    m = ref.base_margin(t.y, 1).reshape(1, 1).repeat(t.y.shape[0], 1)
    g, h = ref.grad_hess(m, t.y)
    port = {f: v[0] for f, v in load.tree_dict(res.model.trees).items()}
    depth = IOT["train"]["max_depth"]
    mine = ref.grow_tree(codes, g[:, 0].float(), h[:, 0].float(),
                         depth=depth, dtype=torch.float32, **_kw(t))
    exact = ref.grow_tree(codes, g[:, 0], h[:, 0], depth=depth, **_kw(t))
    assert torch.equal(mine["feature"][:3], port["feature"][:3])
    for tree, most in ((port, 1e-5), (mine, 1e-5), (exact, 0.0)):
        gaps, expected = ref.judge_tree(codes, g[:, 0], h[:, 0], tree,
                                        **_kw(t))
        assert max(gaps) <= most
        assert torch.allclose(expected.float(), tree["leaf_value"].float(),
                              rtol=1e-4, atol=1e-7)


def test_walk_equals_the_ports_margins():
    t, codes, res, ds = _port_fit()
    mb = IOT["max_bins"] - 1
    base = ref.base_margin(t.y, 1)
    walked = ref.walk(load.tree_dict(res.model.trees), codes, base, 1, mb)
    port = res.model.predict_margin(ds)
    assert torch.allclose(port.double().reshape(walked.shape), walked,
                          rtol=0, atol=1e-5)
    assert torch.allclose(res.margins.double().reshape(walked.shape), walked,
                          rtol=0, atol=1e-5)
    low = ref.walk(load.tree_dict(res.model.trees), codes, base, 1, mb,
                   dtype=torch.bfloat16)
    assert (low.double() - walked).abs().max() > 1e-4


# --- the cell's check, through whole runs at a tiny size -----------------

@pytest.fixture
def tiny_iot(tiny_bench):
    """``tiny_bench`` with the ``iot`` configuration cut to ``TINY_IOT``."""
    path = tiny_bench / "configs" / "iot.json"
    cfg = json.loads(path.read_text())
    cfg.update(TINY_IOT, train=dict(cfg["train"], **TINY_IOT["train"]))
    path.write_text(json.dumps(cfg))
    return tiny_bench


def _run(bench_dir, control=None, seconds=0.5):
    spec = Spec(bench_dir)
    result, checks, _ = run_cell(spec, CELL, SEED, seconds, False, ["cpu"],
                                 time.perf_counter(), control=control)
    return result, {n: (v, lim) for n, v, lim in checks}


def test_program_is_correct(tiny_iot):
    result, checks = _run(tiny_iot)
    assert result["correct"], checks
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checks"


def test_control_is_not_correct(tiny_iot):
    result, checks = _run(tiny_iot, control="bf16")
    assert not result["correct"], checks


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_is_not_correct(tiny_iot, fault):
    spec = Spec(tiny_iot)
    kind = spec.kind(spec.traffic(spec.cell(CELL)["traffic"])["kind"])
    with planted(fault, kind):
        result, checks = _run(tiny_iot)
    assert not result["correct"], (fault, checks)


# --- the 4-bit counts -----------------------------------------------------

def test_packed_counts_by_hand_at_16_bins():
    # n = 100, F = 5, K = 2, 16 bins: each code half a byte
    hr = packed.histogram_round(100, 5, 2, 2, 16)
    assert hr.bytes == 2 * (100 * 5 / 2 + 12 * 100 * 2) \
        + 8 * 2 * (1 + 2) * 5 * 16
    assert hr.ops == 2 * (2 * 100 * 5 * 2)
    # one level deep: g/h, the level (codes halved, the partition's code
    # 8.5 bytes a record and class), leaf sums, step 5 (the row halved)
    r = packed.round_work(100, 5, 2, 1, 16)
    want_bytes = (800 + 400 + 1600) + (250 + 2400 + 8 * 2 * 1 * 5 * 16) \
        + (8 * 2 * 1 * 5 * 16 + 32 * 2) + 8.5 * 100 * 2 \
        + (2400 + 8 * 2 * 2) + (250 + 1600)
    want_ops = 2000 + 2000 + 20 * 2 * 5 * 16 + 200 + 400 + 8 * 200
    assert (r.bytes, r.ops) == (want_bytes, want_ops)
    assert roofline.round_work(100, 5, 2, 1, 16).bytes - r.bytes \
        == 0.5 * (100 * 5 + 100 * 2 + 100 * 5)


@pytest.mark.parametrize("n_bins", [17, 64, 256])
def test_packed_counts_equal_the_byte_counts_above_16_bins(n_bins):
    for n, F, K, depth in ((1000, 28, 1, 6), (581, 54, 7, 3)):
        assert packed.histogram_round(n, F, K, depth, n_bins) == \
            roofline.histogram_round(n, F, K, depth, n_bins)
        assert packed.round_work(n, F, K, depth, n_bins) == \
            roofline.round_work(n, F, K, depth, n_bins)


# --- the reader of the program's codes.unpack spans -----------------------

def test_unpacks_per_round_none_zero_and_exact(monkeypatch):
    read = Spec().reader("unpacks_per_round").read
    ctx = Context(None, {}, {})
    monkeypatch.setattr(obs, "_rows", {})
    monkeypatch.setattr(obs, "_enabled", True)
    assert read(ctx) is None                      # no round recorded
    for _ in range(4):
        with obs.span("gbdt.round"):
            pass
    assert read(ctx) == 0.0                       # rounds, and no unpack
    for _ in range(6):
        with obs.span("gbdt.round"):
            with obs.span("tree.grow"):
                with obs.span("codes.unpack"):
                    pass
    with obs.span("codes.unpack"):
        pass
    assert read(ctx) == 7 / 10


def test_unpacks_per_round_none_without_the_span(monkeypatch):
    from repro_torch.core import binning
    monkeypatch.delattr(binning, "UNPACK_SPAN")
    monkeypatch.setattr(obs, "_rows", {"gbdt.round": [3, 30, 30]})
    assert Spec().reader("unpacks_per_round").read(Context(None, {}, {})) \
        is None

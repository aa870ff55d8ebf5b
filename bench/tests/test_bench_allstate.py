"""The ``allstate`` configuration and its cell ``allstate.train_mixed``:
16 numeric and 16 forty-category fields, 5 % of every field missing, a
squared-error loss.  The table maker keeps its shape and its edges skip
the missing values; the squared-error reference states the port's loss;
the kind refuses an objective it cannot judge; the cell's check passes
the program and fails the control and each planted fault; the byte
count and reader of ``split_roofline``."""
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from bench.faults import FAULTS, planted
from bench.measure import mixed, profile, roofline, splits
from bench.reference import gbdt as ref
from bench.reference import squared
from bench.run import Context, run_cell
from bench.spec import Spec
from repro_torch.core import losses

ROOT = Path(__file__).resolve().parents[2]
ALLSTATE = json.loads((ROOT / "bench/configs/allstate.json").read_text())
# the tiny shape: the 32 fields, 40 categories and 5 % kept; records and
# rounds cut
TINY_ALLSTATE = {"n_records": 6000, "train": {"n_trees": 4}}
CELL = "allstate.train_mixed"
SEED = 2 ** 31 + 1201


def _table(n=4000, seed=2 ** 31 + 41):
    return mixed.make_table(ALLSTATE, n, seed, "cpu")


def test_generator_is_seeded_and_keeps_the_published_shape():
    a, b, c = _table(), _table(), _table(seed=2 ** 31 + 42)
    assert torch.equal(a.X.nan_to_num(-1), b.X.nan_to_num(-1))
    assert torch.equal(a.y, b.y)
    assert not torch.equal(a.X.nan_to_num(-1), c.X.nan_to_num(-1))
    assert a.X.shape == (4000, 32) and a.X.dtype == torch.float32
    assert list(a.is_cat) == [False] * 16 + [True] * 16
    miss = torch.isnan(a.X).double().mean(0)
    assert bool(((miss > 0.03) & (miss < 0.07)).all()), miss
    cats = a.X[:, 16:]
    seen = cats[~torch.isnan(cats)]
    assert torch.equal(seen, seen.round())
    assert set(seen.unique().tolist()) == set(float(c) for c in range(40))
    assert len(a.y.unique()) > 1000          # a regression target


def test_edges_skip_the_missing_values():
    t = _table()
    edges, nvb = mixed.quantile_edges(t.X, t.is_cat, 40, 256)
    assert np.isfinite(edges[:16]).any(1).all()
    assert not np.isnan(edges).any()
    for f in range(16):
        col = t.X[:, f]
        col = torch.sort(col[~torch.isnan(col)]).values
        m = col.shape[0]
        cut = [min(m - 1, int(k * (m / 255))) for k in range(1, 255)]
        want = np.unique(col[cut].double().numpy())
        assert np.array_equal(edges[f, :want.size], want)
        assert np.isinf(edges[f, want.size:]).all()
        assert nvb[f] == want.size + 1
    # missing values take the last code, never a value bin
    codes = ref.bin_codes(t.X, edges, t.is_cat, nvb, 256)
    assert torch.equal(codes == 255, torch.isnan(t.X))


def test_nvb_is_the_category_count():
    t = _table()
    edges, nvb = mixed.quantile_edges(t.X, t.is_cat, 40, 256)
    assert (nvb[16:] == 40).all()
    codes = ref.bin_codes(t.X, edges, t.is_cat, nvb, 256)
    seen = codes[:, 16:][codes[:, 16:] != 255]
    assert int(seen.max()) == 39 and int(seen.min()) == 0


def test_squared_reference_states_the_ports_loss():
    gen = torch.Generator().manual_seed(5)
    y = torch.randn(1000, generator=gen) * 4
    m = torch.randn(1000, 1, generator=gen, dtype=torch.float64)
    assert float(squared.base_margin(y)) == pytest.approx(
        float(y.double().mean()), rel=1e-15)
    g, h = squared.grad_hess(m, y)
    pg, ph = losses.squared_error.grad_hess(m[:, 0], y.double())
    assert torch.equal(g[:, 0], pg) and torch.equal(h[:, 0], ph)
    want = float(losses.squared_error.value(m[:, 0], y.double()).mean())
    assert squared.loss(m, y) == pytest.approx(want, rel=1e-14)


# --- the cell's check, through whole runs at a tiny size -----------------

@pytest.fixture
def tiny_allstate(tiny_bench):
    """``tiny_bench`` with the ``allstate`` configuration cut to
    ``TINY_ALLSTATE``; its traced stretch begins at once."""
    path = tiny_bench / "configs" / "allstate.json"
    cfg = json.loads(path.read_text())
    cfg.update(TINY_ALLSTATE, train=dict(cfg["train"],
                                         **TINY_ALLSTATE["train"]))
    path.write_text(json.dumps(cfg))
    path = tiny_bench / "traffic" / "train_mixed.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()),
                                    trace_after_s=0)))
    return tiny_bench


def _run(bench_dir, control=None, seconds=0.5):
    spec = Spec(bench_dir)
    result, checks, notes = run_cell(spec, CELL, SEED, seconds, False,
                                     ["cpu"], time.perf_counter(),
                                     control=control)
    return result, {n: (v, lim) for n, v, lim in checks}, notes


def test_program_is_correct_and_counts_its_splits(tiny_allstate):
    result, checks, notes = _run(tiny_allstate)
    assert result["correct"], checks
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert set(checks) == {"codes_mismatch", "split_gap", "leaf_err",
                           "loss_err", "margin_err"}
    counts = {line.split()[0]: int(line.split()[1]) for line in notes
              if line.startswith("tree.splits")}
    assert set(counts) == {"tree.splits", "tree.splits_categorical",
                           "tree.splits_default_left"}
    assert 0 < counts["tree.splits_categorical"] < counts["tree.splits"]
    assert 0 < counts["tree.splits_default_left"] < counts["tree.splits"]


def test_control_is_not_correct(tiny_allstate):
    result, checks, _ = _run(tiny_allstate, control="bf16")
    assert not result["correct"], checks


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_is_not_correct(tiny_allstate, fault):
    spec = Spec(tiny_allstate)
    kind = spec.kind(spec.traffic(spec.cell(CELL)["traffic"])["kind"])
    with planted(fault, kind):
        result, checks, _ = _run(tiny_allstate)
    assert not result["correct"], (fault, checks)


@pytest.mark.parametrize("objective", ["reg:huber", "multi:softmax"])
def test_an_objective_the_kind_cannot_judge_is_refused(tiny_allstate,
                                                       objective):
    path = tiny_allstate / "configs" / "allstate.json"
    cfg = json.loads(path.read_text())
    cfg["train"]["objective"] = objective
    path.write_text(json.dumps(cfg))
    with pytest.raises(SystemExit, match=objective):
        _run(tiny_allstate)


def test_a_binary_objective_is_judged_by_the_logistic_reference(
        tiny_allstate):
    """``flight``'s objective: the same kind, the logistic reference."""
    path = tiny_allstate / "configs" / "allstate.json"
    cfg = json.loads(path.read_text())
    cfg["train"]["objective"] = "binary:logistic"
    path.write_text(json.dumps(cfg))
    result, checks, _ = _run(tiny_allstate)
    assert result["correct"], checks


# --- split_roofline -------------------------------------------------------

def test_split_round_bytes_by_hand():
    # K = 1, F = 2, 4 bins, depth 2: level 0 one node, level 1 two
    level0 = 8 * 1 * 2 * 4 + 48 * 1 + 5 * 4
    level1 = 8 * 2 * 2 * 4 + 48 * 2 + 5 * 4
    work = splits.split_round(1, 2, 2, 4)
    assert (work.bytes, work.ops) == (level0 + level1, 0.0)
    # the cell's shape: 63 nodes' (32 x 256) float32 histograms a round
    cell = splits.split_round(1, 32, 6, 256)
    assert cell.bytes == 63 * 32 * 256 * 8 + 63 * 48 + 6 * 5 * 64
    # the histogram's bytes are roofline.split_level's
    assert splits.split_level(3, 4, 5, 16, 3).bytes - 48 * 12 - 5 * 24 == \
        roofline.split_level(3, 4, 5, 16).bytes - 32 * 12


def test_split_roofline_reads_the_kernels_device_time():
    read = Spec().reader("split_roofline").read
    shapes = {"n": 1000, "F": 32, "K": 1, "depth": 6, "n_bins": 256}
    assert read(Context(None, shapes, {})) is None
    other = profile.Trace([(0.0, 50.0, "hist_grouped_kernel", 0)], [],
                          1.0, 2.0)
    assert read(Context(other, shapes, {})) is None
    trace = profile.Trace([(0.0, 30.0, "split_level_kernel(float const*)", 0),
                           (30.0, 50.0, "split_level_kernel(float const*)", 0),
                           (50.0, 90.0, "hist_grouped_kernel", 0)], [],
                          1.0, 2.0)
    least = splits.split_round(1, 32, 6, 256).bytes / roofline.HBM_BYTES_PER_S
    assert read(Context(trace, shapes, {})) == pytest.approx(
        100.0 * least / 25e-6)

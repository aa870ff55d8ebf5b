"""The frozen measuring pieces: the seeded generators, the roofline
counts, the trace's arithmetic, and a run with no card."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bench.measure import data, profile, roofline

ROOT = Path(__file__).resolve().parents[2]
HIGGS = json.loads((ROOT / "bench/configs/higgs.json").read_text())
COVER = json.loads((ROOT / "bench/configs/covertype.json").read_text())


@pytest.mark.parametrize("config", [HIGGS, COVER], ids=["higgs", "covertype"])
def test_generator_is_seeded_and_keeps_the_published_shape(config):
    a = data.make_table(config, 3000, 2 ** 31 + 11, "cpu")
    b = data.make_table(config, 3000, 2 ** 31 + 11, "cpu")
    c = data.make_table(config, 3000, 2 ** 31 + 12, "cpu")
    assert torch.equal(a.X, b.X) and torch.equal(a.y, b.y)
    assert not torch.equal(a.X, c.X)
    F = config["n_numeric"] + sum(config["onehot_groups"])
    assert a.X.shape == (3000, F) and a.X.dtype == torch.float32
    assert list(np.flatnonzero(a.is_cat)) == list(
        range(config["n_numeric"], F))
    K = int(config["train"].get("n_classes") or 1)
    assert set(a.y.unique().tolist()) <= set(range(max(K, 2)))
    assert len(a.y.unique()) == max(K, 2)
    col = config["n_numeric"]
    for size in config["onehot_groups"]:       # one indicator set a group
        group = a.X[:, col:col + size]
        assert torch.all(group.sum(1) == 1) and set(group.unique().tolist()) \
            == {0.0, 1.0}
        col += size


def test_quantile_edges_are_order_statistics():
    t = data.make_table(HIGGS, 5000, 7, "cpu")
    edges, nvb = data.quantile_edges(t.X, t.is_cat, 256)
    assert edges.shape == (28, 254)
    for f in range(28):
        e = edges[f, :nvb[f] - 1]
        assert np.all(np.diff(e) > 0) and np.all(np.isinf(edges[f, nvb[f] - 1:]))
        assert np.isin(e.astype(np.float32), t.X[:, f].numpy()).all()
    t = data.make_table(COVER, 2000, 7, "cpu")
    edges, nvb = data.quantile_edges(t.X, t.is_cat, 256)
    assert list(nvb[10:]) == [2] * 44 and np.isinf(edges[10:]).all()


def test_roofline_counts_by_hand():
    # n = 100, F = 4, K = 2, 8 bins, a level of 2 nodes
    h = roofline.histogram_level(100, 4, 2, 2, 8)
    assert h.bytes == 100 * 4 + 12 * 100 * 2 + 8 * 2 * 2 * 4 * 8
    assert h.ops == 2 * 100 * 4 * 2
    s = roofline.split_level(2, 2, 4, 8)
    assert s.bytes == 8 * 2 * 2 * 4 * 8 + 32 * 2 * 2 and s.ops == 20 * 128
    p = roofline.partition_level(100, 2)
    assert (p.bytes, p.ops) == (1800, 200)
    # one level deep: g/h, the level, leaf sums, step 5
    r = roofline.round_work(100, 4, 2, 1, 8)
    want_bytes = (800 + 400 + 1600) + (400 + 2400 + 512) + (512 + 64) \
        + 1800 + (2400 + 8 * 2 * 2) + (400 + 1600)
    want_ops = 2000 + 1600 + 20 * 64 + 200 + 400 + 8 * 200
    assert (r.bytes, r.ops) == (want_bytes, want_ops)
    e = roofline.ensemble(1000, 28, 500, 6)
    assert e.bytes == 1000 * 28 + 4000 + 4 * 500 * 127
    assert e.ops == 8 * 1000 * 500 * 6 and e.bound_by == "operations"
    assert e.least_s == e.ops / 67e12
    assert roofline.share(e, 2 * e.least_s) == pytest.approx(50.0)


def test_trace_union_kernels_and_idle_gaps():
    device = [(0.0, 10.0, "k1", 0), (5.0, 20.0, "k2", 0),
              (30.0, 40.0, "k1", 0), (50.0, 55.0, "Memcpy DtoH", 0)]
    host = [(18.0, 44.0, "aten::item"), (21.0, 29.0, "cudaLaunchKernel")]
    tr = profile.Trace(device, host, window_s=100e-6, units=2)
    assert tr.busy_s == pytest.approx(35e-6)
    assert len(tr.kernels()) == 3
    assert tr.device_s(("k1",)) == pytest.approx(20e-6)
    assert profile.device_ops(tr)[0] == ["k1", pytest.approx(20e-6)]
    gaps = dict(profile.idle_gaps(tr))
    assert gaps == {"cudaLaunchKernel": pytest.approx(10e-6),
                    "python": pytest.approx(10e-6)}


def test_busy_time_is_each_cards_union_averaged_over_the_cards():
    device = [(0.0, 10.0, "k", 0), (5.0, 20.0, "k", 0),    # card 0: 20 us
              (0.0, 10.0, "k", 1), (30.0, 40.0, "k", 1)]   # card 1: 20 us
    tr = profile.Trace(device, [], window_s=100e-6, units=1, chips=2)
    assert tr.busy_s == pytest.approx(20e-6)


def _run_cli(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "higgs.train",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_a_run_without_a_card_fails_and_prints_no_result():
    proc = _run_cli(ROOT)
    assert proc.returncode != 0
    assert "{" not in proc.stdout and "CUDA" in proc.stderr


def test_a_run_without_the_program_fails(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = _run_cli(tmp_path)
    assert proc.returncode != 0 and "{" not in proc.stdout

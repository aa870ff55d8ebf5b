"""Shared fixtures: the repository on the path, and a copy of the
benchmark's data files cut to sizes a CPU test run holds."""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

# the tiny shapes: widths as published, records and rounds cut
TINY_CONFIG = {"higgs": {"n_records": 4000, "train": {"n_trees": 6}},
               "covertype": {"n_records": 3000, "train": {"n_trees": 4}}}
# the tiny windows: the traced stretches begin at once
TINY_TRAFFIC = {"train": {"trace_after_s": 0}, "predict": {"trace_after_s": 0}}


@pytest.fixture
def tiny_bench(tmp_path):
    """A copy of ``bench/``'s data files, kinds, readers and
    ``BENCHMARK.json`` at tiny sizes; returns the copy's ``bench``
    directory."""
    src = ROOT / "bench"
    dst = tmp_path / "bench"
    for sub in ("configs", "traffic", "limits", "metrics", "kinds"):
        shutil.copytree(src / sub, dst / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for name, over in TINY_CONFIG.items():
        path = dst / "configs" / f"{name}.json"
        data = json.loads(path.read_text())
        data.update(over, train=dict(data["train"], **over["train"]))
        path.write_text(json.dumps(data))
    for name, over in TINY_TRAFFIC.items():
        path = dst / "traffic" / f"{name}.json"
        path.write_text(json.dumps(dict(json.loads(path.read_text()),
                                        **over)))
    return dst

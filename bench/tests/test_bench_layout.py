"""The benchmark's layout: what its modules import, what BENCHMARK.json
declares, and that a new configuration, traffic mix and metric are found
by name with no edit to a file that is there."""
import ast
import json
import re
import time
from pathlib import Path

import pytest

from bench.spec import Spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
MODULES = sorted(BENCH.rglob("*.py"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|"
                   r"_rank$|head|expansion|experts_per|n_numeric|onehot|"
                   r"max_bins|max_depth)")
DECLARED = json.loads((ROOT / "BENCHMARK.json").read_text())


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "repro"}, tops
    text = path.read_text()
    assert "benchmarks" + "/" not in text and "BENCH_" + "baseline" not in text


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert "repro_torch" not in tops and "bench" not in tops, path


def test_names_units_and_limits():
    d = DECLARED
    assert set(d) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert isinstance(d["run_seconds"], int) and 10 <= d["run_seconds"] <= 51
    cells = len(d["workloads"])
    assert 1 <= cells <= 24
    # a full check of 24 cells fits its 43,200 s with 1,200 s to spare
    assert (2 + 14 * 24) * (d["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    names = set()
    for c in d["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("bench/")
        assert (ROOT / c["file"]).is_file() and len(c["reduced"]) <= 16
        config = json.loads((ROOT / c["file"]).read_text())
        assert config["source"] == c["source"]
        assert config["reduced"] == c["reduced"]
        for key in c["reduced"]:          # a cut of scale, never a width
            assert NAME.match(key) and key in config
            assert not WIDTH.search(key), key
    for w in d["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and w["name"] not in names
        names.add(w["name"])
        for key in ("name", "config", "traffic"):
            assert NAME.match(w[key]), w[key]
        mix = Spec().traffic(w["traffic"])
        assert (BENCH / "kinds" / f"{mix['kind']}.py").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
    four = sum(w["chips"] == 4 for w in d["workloads"])
    assert four <= max(1, len(d["workloads"]) // 4)
    metric_names = set()
    for m in d["end_to_end"] + d["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in metric_names
        metric_names.add(m["name"])
        assert set(m.get("workloads", [])) <= names
    for m in d["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in d["end_to_end"])
    for m in d["per_layer"]:
        assert Spec().reader_path(m["name"]).is_file()
        assert m["moves"] in {e["name"] for e in d["end_to_end"]}
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    for text in [w["why"] for w in d["workloads"]] + \
            [c["why"] for c in d["configs"]] + [c["source"] for c in
                                                d["configs"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len(json.dumps(d)) <= 64 * 1024


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    spec = Spec()
    for w in DECLARED["workloads"]:
        e2e = {m["name"] for m in spec.end_to_end(w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = spec.per_layer(w["name"])
        assert layer and all(m["moves"] in e2e for m in layer)


def test_new_config_mix_kind_and_metric_are_found_by_name(tiny_bench):
    """Dropped into a copy as new files beside a new cell, they are found
    and run with no edit to any file the benchmark already has; the
    trainer's settings in the config and the mix reach ``GBDTConfig``, and
    16 bins are packed as the program packs them."""
    higgs = json.loads((tiny_bench / "configs" / "higgs.json").read_text())
    (tiny_bench / "configs" / "wide.json").write_text(json.dumps(dict(
        higgs, name="wide", n_numeric=40, n_records=3000, max_bins=16,
        train=dict(higgs["train"], n_trees=3, min_child_weight=2.0))))
    (tiny_bench / "traffic" / "train_short.json").write_text(json.dumps(dict(
        json.loads((tiny_bench / "traffic" / "train.json").read_text()),
        kind="train_noted", warm_rounds=1, train={"log_every": 7})))
    (tiny_bench / "kinds" / "train_noted.py").write_text(
        "from bench.kinds.train import TrainLoad, plant  # noqa: F401\n\n\n"
        "class KIND(TrainLoad):\n"
        "    def setup(self):\n"
        "        super().setup()\n"
        "        self.notes.append(f'settings {self.gcfg.log_every} '\n"
        "                          f'{self.gcfg.min_child_weight} '\n"
        "                          f'{type(self.dataset.codes).__name__}')\n")
    (tiny_bench / "metrics" / "rounds_seen.py").write_text(
        "def read(ctx):\n    return float(ctx.counters['rounds'])\n")
    (tiny_bench / "limits" / "wide.train_short.json").write_text(
        (tiny_bench / "limits" / "higgs.train.json").read_text())
    path = tiny_bench.parent / "BENCHMARK.json"
    declared = json.loads(path.read_text())
    declared["workloads"].append({"name": "wide.train_short",
                                  "config": "wide", "traffic": "train_short",
                                  "chips": 1, "why": "a test cell"})
    declared["end_to_end"][0]["workloads"].append("wide.train_short")
    declared["per_layer"].append({
        "name": "rounds_seen", "unit": "rounds", "better": "higher",
        "source": "program_counter", "layer": "round (core/gbdt.train)",
        "moves": "fit_throughput", "workloads": ["wide.train_short"]})
    path.write_text(json.dumps(declared))
    spec = Spec(tiny_bench)
    from bench.run import run_cell
    result, _, notes = run_cell(spec, "wide.train_short", 5, 0.3, True,
                                ["cpu"], time.perf_counter())
    assert result["correct"], result["checks"]
    assert "settings 7 2.0 PackedCodes" in notes
    assert result["metrics"]["rounds_seen"]["value"] >= 1
    result, _, _ = run_cell(spec, "wide.train_short", 5, 0.3, False,
                            ["cpu"], time.perf_counter())
    assert set(result["metrics"]) == {"fit_throughput", "setup_s"}


def test_a_setting_the_reference_cannot_judge_is_refused(tiny_bench):
    """GOSS samples the records a tree sees: the train kind's exact
    grower cannot judge such trees, so the cell asks for a kind of its
    own instead of failing its check."""
    path = tiny_bench / "traffic" / "train.json"
    mix = json.loads(path.read_text())
    path.write_text(json.dumps(dict(mix, train={
        "goss_top_rate": 0.2, "goss_other_rate": 0.1})))
    from bench.run import run_cell
    with pytest.raises(SystemExit, match="goss_top_rate"):
        run_cell(Spec(tiny_bench), "higgs.train", 5, 0.3, False, ["cpu"],
                 time.perf_counter())


def test_a_metric_reader_is_shared_by_the_name_before_its_dot():
    spec = Spec()
    assert spec.reader_path("idle_share.train") == \
        spec.reader_path("idle_share.predict") == \
        BENCH / "metrics" / "idle_share.py"
    assert spec.reader_path("round_mfu") == BENCH / "metrics" / "round_mfu.py"

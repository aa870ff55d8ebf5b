"""What ``BENCHMARK.json`` declares, and the files the harness finds by name.

Each piece of a cell lives in a file of its own, found from a name in
``BENCHMARK.json`` with no list to edit:

  bench/configs/<config>.json    a configuration's sizes and settings
  bench/traffic/<traffic>.json   a traffic mix: its ``kind`` and parameters
  bench/kinds/<kind>.py          the code of a kind of traffic (``KIND``,
                                 ``plant``), shared by its mixes
  bench/limits/<cell>.json       the limit of each number a cell compares
  bench/metrics/<metric>.py      a per-layer metric's reader, ``read(ctx)``;
                                 where there is none, the reader of the
                                 name's part before its first dot, so that
                                 ``idle_share.train`` and
                                 ``idle_share.predict`` share ``idle_share.py``
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List

BENCH = Path(__file__).resolve().parent


class Spec:
    def __init__(self, bench_dir: Path = BENCH):
        self.dir = Path(bench_dir)
        self.declared = json.loads(
            (self.dir.parent / "BENCHMARK.json").read_text())

    def _json(self, kind: str, name: str) -> Dict:
        path = self.dir / kind / f"{name}.json"
        if not path.is_file():
            raise SystemExit(f"no {kind} file {path.name} in {path.parent}")
        return json.loads(path.read_text())

    def cell(self, name: str) -> Dict:
        for cell in self.declared["workloads"]:
            if cell["name"] == name:
                return cell
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> Dict:
        return self._json("traffic", name)

    def limits(self, cell: str) -> Dict[str, float]:
        return self._json("limits", cell)

    def kind(self, name: str):
        """The module ``bench/kinds/<name>.py`` of a traffic kind."""
        return _module(self.dir / "kinds" / f"{name}.py", "bench_kind_")

    def reader_path(self, metric: str) -> Path:
        """``bench/metrics/<metric>.py``, else the file of the name's part
        before its first dot."""
        own = self.dir / "metrics" / f"{metric}.py"
        return own if own.is_file() else \
            self.dir / "metrics" / f"{metric.split('.')[0]}.py"

    def reader(self, metric: str):
        return _module(self.reader_path(metric), "bench_metric_")

    def end_to_end(self, cell: str) -> List[Dict]:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.declared["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]]

    def per_layer(self, cell: str) -> List[Dict]:
        """The per-layer metrics read in this cell's traced run: those
        that list it, and those without a list that move an end-to-end
        metric the cell reports."""
        reported = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.declared["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in reported)]


def _module(path: Path, prefix: str):
    if not path.is_file():
        raise SystemExit(f"no file {path.name} in {path.parent}")
    name = prefix + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module

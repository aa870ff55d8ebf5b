"""What every kind of traffic shares: the load's life from set-up through
the check, and the pieces that hand the benchmark's inputs to the program.

A traffic mix is a data file (``bench/traffic/<mix>.json``) whose
``kind`` names a module ``bench/kinds/<kind>.py``, found by name
(:meth:`bench.spec.Spec.kind`), and whose other keys are that kind's
parameters; a configuration is ``bench/configs/<config>.json``.  A kind's
module defines ``KIND``, a subclass of :class:`Load`, and ``plant(fault)``
(see :mod:`bench.faults`).  A load makes its inputs from the seed on the
device (:mod:`bench.measure.data`), hands them to the program
(``repro_torch``), drives the program's own entry through the window, and
afterwards hands the program's outputs and the same inputs to the plain
reference (:mod:`bench.reference.gbdt`), which works out again what the
program derived and judges what it produced.

``control`` puts the reference, computed in bfloat16, in the program's
place (the comparison must fail it); it is for the readings, never for
a benchmark run.
"""
from __future__ import annotations

import gc
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bench.measure import data as data_mod
from bench.reference import gbdt as ref
from repro_torch.core.binning import (PACK_MAX_BINS, BinnedDataset, Binner,
                                      PackedCodes, as_unpacked)
from repro_torch.core.gbdt import GBDTConfig

TREE_FIELDS = ("feature", "threshold", "is_cat", "default_left",
               "leaf_value")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def n_classes(config: Dict) -> int:
    return int(config["train"].get("n_classes") or 1)


def gbdt_config(config: Dict, mix: Dict, seed: int,
                n_trees: Optional[int] = None) -> GBDTConfig:
    """The trainer's settings as the files state them: the config's
    ``train`` object, the mix's ``train`` object over it, passed to
    ``GBDTConfig`` whole."""
    settings = dict(config["train"], **mix.get("train", {}), seed=int(seed))
    if n_trees is not None:
        settings["n_trees"] = int(n_trees)
    return GBDTConfig(**settings)


def program_dataset(X: torch.Tensor, is_cat, edges, nvb, max_bins: int
                    ) -> Tuple[Binner, BinnedDataset]:
    """The program's binner from the benchmark's edges, and the table
    binned on the device by it, in both layouts; 4-bit packed where the
    bins fit a nibble, as the program packs them."""
    binner = Binner.from_arrays(max_bins, edges, is_cat, nvb)
    codes = binner.transform_chunk(X)
    codes_cm = codes.T.contiguous()
    if max_bins <= PACK_MAX_BINS:
        codes, codes_cm = PackedCodes.pack(codes), PackedCodes.pack(codes_cm)
    return binner, BinnedDataset(
        codes=codes, codes_cm=codes_cm,
        is_categorical=torch.as_tensor(np.asarray(is_cat), device=X.device),
        n_bins=max_bins, bin_edges=np.asarray(edges),
        n_value_bins=np.asarray(nvb))


def tree_dict(trees) -> Dict[str, torch.Tensor]:
    return {k: getattr(trees, k) for k in TREE_FIELDS}


def tree_slice(trees: Dict[str, torch.Tensor], lo: int, hi: int):
    return {k: v[lo:hi] for k, v in trees.items()}


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The widest gap between ``got`` and float64 ``want``, each against
    the larger of its own reference value and the median one."""
    got = got.to(device=want.device, dtype=torch.float64).reshape(want.shape)
    mag = want.abs()
    floor = float(mag.median()) if mag.numel() else 0.0
    scale = torch.clamp(mag, min=max(floor, 1e-30))
    err = ((got - want).abs() / scale)
    err = torch.where(torch.isnan(err), float("inf"), err)
    return float(err.max()) if err.numel() else 0.0


class Load:
    """One cell's program state, from set-up through the check.

    A kind implements ``setup()``, ``window(seconds, profiler)`` (which
    returns ``attempted``, ``failed`` and the end-to-end ``metrics`` it
    measured, and leaves its counts in ``counters``; ``unit_s`` there is
    the host-clock mean of the rounds or calls run with no profile open,
    which the per-layer readers divide by), ``free()`` and ``check()``
    (the numbers compared, each named in the cell's limits file)."""

    def __init__(self, config: Dict, mix: Dict, seed: int,
                 devices: Sequence, limits: Dict[str, float],
                 control: Optional[str] = None):
        self.config, self.mix, self.seed = config, mix, int(seed)
        self.devices = [torch.device(d) for d in devices]
        self.device = self.devices[0]
        self.limits = limits
        self.control = control
        self.K = n_classes(config)
        self.counters: Dict[str, float] = {}
        self.notes: List[str] = []

    def shapes(self) -> Dict[str, int]:
        cfg = self.config
        return {"n": self.n_work, "F": data_mod.n_fields(cfg), "K": self.K,
                "depth": int(cfg["train"]["max_depth"]),
                "n_bins": int(cfg["max_bins"]),
                "trees": int(cfg["train"]["n_trees"]) * self.K}

    # -- shared pieces ------------------------------------------------------
    def _table(self, n: int) -> None:
        self.table = data_mod.make_table(self.config, n, self.seed,
                                         self.device)

    def _bin(self, X: torch.Tensor) -> None:
        cfg = self.config
        self.edges, self.nvb = data_mod.quantile_edges(
            X, self.table.is_cat, int(cfg["max_bins"]))
        self.binner, self.dataset = program_dataset(
            self.table.X, self.table.is_cat, self.edges, self.nvb,
            int(cfg["max_bins"]))

    def _ref_codes(self, X: torch.Tensor) -> torch.Tensor:
        return ref.bin_codes(X, self.edges, self.table.is_cat, self.nvb,
                             int(self.config["max_bins"]))

    def _codes_mismatch(self, codes: torch.Tensor, n: int) -> float:
        """Codes of the program's two layouts of the first ``n`` records
        that differ from the reference's binning of the same raw table."""
        prog = self.dataset
        bad = int((as_unpacked(prog.codes)[:n] != codes).sum())
        bad += int((as_unpacked(prog.codes_cm)[:, :n] != codes.T).sum())
        return float(bad)

    def _tree_kw(self) -> Dict:
        """The grower's settings, as the reference takes them."""
        t = self.config["train"]
        return dict(n_bins=int(self.config["max_bins"]),
                    is_cat=torch.as_tensor(self.table.is_cat),
                    lambda_=float(t["lambda_"]), gamma=float(t["gamma"]),
                    min_child_weight=float(t["min_child_weight"]),
                    learning_rate=float(t["learning_rate"]))

    def free(self) -> None:
        """Drop the program's state that the check does not read."""

    def verdict(self) -> List[Tuple[str, float, float]]:
        out = []
        for name, value in self.check():
            if name not in self.limits:
                raise SystemExit(f"no limit for the check {name!r}")
            out.append((name, float(value), float(self.limits[name])))
        return out


def settle() -> None:
    """After set-up: collect the garbage, then keep every object left
    (the imports, the tables, the model) out of the interpreter's later
    collections, as a long-running process does once it is warm; each
    full collection would otherwise walk them all."""
    gc.collect()
    gc.freeze()

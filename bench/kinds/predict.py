"""``predict``: back-to-back ``GBDTModel.predict_margin`` calls over the
card-resident binned table, each call's margins copied to the host.

The model is the benchmark's own: a full ensemble of the config's shape
(``n_trees`` rounds of K trees of ``max_depth``) drawn from the seed on
the device, each node a random field and one of its value bins, each
leaf a random weight, handed to the program as its ``GBDTModel`` and to
the reference as plain tensors.  The check compares the codes that the
program binned with the reference's, and the last call's margins with
the reference's float64 walk of the same trees over its own codes.
"""
from __future__ import annotations

import statistics
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from bench.faults import patch
from bench.load import Load, rel_err, sync
from bench.measure import data as data_mod
from bench.reference import gbdt as ref
from repro_torch.core.gbdt import GBDTModel
from repro_torch.kernels import ops
from repro_torch.kernels.ref import TreeArrays

LEAF_SCALE = 0.5          # a leaf's weight, before the rate: N(0, 0.5^2)


def random_ensemble(config: Dict, is_cat, nvb, seed: int, device
                    ) -> Dict[str, torch.Tensor]:
    """``n_trees`` x K complete trees of depth ``max_depth`` from ``seed``:
    each node splits on a random field, a numeric one at a random value
    bin (``code <= t`` left), an indicator at one of its categories
    (``code == t`` left), the missing bin a random way."""
    t = config["train"]
    K = int(t.get("n_classes") or 1)
    T, D = int(t["n_trees"]) * K, int(t["max_depth"])
    n_int, F = 2 ** D - 1, len(is_cat)
    gen = data_mod.device_generator(int(seed) + 104729, device)
    i32 = dict(dtype=torch.int32, device=device)
    feature = torch.randint(0, F, (T, n_int), generator=gen,
                            device=device).long()
    cat = torch.as_tensor(np.asarray(is_cat), device=device)[feature]
    # numeric: t in [0, nvb - 2]; indicator: c in [0, nvb - 1]
    span = torch.as_tensor(np.asarray(nvb), device=device)[feature] \
        - (~cat).long()
    u = torch.rand((T, n_int), generator=gen, device=device,
                   dtype=torch.float64)
    threshold = torch.minimum((u * span).long(), span - 1)
    leaf = torch.randn((T, 2 ** D), generator=gen, device=device)
    return {"feature": feature.to(**i32), "threshold": threshold.to(**i32),
            "is_cat": cat.to(**i32),
            "default_left": torch.randint(0, 2, (T, n_int), generator=gen,
                                          device=device).to(**i32),
            "leaf_value": (float(t["learning_rate"]) * LEAF_SCALE * leaf)}


class PredictLoad(Load):
    def setup(self) -> None:
        cfg, K = self.config, self.K
        self.n_work = int(cfg["n_records"])
        self._table(self.n_work)
        self._bin(self.table.X)
        self.trees = random_ensemble(cfg, self.table.is_cat, self.nvb,
                                     self.seed, self.device)
        self.base = ref.base_margin(self.table.y, K).float()
        self.model = GBDTModel(
            trees=TreeArrays(**self.trees),
            base_margin=float(self.base[0]) if K == 1
            else self.base.cpu().numpy(),
            objective=str(cfg["train"]["objective"]),
            missing_bin=int(cfg["max_bins"]) - 1,
            n_fields=data_mod.n_fields(cfg),
            max_depth=int(cfg["train"]["max_depth"]), n_classes=K)
        self.model.predict_margin(self.dataset.codes).cpu()
        sync(self.device)

    def window(self, seconds: float, profiler=None) -> Dict:
        calls, began, quiet = 0, 0, []
        codes = self.dataset.codes
        if profiler is not None:
            profiler.plan(self.mix["trace_calls"], self.mix["trace_gap_calls"])
        t0 = time.perf_counter()
        trace_from = t0 + float(self.mix["trace_after_s"])
        profiled = False          # after a profile the host launches slower
        while True:
            start = time.perf_counter()
            if profiler is not None and not profiler.active \
                    and profiler.wanted and start >= trace_from:
                profiler.begin()
                began, profiled = calls, True
            if self.control:
                out = self._control_predict()
            else:
                out = self.model.predict_margin(codes).cpu()
            if not profiled:
                quiet.append(time.perf_counter() - start)
            calls += 1
            if profiler is not None and profiler.active \
                    and calls - began == profiler.due_units:
                profiler.end(calls - began)
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        self.last = out
        self.counters = {"calls": calls, "seconds": elapsed,
                         "unit_s": statistics.fmean(quiet) if quiet else None}
        return {"attempted": calls, "failed": 0,
                "metrics": {"predict_throughput":
                            self.n_work * calls / elapsed}}

    def _walk(self, codes, dtype=torch.float64) -> torch.Tensor:
        return ref.walk(self.trees, codes, self.base.double(), self.K,
                        int(self.config["max_bins"]) - 1, dtype=dtype)

    def _control_predict(self) -> torch.Tensor:
        return self._walk(self._ref_codes(self.table.X),
                          torch.bfloat16).float().cpu()

    def free(self) -> None:
        self.model = None

    def check(self) -> List[Tuple[str, float]]:
        codes = self._ref_codes(self.table.X)
        out = [("codes_mismatch", self._codes_mismatch(codes, self.n_work))]
        self.dataset = None
        return out + [("margin_err", rel_err(self.last, self._walk(codes)))]


KIND = PredictLoad


# -- faults planted under the timed path (bench/faults.py) -----------------------
def _ensemble(fault):
    def make(real):
        def predict_ensemble(trees, codes, *, out=None, **kw):
            if fault == "unchanged":
                return out
            if fault == "half":
                half = (codes.shape[0] + 1) // 2
                real(trees, codes[:half], out=out[:half], **kw)
                return out
            real(trees, codes, out=out, **kw)
            out.view(-1)[0] += 0.01 * out.abs().max()
            return out
        return predict_ensemble
    return make


def plant(fault: str):
    """``unchanged``: a call returns the base margins; ``half``: a call
    scores only the first half of its rows; ``altered``: the first margin
    of every call moved by 1 % of the largest."""
    if fault not in ("unchanged", "half", "altered"):
        raise ValueError(f"unknown fault {fault!r}")
    return [patch(ops, "predict_ensemble", _ensemble(fault))]

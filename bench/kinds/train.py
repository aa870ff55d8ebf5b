"""``train``: back-to-back fits of ``repro_torch.core.gbdt.train`` from
the base margin, a closed loop of one job; the window's last fit is ended
between rounds by a graceful shutdown at the deadline.

The check follows the judged fit (the last whole fit of the window, or
the one fit begun) round by round with the plain reference: the codes
from the raw table; at the first ``check_rounds`` rounds and at
``check_later_rounds`` more drawn from the seed, each node's split gain
below the best candidate's and each leaf against float64 sums of g and h
at the margins that the reference walks up to that round; the loss after
each judged round and after the last; the fit's final margins against
the walk of all its trees.  The reference cannot regrow the whole fit
itself, since near-ties break either way; it follows the program's trees
between the judged rounds.
"""
from __future__ import annotations

import statistics
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from bench.faults import patch
from bench.load import (Load, gbdt_config, rel_err, sync, tree_dict,
                        tree_slice)
from bench.reference import gbdt as ref
from repro_torch.core import gbdt, losses
from repro_torch.core.gbdt import train
from repro_torch.resilience.errors import TrainingInterrupted
from repro_torch.resilience.shutdown import GracefulShutdown

# settings whose trees the reference's exact depthwise grower judges
JUDGED = {"subsample": 1.0, "colsample_bytree": 1.0, "goss_top_rate": 0.0,
          "goss_other_rate": 0.0, "grow_policy": "depthwise"}


class _WindowEnd(GracefulShutdown):
    """The window's clock and round stamp: the trainer reads ``requested``
    once after each committed round.  Past the deadline it requests the
    graceful shutdown (the round in flight finishes and the fit raises
    ``TrainingInterrupted``); in a traced run it profiles the stretches
    the profiler plans from ``trace_from`` on, each after ``skip`` more
    rounds.  ``quiet`` times the rounds before the first profile: once
    the profiler has run, the process launches more slowly."""

    def __init__(self, deadline: float, profiler=None, skip: int = 0,
                 trace_from: float = 0.0):
        super().__init__(signals=())
        self.deadline, self.profiler, self.skip = deadline, profiler, skip
        self.trace_from = trace_from
        self.count, self.began, self.next_begin = 0, 0, skip
        self.quiet: List[float] = []   # rounds before the first profile
        self._last, self._profiled = None, False

    def new_fit(self) -> None:
        p = self.profiler
        if p is not None and p.active:
            p.end(self.count - self.began)
        self.count, self.next_begin = 0, self.skip
        self._last = None

    @property
    def requested(self) -> bool:
        self.count += 1
        now = time.perf_counter()
        if self._last is not None and not self._profiled:
            self.quiet.append(now - self._last)
        p = self.profiler
        if p is not None:
            if p.active and self.count == self.began + p.due_units:
                p.end(self.count - self.began)
                self.next_begin = self.count + self.skip
            elif (not p.active and p.wanted and now >= self.trace_from
                  and self.count >= self.next_begin):
                p.begin()
                self.began, self._profiled = self.count, True
        if time.perf_counter() >= self.deadline:
            self.request("window")
        self._last = time.perf_counter()
        return super().requested


class TrainLoad(Load):
    def setup(self) -> None:
        cfg = self.config
        self.n_work = int(cfg["n_records"])
        self.gcfg = gbdt_config(cfg, self.mix, self.seed)
        off = {k: getattr(self.gcfg, k) for k, v in JUDGED.items()
               if getattr(self.gcfg, k) != v}
        if off:
            raise SystemExit(f"the train kind's reference judges exact "
                             f"depthwise trees; {off} needs a kind of its "
                             f"own")
        self._table(self.n_work)
        self._bin(self.table.X)
        warm = gbdt_config(cfg, self.mix, self.seed,
                           int(self.mix["warm_rounds"]))
        train(warm, self.dataset, self.table.y, device=self.device)
        sync(self.device)

    def window(self, seconds: float, profiler=None) -> Dict:
        if self.control:
            return self._control_window()
        if profiler is not None:
            profiler.plan(self.mix["trace_rounds"],
                          self.mix["trace_gap_rounds"])
        clock = _WindowEnd(0.0, profiler, int(self.mix["trace_skip_rounds"]))
        fits = rounds = 0
        self.judged, stamped = None, True
        t0 = time.perf_counter()
        clock.deadline = t0 + seconds
        clock.trace_from = t0 + float(self.mix["trace_after_s"])
        starts = []
        while True:
            clock.new_fit()
            fits += 1
            starts.append(time.perf_counter())
            try:
                res = train(self.gcfg, self.dataset, self.table.y,
                            device=self.device, shutdown=clock)
            except TrainingInterrupted as stop:
                done = stop.rounds_done
                rounds += done
                stamped &= clock.count == done
                if done == self.gcfg.n_trees or self.judged is None:
                    self.judged = stop.result
                break
            rounds += res.model.n_rounds
            stamped &= clock.count == res.model.n_rounds
            self.judged = res
        sync(self.device)
        elapsed = time.perf_counter() - t0
        clock.new_fit()
        if not stamped:
            self.notes.append("the trainer did not read the shutdown flag "
                              "once a round: no traced round")
            if profiler is not None:
                profiler.traces = [None, None]
        self.counters = {"fits": fits, "rounds": rounds,
                         "seconds": elapsed,
                         "unit_s": statistics.fmean(clock.quiet)
                         if clock.quiet and stamped else None,
                         "fit_seconds": [round(b - a, 4) for a, b in
                                         zip(starts, starts[1:] + [
                                             t0 + elapsed])]}
        return {"attempted": fits, "failed": 0,
                "metrics": {"fit_throughput":
                            self.n_work * rounds / elapsed}}

    def _control_window(self) -> Dict:
        """The reference grower in bfloat16 in the program's place: g, h,
        histograms, leaves and margins held in bfloat16, for the first
        ``check_rounds`` rounds."""
        codes, y = self._ref_codes(self.table.X), self.table.y
        K, dt = self.K, torch.bfloat16
        kw = dict(self._tree_kw(), depth=int(self.gcfg.max_depth))
        m = ref.base_margin(y, K).to(dt).to(codes.device)
        m = m.reshape(1, K).repeat(codes.shape[0], 1)
        trees, losses_ = [], []
        for _ in range(int(self.mix["check_rounds"])):
            g, h = ref.grad_hess(m.float(), y)
            g, h = g.to(dt), h.to(dt)
            for k in range(K):
                trees.append(ref.grow_tree(codes, g[:, k], h[:, k],
                                           dtype=dt, **kw))
            m = ref.walk(ref.stack_trees(trees[-K:]), codes, m[0] * 0, K,
                         kw["n_bins"] - 1, dtype=dt) + m
            losses_.append(ref.loss(m.double(), y))
        stacked = ref.stack_trees(trees)
        stacked["leaf_value"] = stacked["leaf_value"].float()
        self.judged = (stacked, m.float(), losses_)
        return {"attempted": 1, "failed": 0, "metrics": {}}

    def free(self) -> None:
        res = self.judged
        if isinstance(res, tuple):
            self.trees, self.margins, self.losses = res
        else:
            self.trees = tree_dict(res.model.trees)
            self.margins = res.margins.reshape(-1, self.K)
            self.losses = res.history["train_loss"]
        self.judged = None

    def judged_rounds(self, rounds: int) -> List[int]:
        """The first ``check_rounds`` rounds and ``check_later_rounds``
        more of the rest, drawn from the seed."""
        first = min(int(self.mix["check_rounds"]), rounds)
        rest = np.arange(first, rounds)
        rng = np.random.default_rng([self.seed, 53])
        later = rng.choice(rest, size=min(int(
            self.mix["check_later_rounds"]), rest.size), replace=False)
        return list(range(first)) + sorted(int(r) for r in later)

    def check(self) -> List[Tuple[str, float]]:
        codes = self._ref_codes(self.table.X)
        out = [("codes_mismatch", self._codes_mismatch(codes, self.n_work))]
        self.dataset = None
        K, y, trees = self.K, self.table.y, self.trees
        kw, mb = self._tree_kw(), int(self.config["max_bins"]) - 1
        rounds = trees["feature"].shape[0] // K
        zero = torch.zeros(K, dtype=torch.float64)
        m = ref.base_margin(y, K).to(codes.device).reshape(1, K).repeat(
            codes.shape[0], 1)
        walked = 0

        def walk_to(r):
            nonlocal m, walked
            if r > walked:
                m += ref.walk(tree_slice(trees, walked * K, r * K), codes,
                              zero, K, mb)
                walked = r

        gaps, got, want, loss_err = [], [], [], 0.0
        for r in self.judged_rounds(rounds):
            walk_to(r)
            g, h = ref.grad_hess(m, y)
            for k in range(K):
                tree = {f: v[r * K + k] for f, v in trees.items()}
                gap, expected = ref.judge_tree(codes, g[:, k], h[:, k],
                                               tree, **kw)
                gaps += gap
                got.append(tree["leaf_value"].to(codes.device))
                want.append(expected)
            walk_to(r + 1)
            want_loss = ref.loss(m, y)
            loss_err = max(loss_err, abs(self.losses[r] - want_loss)
                           / abs(want_loss))
        walk_to(rounds)
        if rounds:
            want_loss = ref.loss(m, y)
            loss_err = max(loss_err, abs(self.losses[rounds - 1] - want_loss)
                           / abs(want_loss))
        return out + [("split_gap", max(gaps, default=0.0)),
                      ("leaf_err", rel_err(torch.cat(got), torch.cat(want))),
                      ("loss_err", loss_err),
                      ("margin_err", rel_err(self.margins, m))]


KIND = TrainLoad


# -- faults planted under the timed path (bench/faults.py) -----------------------
def _unchanged_round(real):
    def predict_round(tree, data, plan, margins=None):
        return margins
    return predict_round


def _half_stats(real):
    def grad_hess(self, margin, y):
        g, h = real(self, margin, y)
        w = torch.zeros(g.shape[0], dtype=g.dtype, device=g.device)
        w[:(g.shape[0] + 1) // 2] = 2.0
        w = w.reshape((-1,) + (1,) * (g.ndim - 1))
        return g * w, h * w
    return grad_hess


def _altered_round(real):
    def grow_round(*args, **kw):
        tree = real(*args, **kw)
        leaf = tree.leaf_value.clone()
        leaf[..., 0] += 0.01 * leaf.abs().max()
        return tree._replace(leaf_value=leaf)
    return grow_round


def plant(fault: str):
    """``unchanged``: a round's step ⑤ leaves the margins as they were;
    ``half``: a round's g and h zeroed on the second half of the records
    and doubled on the first; ``altered``: the first leaf of every grown
    tree moved by 1 % of the largest."""
    if fault == "unchanged":
        return [patch(gbdt, "_predict_one_tree", _unchanged_round),
                patch(gbdt, "_predict_forest", _unchanged_round)]
    if fault == "half":
        return [patch(losses.Loss, "grad_hess", _half_stats)]
    if fault == "altered":
        return [patch(gbdt, "_grow_round", _altered_round)]
    raise ValueError(f"unknown fault {fault!r}")

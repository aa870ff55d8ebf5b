"""``train_mixed``: the ``train`` kind over a table of numeric and
many-category fields with missing values, under the objective the
configuration states.

The window is the ``train`` kind's: back-to-back fits of
``repro_torch.core.gbdt.train`` from the base margin, one at a time, the
last ended between rounds by a graceful shutdown at the deadline.  The
table is :mod:`bench.measure.mixed`'s, at the configuration's
``n_numeric``, ``n_categorical`` fields of ``n_categories`` and
``missing_rate``; its edges skip the missing values, and a categorical
field holds its categories.  The check is the ``train`` kind's (the codes
from the raw table; at the first ``check_rounds`` rounds and
``check_later_rounds`` more drawn from the seed, each node's split gain
against the best candidate's and each leaf against float64 sums; the
loss; the final margins), with the float64 reference of the objective:
:mod:`bench.reference.squared` for ``reg:squarederror``,
:mod:`bench.reference.gbdt` for ``binary:logistic``.  Any other
objective is refused before the table is made.

The window also reads the program's fit-end counters of the splits it
grew (``tree.splits``, ``tree.splits_categorical``,
``tree.splits_default_left``, ``repro_torch.obs``) into ``counters``;
a program that keeps none leaves them out.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from bench.kinds.train import TrainLoad, plant  # noqa: F401  (its faults)
from bench.load import program_dataset, rel_err, tree_slice
from bench.measure import mixed
from bench.reference import gbdt as logistic
from bench.reference import squared
from repro_torch import obs

# the objectives whose fits the kind judges, and the reference of each
REFERENCES = {"reg:squarederror": squared, "binary:logistic": logistic}
SPLIT_COUNTERS = ("tree.splits", "tree.splits_categorical",
                  "tree.splits_default_left")


class MixedLoad(TrainLoad):
    def setup(self) -> None:
        objective = self.config["train"]["objective"]
        if objective not in REFERENCES:
            raise SystemExit(f"the train_mixed kind judges "
                             f"{sorted(REFERENCES)}; {objective!r} needs a "
                             f"reference of its own")
        self.ref = REFERENCES[objective]
        super().setup()

    def shapes(self) -> Dict[str, int]:
        return dict(super().shapes(), F=mixed.n_fields(self.config))

    def _table(self, n: int) -> None:
        self.table = mixed.make_table(self.config, n, self.seed, self.device)

    def _bin(self, X: torch.Tensor) -> None:
        cfg = self.config
        self.edges, self.nvb = mixed.quantile_edges(
            X, self.table.is_cat, int(cfg["n_categories"]),
            int(cfg["max_bins"]))
        self.binner, self.dataset = program_dataset(
            X, self.table.is_cat, self.edges, self.nvb, int(cfg["max_bins"]))

    def window(self, seconds: float, profiler=None) -> Dict:
        before = obs.counts()
        res = super().window(seconds, profiler)
        grown = obs.delta(before)
        self.counters.update({k: grown[k] for k in SPLIT_COUNTERS
                              if k in grown})
        return res

    def _control_window(self) -> Dict:
        """The reference grower in bfloat16 in the program's place: g, h,
        histograms, leaves and margins held in bfloat16, for the first
        ``check_rounds`` rounds."""
        R, dt = self.ref, torch.bfloat16
        codes, y = self._ref_codes(self.table.X), self.table.y
        kw = dict(self._tree_kw(), depth=int(self.gcfg.max_depth))
        m = R.base_margin(y, 1).to(dt).to(codes.device)
        m = m.reshape(1, 1).repeat(codes.shape[0], 1)
        trees, losses_ = [], []
        for _ in range(int(self.mix["check_rounds"])):
            g, h = R.grad_hess(m.float(), y)
            trees.append(R.grow_tree(codes, g[:, 0].to(dt), h[:, 0].to(dt),
                                     dtype=dt, **kw))
            m = R.walk(R.stack_trees(trees[-1:]), codes, m[0] * 0, 1,
                       kw["n_bins"] - 1, dtype=dt) + m
            losses_.append(R.loss(m.double(), y))
        stacked = R.stack_trees(trees)
        stacked["leaf_value"] = stacked["leaf_value"].float()
        self.judged = (stacked, m.float(), losses_)
        return {"attempted": 1, "failed": 0, "metrics": {}}

    def check(self) -> List[Tuple[str, float]]:
        R = self.ref
        codes = self._ref_codes(self.table.X)
        out = [("codes_mismatch", self._codes_mismatch(codes, self.n_work))]
        self.dataset = None
        y, trees = self.table.y, self.trees
        kw, mb = self._tree_kw(), int(self.config["max_bins"]) - 1
        rounds = trees["feature"].shape[0]
        zero = torch.zeros(1, dtype=torch.float64)
        m = R.base_margin(y, 1).to(codes.device).reshape(1, 1).repeat(
            codes.shape[0], 1)
        walked = 0

        def walk_to(r):
            nonlocal m, walked
            if r > walked:
                m += R.walk(tree_slice(trees, walked, r), codes, zero, 1, mb)
                walked = r

        def loss_gap(r):
            want = R.loss(m, y)
            return abs(self.losses[r] - want) / abs(want)

        gaps, got, want, loss_err = [], [], [], 0.0
        for r in self.judged_rounds(rounds):
            walk_to(r)
            g, h = R.grad_hess(m, y)
            tree = {f: v[r] for f, v in trees.items()}
            gap, expected = R.judge_tree(codes, g[:, 0], h[:, 0], tree, **kw)
            gaps += gap
            got.append(tree["leaf_value"].to(codes.device))
            want.append(expected)
            walk_to(r + 1)
            loss_err = max(loss_err, loss_gap(r))
        walk_to(rounds)
        if rounds:
            loss_err = max(loss_err, loss_gap(rounds - 1))
        return out + [("split_gap", max(gaps, default=0.0)),
                      ("leaf_err", rel_err(torch.cat(got), torch.cat(want))),
                      ("loss_err", loss_err),
                      ("margin_err", rel_err(self.margins, m))]


KIND = MixedLoad

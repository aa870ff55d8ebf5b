"""Gradient-boosted decision trees — the end-to-end trainer (steps ①–⑥).

The counterpart of :mod:`repro.core.gbdt` for the in-memory, single-device,
depthwise fit of a scalar objective: grow trees one at a time (step ⑥),
each level by level (steps ①–④, :func:`repro_torch.core.tree.fit_tree`),
then walk every record through the new tree to refresh its margin
(step ⑤).  ``GBDTModel.predict_margin`` runs batch inference over the
whole ensemble.

Options of the reference trainer that this port does not have yet raise
``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.api.plan import ExecutionPlan, resolve_device, resolve_plan
from repro_torch.core import losses as losses_mod
from repro_torch.core import tree as tree_mod
from repro_torch.core.binning import BinnedDataset
from repro_torch.kernels import ops
from repro_torch.kernels.ref import TreeArrays


@dataclasses.dataclass(frozen=True)
class GBDTConfig:
    """Training hyper-parameters (XGBoost-compatible naming where possible)."""

    n_trees: int = 100
    max_depth: int = 6               # the paper trains 500 x depth-6 trees
    learning_rate: float = 0.1      # shrinkage
    lambda_: float = 1.0             # L2 weight regularization
    gamma: float = 0.0               # per-split complexity penalty
    min_child_weight: float = 1.0
    objective: str = "reg:squarederror"
    subsample: float = 1.0           # stochastic GB (Friedman 2002)
    colsample_bytree: float = 1.0
    goss_top_rate: float = 0.0       # GOSS (not ported yet)
    goss_other_rate: float = 0.0
    grow_policy: str = "depthwise"   # "lossguide" is not ported yet
    fused_rounds: bool = False       # not ported yet
    log_every: int = 10              # verbose cadence (rounds)
    early_stopping_rounds: Optional[int] = None
    n_classes: Optional[int] = None  # multi-class is not ported yet
    seed: int = 0

    def __post_init__(self):
        if self.max_depth < 1 or self.max_depth > 10:
            raise ValueError("max_depth must be in [1, 10]")
        if self.grow_policy not in ("depthwise", "lossguide"):
            raise ValueError(f"unknown grow_policy {self.grow_policy!r}")
        if self.log_every < 1:
            raise ValueError("log_every must be >= 1")
        todo = []
        if self.fused_rounds:
            todo.append("fused_rounds (ROADMAP Queue 1: training variants)")
        if self.grow_policy == "lossguide":
            todo.append("the lossguide grower (ROADMAP Queue 1: training variants)")
        if self.goss_top_rate or self.goss_other_rate:
            todo.append("GOSS (ROADMAP Queue 1: training variants)")
        if (self.objective in losses_mod.MULTICLASS_OBJECTIVES
                or self.n_classes not in (None, 1)):
            todo.append("multi-class objectives (ROADMAP Queue 1: K > 1)")
        if todo:
            raise NotImplementedError("not ported yet: " + "; ".join(todo))


@dataclasses.dataclass
class GBDTModel:
    """A trained ensemble: stacked fixed-shape trees + prediction metadata."""

    trees: TreeArrays            # stacked (T, ...) tensors
    base_margin: float
    objective: str
    missing_bin: int
    n_fields: int
    max_depth: int
    n_classes: int = 1

    @property
    def n_trees(self) -> int:
        return int(self.trees.feature.shape[0])

    @property
    def loss(self) -> losses_mod.Loss:
        return losses_mod.get_loss(self.objective)

    def predict_margin(self, codes, *, plan: Optional[ExecutionPlan] = None,
                       mode: Optional[str] = None) -> torch.Tensor:
        """Raw ensemble margins (n,) for binned ``codes`` (a tensor on the
        model's device, or a ``BinnedDataset``)."""
        codes = codes.codes if isinstance(codes, BinnedDataset) else codes
        if mode == "cached":
            raise NotImplementedError(
                'mode="cached" is not ported yet (ROADMAP Queue 1: '
                "inference engine)")
        if mode not in (None, "direct"):
            raise ValueError(f"unknown predict mode {mode!r}; choose "
                             "'cached' or 'direct'")
        out = ops.predict_ensemble(self.trees, codes,
                                   missing_bin=self.missing_bin,
                                   depth=self.max_depth, plan=plan)
        return out + self.base_margin

    def predict(self, codes, *, plan: Optional[ExecutionPlan] = None,
                mode: Optional[str] = None) -> torch.Tensor:
        """Transformed predictions — same surface as :meth:`predict_margin`."""
        return self.loss.transform(self.predict_margin(codes, plan=plan,
                                                       mode=mode))

    # -- (de)serialization -------------------------------------------------
    def meta(self) -> Dict:
        return {"base_margin": float(self.base_margin),
                "objective": self.objective,
                "missing_bin": int(self.missing_bin),
                "n_fields": int(self.n_fields),
                "max_depth": int(self.max_depth),
                "n_classes": int(self.n_classes)}

    def to_state(self) -> Dict:
        """Numpy tree arrays + JSON meta, the format of
        ``repro.core.gbdt.GBDTModel.to_state``."""
        return {"trees": {k: v.cpu().numpy()
                          for k, v in self.trees._asdict().items()},
                "meta": self.meta()}

    @classmethod
    def from_state(cls, state: Dict, device=None) -> "GBDTModel":
        """Rebuild a model (its trees on ``device``, CUDA by default) from a
        state dict written by either package's ``to_state``."""
        device = resolve_device(device)
        m = state["meta"]
        if int(m.get("n_classes", 1)) != 1:
            raise NotImplementedError("multi-class models are not ported "
                                      "yet (ROADMAP Queue 1: K > 1)")
        trees = TreeArrays(**{k: torch.as_tensor(np.array(v), device=device)
                              for k, v in state["trees"].items()})
        return cls(trees=trees, base_margin=float(m["base_margin"]),
                   objective=str(m["objective"]),
                   missing_bin=int(m["missing_bin"]),
                   n_fields=int(m["n_fields"]),
                   max_depth=int(m["max_depth"]))


@dataclasses.dataclass
class TrainResult:
    model: GBDTModel
    history: Dict[str, List[float]]
    step_times: Dict[str, float]     # accumulated seconds per paper step
    stats: Dict = dataclasses.field(default_factory=dict)
    margins: Optional[torch.Tensor] = None   # final training margins (n,)


def _round_generator(config: GBDTConfig, t_idx: int,
                     device: torch.device) -> torch.Generator:
    """The round's random stream, keyed by ``(seed, round)``.  JAX's
    threefry streams cannot be reproduced, so samples differ from the
    reference trainer's."""
    seed = int(np.random.SeedSequence([config.seed, t_idx])
               .generate_state(1, np.uint64)[0] >> 1)
    return torch.Generator(device=device).manual_seed(seed)


def _round_stats(config: GBDTConfig, gen: torch.Generator, g, h, n: int,
                 F: int):
    """Per-round row subsampling and the per-tree field mask."""
    device = g.device
    if config.subsample < 1.0:
        mask = (torch.rand((n,), generator=gen, device=device)
                < config.subsample).to(torch.float32)
        g, h = g * mask, h * mask
    if config.colsample_bytree < 1.0:
        field_mask = (torch.rand((F,), generator=gen, device=device)
                      < config.colsample_bytree)
        field_mask[torch.argmax(field_mask.to(torch.int32))] = True
    else:
        field_mask = torch.ones((F,), dtype=torch.bool, device=device)
    return g, h, field_mask


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(config: GBDTConfig, data: BinnedDataset, y,
          eval_set: Optional[Tuple[BinnedDataset, object]] = None,
          init_model: Optional[GBDTModel] = None,
          callback: Optional[Callable[[int, GBDTModel], None]] = None,
          verbose: bool = False,
          plan: Optional[ExecutionPlan] = None,
          device=None) -> TrainResult:
    """Fit a GBDT ensemble on ``device`` (CUDA by default; the data moves
    there if it lies elsewhere).  ``eval_set`` is ``(BinnedDataset,
    labels)`` and drives early stopping."""
    if init_model is not None:
        raise NotImplementedError(
            "warm start (init_model / _replay_margins) is not ported yet "
            "(ROADMAP Queue 1: _replay_margins)")
    device = resolve_device(device)
    plan = resolve_plan(plan)
    loss = losses_mod.get_loss(config.objective, config.n_classes)
    data = data.to(device)
    y = torch.as_tensor(y, dtype=torch.float32, device=device)
    n, F = data.codes.shape
    depth = config.max_depth

    trees: List[TreeArrays] = []
    history: Dict[str, List[float]] = {"train_loss": []}
    step_times = {"binning_split": 0.0, "traversal": 0.0, "other": 0.0}
    base_margin = float(loss.base_margin(y))
    margins = torch.full((n,), base_margin, dtype=torch.float32,
                         device=device)
    if eval_set is not None:
        history["eval_loss"] = []
        ev_data = eval_set[0].to(device)
        ev_y = torch.as_tensor(eval_set[1], dtype=torch.float32,
                               device=device)
        eval_margins = torch.full((ev_y.shape[0],), base_margin,
                                  dtype=torch.float32, device=device)
    best_eval, best_round = np.inf, -1

    for t_idx in range(config.n_trees):
        t0 = time.perf_counter()
        g, h = loss.grad_hess(margins, y)
        g, h, field_mask = _round_stats(
            config, _round_generator(config, t_idx, device), g, h, n, F)
        tree = tree_mod.fit_tree(
            data.codes, data.codes_cm, g.contiguous(), h.contiguous(),
            depth=depth, n_bins=data.n_bins, missing_bin=data.missing_bin,
            is_cat_field=data.is_categorical, field_mask=field_mask,
            lambda_=config.lambda_, gamma=config.gamma,
            min_child_weight=config.min_child_weight, plan=plan)
        # shrinkage is folded into the stored leaf values
        tree = tree._replace(leaf_value=tree.leaf_value * config.learning_rate)
        _sync(device)
        t1 = time.perf_counter()
        step_times["binning_split"] += t1 - t0

        # step ⑤ — one-tree traversal refreshes margins (and thus g, h)
        margins = margins + _predict_one_tree(tree, data, plan)
        _sync(device)
        t2 = time.perf_counter()
        step_times["traversal"] += t2 - t1

        trees.append(tree)
        train_loss = float(torch.mean(loss.value(margins, y)))
        history["train_loss"].append(train_loss)
        stop = False
        if eval_set is not None:
            eval_margins = eval_margins + _predict_one_tree(tree, ev_data,
                                                            plan)
            ev = float(torch.mean(loss.value(eval_margins, ev_y)))
            history["eval_loss"].append(ev)
            if ev < best_eval - 1e-12:
                best_eval, best_round = ev, t_idx
            stop = (config.early_stopping_rounds is not None
                    and t_idx - best_round >= config.early_stopping_rounds)
        step_times["other"] += time.perf_counter() - t2

        if verbose and (t_idx % config.log_every == 0
                        or t_idx == config.n_trees - 1):
            print(f"[gbdt] tree {t_idx:4d}  train_loss={train_loss:.6f}")
        if callback is not None:
            callback(t_idx, _as_model(trees, base_margin, config,
                                      data.missing_bin, F))
        if stop:
            if verbose:
                print(f"[gbdt] early stop at tree {t_idx} "
                      f"(best {best_round}: {best_eval:.6f})")
            break

    return TrainResult(model=_as_model(trees, base_margin, config,
                                       data.missing_bin, F),
                       history=history, step_times=step_times,
                       stats={"n_rows": n}, margins=margins)


def _as_model(trees, base_margin, config, missing_bin, F) -> GBDTModel:
    stacked = TreeArrays(*[torch.stack([getattr(t, f) for t in trees])
                           for f in TreeArrays._fields])
    return GBDTModel(trees=stacked, base_margin=base_margin,
                     objective=config.objective, missing_bin=missing_bin,
                     n_fields=F, max_depth=config.max_depth)


def _predict_one_tree(tree: TreeArrays, data: BinnedDataset,
                      plan: ExecutionPlan) -> torch.Tensor:
    """Step-⑤ traversal, using the paper's renumbered-column fetch when it
    saves bandwidth: a depth-D tree touches at most 2^D − 1 columns, so for
    wide datasets only those columns are gathered from the column-major
    copy."""
    n_int = tree.feature.shape[0]
    if data.n_fields > n_int:
        # per-node column fetch: node i's field becomes renumbered column i
        cols = tree_mod._gather_fields(data.codes_cm,
                                       tree.feature.clamp(min=0))  # (N_int, n)
        renum = torch.where(tree.feature >= 0,
                            torch.arange(n_int, dtype=torch.int32,
                                         device=tree.feature.device), -1)
        return ops.traverse_tree(tree._replace(feature=renum),
                                 cols.T.contiguous(),
                                 missing_bin=data.missing_bin, plan=plan)
    return ops.traverse_tree(tree, data.codes, missing_bin=data.missing_bin,
                             plan=plan)

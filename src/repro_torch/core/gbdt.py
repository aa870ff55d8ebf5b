"""Gradient-boosted decision trees — the end-to-end trainer (steps ①–⑥).

The counterpart of :mod:`repro.core.gbdt` for the in-memory, single-device,
depthwise fit: grow trees one round at a time (step ⑥), each level by
level (steps ①–④, :func:`repro_torch.core.tree.fit_tree`), then walk every
record through the new tree to refresh its margin (step ⑤).  A multi-class
objective (``multi:softmax``, K classes) grows K trees per round in one
class-batched pass (:func:`repro_torch.core.tree.fit_forest`) and keeps
(n, K) margins.  ``GBDTModel.predict_margin`` runs batch inference over the
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
    n_classes: Optional[int] = None  # multi:softmax only; K trees per round
    seed: int = 0

    def __post_init__(self):
        if self.max_depth < 1 or self.max_depth > 10:
            raise ValueError("max_depth must be in [1, 10]")
        if self.grow_policy not in ("depthwise", "lossguide"):
            raise ValueError(f"unknown grow_policy {self.grow_policy!r}")
        if self.log_every < 1:
            raise ValueError("log_every must be >= 1")
        if self.objective in losses_mod.MULTICLASS_OBJECTIVES:
            if self.n_classes is None or self.n_classes < 2:
                raise ValueError(
                    f"objective {self.objective!r} requires n_classes >= 2")
            if self.grow_policy != "depthwise":
                raise ValueError("multi-class training supports only the "
                                 "depthwise grow_policy")
        elif self.n_classes not in (None, 1):
            raise ValueError(
                f"n_classes={self.n_classes} only applies to multi-class "
                f"objectives, not {self.objective!r}")
        todo = []
        if self.fused_rounds:
            todo.append("fused_rounds (ROADMAP Queue 1: training variants)")
        if self.grow_policy == "lossguide":
            todo.append("the lossguide grower (ROADMAP Queue 1: training variants)")
        if self.goss_top_rate or self.goss_other_rate:
            todo.append("GOSS (ROADMAP Queue 1: training variants)")
        if todo:
            raise NotImplementedError("not ported yet: " + "; ".join(todo))


@dataclasses.dataclass
class GBDTModel:
    """A trained ensemble: stacked fixed-shape trees + prediction metadata.

    Multi-class ensembles (``n_classes`` = K > 1) stack trees round-major —
    the tree at index ``r * K + k`` belongs to boosting round r, class k —
    and ``base_margin`` is a (K,) float32 array; ``predict_margin`` then
    returns (n, K).
    """

    trees: TreeArrays            # stacked (T, ...) tensors
    base_margin: float           # scalar, or (K,) array when n_classes > 1
    objective: str
    missing_bin: int
    n_fields: int
    max_depth: int
    n_classes: int = 1

    @property
    def n_trees(self) -> int:
        return int(self.trees.feature.shape[0])

    @property
    def n_rounds(self) -> int:
        """Boosting rounds (== n_trees for scalar objectives)."""
        return self.n_trees // max(self.n_classes, 1)

    @property
    def loss(self) -> losses_mod.Loss:
        return losses_mod.get_loss(
            self.objective, self.n_classes if self.n_classes > 1 else None)

    def predict_margin(self, codes, *, plan: Optional[ExecutionPlan] = None,
                       mode: Optional[str] = None) -> torch.Tensor:
        """Raw ensemble margins (n,) — (n, K) for a multi-class model — for
        binned ``codes`` (a tensor or ``PackedCodes`` on the model's device,
        or a ``BinnedDataset``, packed or not)."""
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
                                   depth=self.max_depth, plan=plan,
                                   n_classes=self.n_classes)
        if self.n_classes > 1:
            return out + torch.as_tensor(self.base_margin, dtype=torch.float32,
                                         device=out.device)
        return out + self.base_margin

    def predict(self, codes, *, plan: Optional[ExecutionPlan] = None,
                mode: Optional[str] = None) -> torch.Tensor:
        """Transformed predictions — same surface as :meth:`predict_margin`."""
        return self.loss.transform(self.predict_margin(codes, plan=plan,
                                                       mode=mode))

    # -- (de)serialization -------------------------------------------------
    def meta(self) -> Dict:
        """JSON-safe model metadata, the encoding of
        ``repro.core.gbdt.GBDTModel.meta``."""
        return {"base_margin": pack_base_margin(self.base_margin,
                                                self.n_classes),
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
        trees = TreeArrays(**{k: torch.as_tensor(np.array(v), device=device)
                              for k, v in state["trees"].items()})
        return model_from_meta(trees, state["meta"])


def pack_base_margin(base_margin, n_classes: int):
    """JSON-safe base margin: per-class float list for K > 1, bare float
    otherwise."""
    if n_classes > 1:
        return [float(b) for b in np.asarray(base_margin)]
    return float(base_margin)


def unpack_base_margin(value, n_classes: int):
    return (np.asarray(value, np.float32) if n_classes > 1
            else float(value))


def model_from_meta(trees: TreeArrays, m: Dict) -> GBDTModel:
    """Rebuild a model from its JSON meta (``GBDTModel.meta``); states
    written before multi-class support carry no n_classes key (K = 1)."""
    K = int(m.get("n_classes", 1))
    return GBDTModel(trees=trees,
                     base_margin=unpack_base_margin(m["base_margin"], K),
                     objective=str(m["objective"]),
                     missing_bin=int(m["missing_bin"]),
                     n_fields=int(m["n_fields"]),
                     max_depth=int(m["max_depth"]),
                     n_classes=K)


def _stack_trees(trees: List[TreeArrays]) -> TreeArrays:
    return TreeArrays(*[torch.stack([getattr(t, f) for t in trees])
                        for f in TreeArrays._fields])


def _stack_forests(forests: List[TreeArrays]) -> TreeArrays:
    """Stack per-round (K, ...) forests into round-major (R*K, ...) trees."""
    stacked = _stack_trees(forests)                  # (R, K, ...)
    return TreeArrays(*[a.reshape((-1,) + a.shape[2:]) for a in stacked])


def _unstack_forests(trees: TreeArrays, n_rounds: int,
                     n_classes: int) -> List[TreeArrays]:
    """Invert ``_stack_forests``: (R*K, ...) -> R forests of (K, ...)."""
    resh = [a.reshape((n_rounds, n_classes) + a.shape[1:]) for a in trees]
    return [TreeArrays(*[a[r] for a in resh]) for r in range(n_rounds)]


@dataclasses.dataclass
class TrainResult:
    model: GBDTModel
    history: Dict[str, List[float]]
    step_times: Dict[str, float]     # accumulated seconds per paper step
    stats: Dict = dataclasses.field(default_factory=dict)
    margins: Optional[torch.Tensor] = None   # final training margins,
    #                                          (n,) or (n, K)


def _round_generator(config: GBDTConfig, t_idx: int,
                     device: torch.device) -> torch.Generator:
    """The round's random stream, keyed by ``(seed, round)``.  JAX's
    threefry streams cannot be reproduced, so samples differ from the
    reference trainer's."""
    seed = int(np.random.SeedSequence([config.seed, t_idx])
               .generate_state(1, np.uint64)[0] >> 1)
    return torch.Generator(device=device).manual_seed(seed)


def _round_stats(config: GBDTConfig, gen: torch.Generator, g, h, n: int,
                 F: int, K: Optional[int] = None):
    """Per-round row subsampling and the per-tree field mask; g, h are
    (n,) or, for K classes, (n, K)."""
    device = g.device
    if config.subsample < 1.0:
        mask = (torch.rand((n,), generator=gen, device=device)
                < config.subsample).to(torch.float32)
        if K is not None:          # same record draw for every class
            mask = mask[:, None]
        g, h = g * mask, h * mask
    if config.colsample_bytree < 1.0:
        field_mask = (torch.rand((F,), generator=gen, device=device)
                      < config.colsample_bytree)
        field_mask[torch.argmax(field_mask.to(torch.int32))] = True
    else:
        field_mask = torch.ones((F,), dtype=torch.bool, device=device)
    return g, h, field_mask


def _validate_multiclass_labels(K: int, y: torch.Tensor,
                                eval_y: Optional[torch.Tensor] = None) -> None:
    """An out-of-range class in either split would otherwise index past
    the softmax's K columns."""
    batches = [("training", y)]
    if eval_y is not None:
        batches.append(("eval_set", eval_y))
    for what, yy in batches:
        if not yy.shape[0]:
            continue
        y_min, y_max = float(torch.min(yy)), float(torch.max(yy))
        if (y_max >= K or y_min < 0
                or not bool(torch.all(yy == torch.round(yy)))):
            raise ValueError(
                f"multi-class {what} labels must be integers in "
                f"[0, {K}); observed range [{y_min}, {y_max}]")


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
    K = loss.n_outputs                 # None for scalar objectives
    data = data.to(device)
    y = torch.as_tensor(y, dtype=torch.float32, device=device)
    if eval_set is not None:
        ev_data = eval_set[0].to(device)
        ev_y = torch.as_tensor(eval_set[1], dtype=torch.float32,
                               device=device)
    if K is not None:
        _validate_multiclass_labels(K, y,
                                    ev_y if eval_set is not None else None)
    n, F = data.codes.shape
    depth = config.max_depth

    trees: List[TreeArrays] = []       # one entry per round: (K, ...) at K
    history: Dict[str, List[float]] = {"train_loss": []}
    step_times = {"binning_split": 0.0, "traversal": 0.0, "other": 0.0}
    if K is not None:
        base_margin = loss.base_margin(y).cpu().numpy().astype(np.float32)
        base = torch.as_tensor(base_margin, device=device)
    else:
        base_margin = float(loss.base_margin(y))
        base = torch.tensor(base_margin, dtype=torch.float32, device=device)
    margins = base.expand((n,) + base.shape).clone()       # (n,) or (n, K)
    if eval_set is not None:
        history["eval_loss"] = []
        eval_margins = base.expand((ev_y.shape[0],) + base.shape).clone()
    best_eval, best_round = np.inf, -1
    # step ⑤ for one round: K class trees at once, or the one tree
    predict_round = _predict_forest if K is not None else _predict_one_tree

    for t_idx in range(config.n_trees):
        t0 = time.perf_counter()
        g, h = loss.grad_hess(margins, y)
        g, h, field_mask = _round_stats(
            config, _round_generator(config, t_idx, device), g, h, n, F, K)
        common = dict(depth=depth, n_bins=data.n_bins,
                      missing_bin=data.missing_bin,
                      is_cat_field=data.is_categorical,
                      field_mask=field_mask, lambda_=config.lambda_,
                      gamma=config.gamma,
                      min_child_weight=config.min_child_weight, plan=plan)
        if K is not None:
            # one class-batched pass grows all K per-class trees
            tree = tree_mod.fit_forest(data.codes, data.codes_cm,
                                       g.T.contiguous(), h.T.contiguous(),
                                       **common)
        else:
            tree = tree_mod.fit_tree(data.codes, data.codes_cm,
                                     g.contiguous(), h.contiguous(),
                                     **common)
        # shrinkage is folded into the stored leaf values
        tree = tree._replace(leaf_value=tree.leaf_value * config.learning_rate)
        _sync(device)
        t1 = time.perf_counter()
        step_times["binning_split"] += t1 - t0

        # step ⑤ — one-tree traversal refreshes margins (and thus g, h)
        margins = margins + predict_round(tree, data, plan)
        _sync(device)
        t2 = time.perf_counter()
        step_times["traversal"] += t2 - t1

        trees.append(tree)
        train_loss = float(torch.mean(loss.value(margins, y)))
        history["train_loss"].append(train_loss)
        stop = False
        if eval_set is not None:
            eval_margins = eval_margins + predict_round(tree, ev_data, plan)
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
    K = config.n_classes or 1
    stacked = _stack_forests(trees) if K > 1 else _stack_trees(trees)
    return GBDTModel(trees=stacked, base_margin=base_margin,
                     objective=config.objective, missing_bin=missing_bin,
                     n_fields=F, max_depth=config.max_depth, n_classes=K)


def _predict_forest(forest: TreeArrays, data: BinnedDataset,
                    plan: ExecutionPlan) -> torch.Tensor:
    """Step-⑤ traversal of one round's K class trees (stacked (K, ...))
    -> (n, K), in one launch.  Uses the paper's renumbered-column fetch
    when it saves bandwidth: a depth-D tree touches at most 2^D − 1
    columns, so for wide datasets only those columns are gathered from
    the column-major copy (packed rows unpack after the gather), per
    class."""
    K, n_int = forest.feature.shape
    if data.n_fields > n_int:
        # per-node column fetch: node i's field becomes renumbered column i
        cols = tree_mod._gather_fields(
            data.codes_cm, forest.feature.clamp(min=0))      # (K, N_int, n)
        renum = torch.where(forest.feature >= 0,
                            torch.arange(n_int, dtype=torch.int32,
                                         device=forest.feature.device), -1)
        return ops.traverse_forest(forest._replace(feature=renum),
                                   cols.transpose(1, 2).contiguous(),
                                   missing_bin=data.missing_bin, plan=plan)
    return ops.traverse_forest(forest, data.codes,
                               missing_bin=data.missing_bin, plan=plan)


def _predict_one_tree(tree: TreeArrays, data: BinnedDataset,
                      plan: ExecutionPlan) -> torch.Tensor:
    """Step-⑤ traversal of one tree -> (n,): the K = 1 case of
    :func:`_predict_forest`."""
    forest = TreeArrays(*[a[None] for a in tree])
    return _predict_forest(forest, data, plan)[:, 0]

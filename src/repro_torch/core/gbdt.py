"""Gradient-boosted decision trees — the end-to-end trainer (steps ①–⑥).

The counterpart of :mod:`repro.core.gbdt` for the in-memory, single-device,
depthwise fit: grow trees one round at a time (step ⑥), each level by
level (steps ①–④, :func:`repro_torch.core.tree.fit_tree`), then walk every
record through the new tree to refresh its margin (step ⑤).  A multi-class
objective (``multi:softmax``, K classes) grows K trees per round in one
class-batched pass (:func:`repro_torch.core.tree.fit_forest`) and keeps
(n, K) margins.  ``GBDTModel.predict_margin`` runs batch inference over the
whole ensemble, directly or through the compile-once engine of
:mod:`repro_torch.core.inference`; ``train(init_model=...)`` continues a
fit (warm start, checkpoint resume).

The training variants of the reference trainer are here too: the
lossguide grower (``grow_policy="lossguide"``, ``max_leaves``), GOSS
(:func:`goss_weights`), the divergence sentinels and graceful shutdown
(``train(recovery=, shutdown=)``), and fused rounds (``fused_rounds``):
on the card each boosting round is one CUDA graph, replayed round after
round (:class:`_RoundStep`).

:func:`train_streaming` is the out-of-core trainer: the binned matrix never
exists; each tree level re-streams raw chunks from a ``DataSource``, binned
on the card as they arrive (:meth:`Binner.transform_chunk`), through the
chunked grower (:func:`repro_torch.core.tree.fit_forest_chunked`).  A
plan with a ``mesh`` routes :func:`train` through the data-parallel
trainer (:func:`repro_torch.distributed.trainer.train_distributed`).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
import traceback
import warnings
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.api.plan import ExecutionPlan, resolve_device, resolve_plan
from repro_torch.core import losses as losses_mod
from repro_torch.core import tree as tree_mod
from repro_torch.core import binning as binning_mod
from repro_torch.core.binning import BinnedDataset, PackedCodes
from repro_torch.kernels import _build, ops
from repro_torch.kernels import traversal as trav_k
from repro_torch.kernels.ref import TreeArrays
from repro_torch.resilience.errors import (NumericalDivergenceError,
                                           TrainingInterrupted)
from repro_torch.resilience.recovery import RecoveryPolicy, classify
from repro_torch.resilience.retry import RetryingSource
from repro_torch.resilience.shutdown import GracefulShutdown


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
    goss_top_rate: float = 0.0       # GOSS: kept fraction by |gradient|
    goss_other_rate: float = 0.0     # GOSS: sampled fraction of the rest
    grow_policy: str = "depthwise"   # "depthwise" | "lossguide"
    max_leaves: Optional[int] = None  # lossguide only
    fused_rounds: bool = False       # a round as one step: on the card one
    #                                  CUDA graph, replayed round after round
    log_every: int = 10              # host-read / verbose cadence (rounds)
    # deprecated per-step strategy settings, lifted into the plan with a
    # DeprecationWarning (repro's Pallas names map onto the CUDA kernels);
    # pass train(plan=ExecutionPlan(...)) instead
    hist_strategy: str = "auto"
    partition_strategy: str = "auto"
    traversal_strategy: str = "auto"
    host_offload_split: bool = False  # the paper's step-② offload
    early_stopping_rounds: Optional[int] = None
    n_classes: Optional[int] = None  # multi:softmax only; K trees per round
    seed: int = 0

    def __post_init__(self):
        if (self.hist_strategy != "auto"
                or self.partition_strategy != "auto"
                or self.traversal_strategy != "auto"
                or self.host_offload_split):
            warnings.warn(
                "legacy strategy-string kwargs are deprecated; "
                "GBDTConfig's hist_strategy / partition_strategy / "
                "traversal_strategy / host_offload_split fields move to "
                "ExecutionPlan — pass plan=ExecutionPlan(...) to "
                "train()/fit() instead", DeprecationWarning, stacklevel=3)
        if self.max_depth < 1 or self.max_depth > 10:
            raise ValueError("max_depth must be in [1, 10]")
        if self.grow_policy not in ("depthwise", "lossguide"):
            raise ValueError(f"unknown grow_policy {self.grow_policy!r}")
        if self.log_every < 1:
            raise ValueError("log_every must be >= 1")
        if self.fused_rounds and self.grow_policy != "depthwise":
            raise ValueError("fused_rounds requires the depthwise "
                             "grow_policy (lossguide growth is host-driven)")
        if self.goss_top_rate or self.goss_other_rate:
            if not (0.0 <= self.goss_top_rate < 1.0
                    and 0.0 < self.goss_other_rate <= 1.0
                    and self.goss_top_rate + self.goss_other_rate <= 1.0):
                raise ValueError(
                    "GOSS rates need 0 <= top_rate < 1, 0 < other_rate <= 1 "
                    f"and top+other <= 1; got top={self.goss_top_rate}, "
                    f"other={self.goss_other_rate}")
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
                       mode: Optional[str] = None,
                       cache=None) -> torch.Tensor:
        """Raw ensemble margins (n,) — (n, K) for a multi-class model — for
        binned ``codes`` (a tensor or ``PackedCodes`` on the model's device,
        or a ``BinnedDataset``, packed or not).

        ``mode="direct"`` (the default) walks the exact request shape:
        each record's leaves are added onto the base margin in tree order,
        the order in which training adds them round by round, so a fit's
        margins and a warm start's replay equal this bit for bit.
        ``mode="cached"`` goes through the compile-once engine
        (:func:`repro_torch.core.inference.predict_margin_cached`; a CUDA
        graph per shape bucket on the card), with ``cache`` (a
        ``PredictCache``) as its namespace, the process-wide default when
        None.  The two modes give the same margins.
        """
        codes = codes.codes if isinstance(codes, BinnedDataset) else codes
        if mode not in (None, "direct", "cached"):
            raise ValueError(f"unknown predict mode {mode!r}; choose "
                             "'cached' or 'direct'")
        with obs.span("gbdt.predict"):
            if mode == "cached":
                from repro_torch.core.inference import predict_margin_cached
                return predict_margin_cached(self, codes, plan=plan,
                                             cache=cache)
            K = self.n_classes
            base = base_margin_tensor(self.base_margin, codes.device)
            out = base.reshape(-1).expand(codes.shape[0], K).clone()
            ops.predict_ensemble(self.trees, codes,
                                 missing_bin=self.missing_bin,
                                 depth=self.max_depth, plan=plan,
                                 n_classes=K, out=out)
            return out[:, 0] if K == 1 else out

    def predict(self, codes, *, plan: Optional[ExecutionPlan] = None,
                mode: Optional[str] = None, cache=None) -> torch.Tensor:
        """Transformed predictions — same surface as :meth:`predict_margin`."""
        return self.loss.transform(self.predict_margin(codes, plan=plan,
                                                       mode=mode,
                                                       cache=cache))

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


def base_margin_tensor(base_margin, device) -> torch.Tensor:
    """The base margin as a float32 tensor on ``device``: () for a scalar
    objective, (K,) for K classes."""
    return torch.as_tensor(np.asarray(base_margin, np.float32),
                           device=device)


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


def _model_rounds(model: "GBDTModel", K: Optional[int]) -> List[TreeArrays]:
    """A model's rounds as a trainer holds them: a (K, ...) forest a
    round for K classes, else one tree a round."""
    if K is not None:
        return _unstack_forests(model.trees, model.n_rounds, K)
    return [TreeArrays(*[a[i] for a in model.trees])
            for i in range(model.n_trees)]


@dataclasses.dataclass
class TrainResult:
    model: GBDTModel
    history: Dict[str, List[float]]
    step_times: Dict[str, float]     # host seconds per paper step, taken
    #                                  without a sync: the device catches up
    #                                  at the loss read, under "other"
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


def goss_sizes(n: int, top_rate: float, other_rate: float):
    """(kept by |gradient|, sampled of the rest) record counts of GOSS over
    n records, as ``repro``'s :func:`goss_weights` sizes them."""
    n_top = min(int(np.ceil(top_rate * n)), n)
    n_other = min(int(np.ceil(other_rate * n)), n - n_top)
    return n_top, n_other


def goss_pick(n: int, top_rate: float, other_rate: float,
              gen: torch.Generator) -> torch.Tensor:
    """GOSS's random draw: ``n_other`` distinct positions among the n −
    n_top records below the top set, by rank (a permutation's head).  It
    does not depend on the gradients, so a fused round draws it before its
    graph replays."""
    n_top, n_other = goss_sizes(n, top_rate, other_rate)
    return torch.randperm(n - n_top, generator=gen,
                          device=gen.device)[:n_other]


def goss_weights(g: torch.Tensor, gen: Optional[torch.Generator],
                 top_rate: float, other_rate: float,
                 pick: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gradient-based One-Side Sampling weights (LightGBM-style GOSS).

    Keeps the top ``top_rate`` fraction of records by gradient magnitude at
    weight 1, samples ``other_rate``·n of the rest uniformly at weight
    ``(1 - top_rate) / other_rate`` (so the small-gradient records keep
    their expected share of g and h) and drops the others (weight 0).
    ``g`` is (n,) or (n, K); multi-class records rank by the sum of their
    per-class |g|.  Records rank by a stable sort of −|g|, the key and tie
    order of ``repro``'s ``jnp.argsort``; the sample is ``pick``
    (:func:`goss_pick`), drawn from ``gen`` when None.  JAX's threefry
    streams cannot be reproduced, so the sample differs from ``repro``'s.
    """
    score = g.abs() if g.ndim == 1 else g.abs().sum(dim=-1)
    n = score.shape[0]
    n_top, n_other = goss_sizes(n, top_rate, other_rate)
    order = torch.argsort(-score, stable=True)
    w = torch.zeros((n,), dtype=torch.float32, device=g.device)
    w.scatter_(0, order[:n_top], 1.0)
    if n_other > 0:
        if pick is None:
            pick = goss_pick(n, top_rate, other_rate, gen)
        w.scatter_(0, order[n_top:][pick], (1.0 - top_rate) / other_rate)
    return w


def _round_draws(config: GBDTConfig, gen: torch.Generator, n: int,
                 F: int) -> Dict[str, torch.Tensor]:
    """The round's random inputs, drawn from its stream in ``repro``'s
    order: GOSS's sample, the subsample uniforms, the field uniforms.  None
    depends on the gradients, so a fused round draws them before its graph
    replays and both trainers draw the same numbers.  Without GOSS the
    stream is consumed as it was before GOSS was ported."""
    draws = {}
    if config.goss_top_rate or config.goss_other_rate:
        draws["goss_pick"] = goss_pick(n, config.goss_top_rate,
                                       config.goss_other_rate, gen)
    if config.subsample < 1.0:
        draws["row_uniform"] = torch.rand((n,), generator=gen,
                                          device=gen.device)
    if config.colsample_bytree < 1.0:
        draws["field_uniform"] = torch.rand((F,), generator=gen,
                                            device=gen.device)
    return draws


def _round_stats(config: GBDTConfig, gen: torch.Generator, g, h, n: int,
                 F: int, K: Optional[int] = None):
    """The round's stochastic filters on the gradient statistics (GOSS,
    row subsampling, the per-tree field mask), drawn from ``gen``; g, h are
    (n,) or, for K classes, (n, K)."""
    return _apply_draws(config, _round_draws(config, gen, n, F), g, h, F, K)


def _apply_draws(config: GBDTConfig, draws: Dict[str, torch.Tensor], g, h,
                 F: int, K: Optional[int] = None):
    """:func:`_round_stats` from the round's ``draws``
    (:func:`_round_draws`).  Reads nothing back from the device."""
    device = g.device
    if "goss_pick" in draws:
        w = goss_weights(g, None, config.goss_top_rate,
                         config.goss_other_rate, pick=draws["goss_pick"])
        if K is not None:
            w = w[:, None]
        g, h = g * w, h * w
    if "row_uniform" in draws:
        mask = (draws["row_uniform"] < config.subsample).to(torch.float32)
        if K is not None:          # same record draw for every class
            mask = mask[:, None]
        g, h = g * mask, h * mask
    if "field_uniform" in draws:
        field_mask = draws["field_uniform"] < config.colsample_bytree
        # keep at least one field: the first drawn in, else field 0
        field_mask = field_mask.scatter(
            0, torch.argmax(field_mask.to(torch.int32)).reshape(1), True)
    else:
        field_mask = torch.ones((F,), dtype=torch.bool, device=device)
    return g, h, field_mask


def _grow_round(config: GBDTConfig, plan: ExecutionPlan,
                loss: losses_mod.Loss, data: BinnedDataset, y, margins,
                draws: Dict[str, torch.Tensor]) -> TreeArrays:
    """Steps ①–④ of one round: gradient statistics, the round's filters,
    the tree (K class trees at once for a multi-class loss) and shrinkage,
    folded into the stored leaves.  Shared by the host loop and the fused
    round."""
    K = loss.n_outputs
    with obs.span("gbdt.grad"):
        g, h = loss.grad_hess(margins, y)
        g, h, field_mask = _apply_draws(config, draws, g, h, data.n_fields,
                                        K)
    common = dict(depth=config.max_depth, n_bins=data.n_bins,
                  missing_bin=data.missing_bin,
                  is_cat_field=data.is_categorical,
                  field_mask=field_mask, lambda_=config.lambda_,
                  gamma=config.gamma,
                  min_child_weight=config.min_child_weight, plan=plan)
    with obs.span("tree.grow"):
        if K is not None:
            # one class-batched pass grows all K per-class trees
            tree = tree_mod.fit_forest(data.codes, data.codes_cm,
                                       g.T.contiguous(), h.T.contiguous(),
                                       **common)
        elif config.grow_policy == "depthwise":
            tree = tree_mod.fit_tree(data.codes, data.codes_cm,
                                     g.contiguous(), h.contiguous(),
                                     **common)
        else:
            tree = tree_mod.fit_tree_lossguide(
                data.codes, data.codes_cm, g.contiguous(), h.contiguous(),
                max_leaves=config.max_leaves, **common)
    # shrinkage is folded into the stored leaf values
    return tree._replace(leaf_value=tree.leaf_value * config.learning_rate)


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


def _mean_loss(loss: losses_mod.Loss, margins, y) -> float:
    """The mean loss, enqueued (``gbdt.loss``), then read: the round's one
    wait on the device (``host.wait``)."""
    with obs.span("gbdt.loss"):
        value = torch.mean(loss.value(margins, y))
    with obs.span("host.wait"):
        return float(value)


def train(config: GBDTConfig, data: BinnedDataset, y,
          eval_set: Optional[Tuple[BinnedDataset, object]] = None,
          init_model: Optional[GBDTModel] = None,
          callback: Optional[Callable[[int, GBDTModel], None]] = None,
          verbose: bool = False,
          plan: Optional[ExecutionPlan] = None,
          device=None,
          recovery: Optional[RecoveryPolicy] = None,
          shutdown: Optional[GracefulShutdown] = None) -> TrainResult:
    """Fit a GBDT ensemble on ``device`` (CUDA by default; the data moves
    there if it lies elsewhere).  ``eval_set`` is ``(BinnedDataset,
    labels)`` and drives early stopping.  ``plan`` selects the kernels of
    every step; when omitted it is lifted from the config's legacy
    per-step fields; a plan with a ``mesh`` runs the fit on the mesh's
    devices through :func:`repro_torch.distributed.trainer.train_distributed`.

    ``init_model`` continues a fit (warm start, checkpoint resume): its
    trees and base margin seed the ensemble, its margins are replayed
    round by round (:func:`_replay_margins`) and ``config.n_trees`` more
    rounds are grown, numbered on from its last, so each draws the random
    stream a one-go fit would have drawn.  With the plain versions on the
    CPU (deterministic), a fit of A rounds continued by B is bit-equal to
    a fit of A + B.

    ``config.fused_rounds`` runs each round as one step
    (:func:`_train_fused`; a CUDA graph on the card).  ``recovery`` arms
    the divergence sentinels: the host loop raises
    :class:`NumericalDivergenceError` at a non-finite loss, the fused loop
    rolls back to its last finite round (see :func:`_train_fused`).
    ``shutdown`` (a :class:`GracefulShutdown`) makes the fit
    preemption-safe: a requested shutdown finishes the round in flight and
    raises :class:`TrainingInterrupted` carrying the partial result.
    """
    plan = (ExecutionPlan.from_config(config) if plan is None
            else resolve_plan(plan))
    if plan.mesh is not None:
        # a training mesh routes the fit through the data-parallel trainer
        # (records sharded over the mesh's data axes, one histogram sum a
        # level); the mesh's devices replace ``device``
        from repro_torch.distributed.trainer import train_distributed
        return train_distributed(config, data, y, eval_set=eval_set,
                                 init_model=init_model, callback=callback,
                                 verbose=verbose, plan=plan,
                                 recovery=recovery, shutdown=shutdown)
    device = resolve_device(device)
    loss = losses_mod.get_loss(config.objective, config.n_classes)
    K = loss.n_outputs                 # None for scalar objectives
    data = data.to(device)
    y = torch.as_tensor(y, dtype=torch.float32, device=device)
    ev_data = ev_y = eval_margins = None
    if eval_set is not None:
        ev_data = eval_set[0].to(device)
        ev_y = torch.as_tensor(eval_set[1], dtype=torch.float32,
                               device=device)
    if K is not None:
        _validate_multiclass_labels(K, y, ev_y)
    n, F = data.codes.shape

    trees: List[TreeArrays] = []       # one entry per round: (K, ...) at K
    history: Dict[str, List[float]] = {"train_loss": []}
    step_times = {"binning_split": 0.0, "traversal": 0.0, "other": 0.0}
    if eval_set is not None:
        history["eval_loss"] = []
    if init_model is not None:
        init_model = _warm_model(init_model, config, K, config.max_depth,
                                 device)
        trees = _model_rounds(init_model, K)
        base_margin = init_model.base_margin
        margins = _replay_margins(init_model, data, plan)
        if eval_set is not None:
            eval_margins = _replay_margins(init_model, ev_data, plan)
    else:
        base_margin = (loss.base_margin(y).cpu().numpy().astype(np.float32)
                       if K is not None else float(loss.base_margin(y)))
        base = base_margin_tensor(base_margin, device)
        margins = base.expand((n,) + base.shape).clone()   # (n,) or (n, K)
        if eval_set is not None:
            eval_margins = base.expand((ev_y.shape[0],) + base.shape).clone()

    def model() -> GBDTModel:
        return _as_model(trees, base_margin, config, data.missing_bin, F)

    if config.fused_rounds:
        return _train_fused(config, plan, loss, data, y, ev_data, ev_y,
                            trees, margins, eval_margins, model, history,
                            step_times, callback, verbose, device, recovery,
                            shutdown)

    best_eval, best_round = np.inf, -1
    # step ⑤ for one round: K class trees at once, or the one tree
    predict_round = _predict_forest if K is not None else _predict_one_tree
    start = len(trees)     # a warm start continues the round numbering
    for t_idx in range(start, start + config.n_trees):
        # step_times take the host's clock only: the device catches up at
        # the loss read, under "other"
        t0 = time.perf_counter()
        with obs.span("gbdt.round"):
            with obs.span("gbdt.draws"):
                draws = _round_draws(
                    config, _round_generator(config, t_idx, device), n, F)
            tree = _grow_round(config, plan, loss, data, y, margins, draws)
            t1 = time.perf_counter()
            step_times["binning_split"] += t1 - t0

            # step ⑤ — one-tree traversal refreshes margins (and thus g, h),
            # adding each leaf into them in place
            with obs.span("gbdt.traverse"):
                margins = predict_round(tree, data, plan, margins)
            t2 = time.perf_counter()
            step_times["traversal"] += t2 - t1

            trees.append(tree)
            train_loss = _mean_loss(loss, margins, y)
            history["train_loss"].append(train_loss)
            stop = False
            if eval_set is not None:
                with obs.span("gbdt.traverse"):
                    eval_margins = predict_round(tree, ev_data, plan,
                                                 eval_margins)
                ev = _mean_loss(loss, eval_margins, ev_y)
                history["eval_loss"].append(ev)
                if ev < best_eval - 1e-12:
                    best_eval, best_round = ev, t_idx
                stop = (config.early_stopping_rounds is not None
                        and t_idx - best_round
                        >= config.early_stopping_rounds)
            step_times["other"] += time.perf_counter() - t2

        if verbose and (t_idx % config.log_every == 0
                        or t_idx == start + config.n_trees - 1):
            print(f"[gbdt] tree {t_idx:4d}  train_loss={train_loss:.6f}")
        # divergence sentinel: the loop reads the loss every round anyway,
        # so the check is free; rollback lives in the fused loop, here it
        # fails fast with the typed error
        if recovery is not None and not np.isfinite(train_loss):
            raise NumericalDivergenceError(
                f"non-finite training loss at round {t_idx}",
                round_index=t_idx, what="loss")
        if callback is not None:
            callback(t_idx, model())
        if shutdown is not None and shutdown.requested:
            _interrupt(shutdown, t_idx, TrainResult(
                model=model(), history=history, step_times=step_times,
                stats={"n_rows": n, "interrupted": True}, margins=margins))
        if stop:
            if verbose:
                print(f"[gbdt] early stop at tree {t_idx} "
                      f"(best {best_round}: {best_eval:.6f})")
            break

    return _fit_end(TrainResult(model=model(), history=history,
                                step_times=step_times, stats={"n_rows": n},
                                margins=margins))


def _fit_end(result: TrainResult) -> TrainResult:
    """A fit's result after its last round, its splits counted
    (:func:`repro_torch.core.tree.record_splits`)."""
    tree_mod.record_splits(result.model.trees)
    return result


def _interrupt(shutdown: GracefulShutdown, t_idx: int,
               partial: TrainResult) -> None:
    """Raise the typed resumable interrupt after round ``t_idx``
    committed, the fit's splits counted."""
    _fit_end(partial)
    raise TrainingInterrupted(
        f"shutdown ({shutdown.signal_name}) after round {t_idx}",
        rounds_done=partial.model.n_rounds, signal_name=shutdown.signal_name,
        result=partial)


# --------------------------------------------------------------------------
# fused boosting rounds: one step a round, a CUDA graph on the card
# --------------------------------------------------------------------------
ROUND_STEP_CACHE = 4       # cached round steps (each holds a copy of its
#                            data and, on the card, a graph's memory pool)
_ROUND_STEPS: "collections.OrderedDict[tuple, _RoundStep]" = \
    collections.OrderedDict()


def _fused_step_key(config: GBDTConfig) -> GBDTConfig:
    """Strip the fields that do not shape a round (loop controls such as
    the seed, the tree count and early stopping, and the legacy strategy
    fields already lifted into the plan), so a seed sweep reuses one
    step."""
    return dataclasses.replace(
        config, n_trees=1, seed=0, early_stopping_rounds=None, log_every=1,
        max_leaves=None, hist_strategy="auto", partition_strategy="auto",
        traversal_strategy="auto", host_offload_split=False)


@dataclasses.dataclass
class _RoundState:
    """What a fused round reads and writes: the data, labels, margins (both
    updated in place) and the round's draws."""
    data: BinnedDataset
    y: torch.Tensor
    margins: torch.Tensor
    ev_data: Optional[BinnedDataset] = None
    ev_y: Optional[torch.Tensor] = None
    ev_margins: Optional[torch.Tensor] = None
    draws: Optional[Dict[str, torch.Tensor]] = None


def _copy_codes(dst, src) -> None:
    if isinstance(src, PackedCodes):
        dst.data.copy_(src.data)
    else:
        dst.copy_(src)


def _clone_codes(codes):
    if isinstance(codes, PackedCodes):
        return PackedCodes(codes.data.clone(), codes.n, codes.bits)
    return codes.clone()


def _static_data(data: Optional[BinnedDataset]) -> Optional[BinnedDataset]:
    if data is None:
        return None
    return dataclasses.replace(data, codes=_clone_codes(data.codes),
                               codes_cm=_clone_codes(data.codes_cm),
                               is_categorical=data.is_categorical.clone())


class _RoundStep:
    """One fused boosting round for one (step key, plan, shapes): gradient
    statistics and the round's filters, the level loop, leaf settling and
    shrinkage, step ⑤ into the train (and eval) margins in place and the
    loss means, all on the device.

    On the card the round is one CUDA graph over static buffers that hold
    a copy of the fit's data, labels and margins (:meth:`begin`) and of
    each round's draws.  The round that meets the step first runs eagerly
    on a side stream, on those buffers (the kernels' first use builds
    their libraries and reads the card's limits, which a capture may not),
    and its result is that round's; then the round is captured there, and
    every later round replays it.  A round that cannot be captured raises,
    naming the operation; it never runs eagerly instead.  On the CPU, and
    under ``host_offload_split`` (which reads the host by design), the same
    round runs eagerly on the fit's own tensors.

    Kernel wrappers count their launches when they run eagerly and when
    they are captured, never at a replay: ``captured`` holds the launches
    one replay makes.
    """

    def __init__(self, config: GBDTConfig, plan: ExecutionPlan,
                 use_graph: bool):
        self.config, self.plan, self.use_graph = config, plan, use_graph
        self.loss = losses_mod.get_loss(config.objective, config.n_classes)
        self.static: Optional[_RoundState] = None
        self.graph = None
        self.outputs = None
        self.captured: Dict[str, int] = {}
        self.runs = 0

    def begin(self, data, y, margins, ev_data=None, ev_y=None,
              ev_margins=None) -> _RoundState:
        """The state a fit's rounds run on: the fit's own tensors, or on
        the card the graph's static buffers with them copied in."""
        if not self.use_graph:
            return _RoundState(data, y, margins, ev_data, ev_y, ev_margins)
        st = self.static
        if st is None:
            self.static = _RoundState(
                _static_data(data), y.clone(), margins.clone(),
                _static_data(ev_data),
                None if ev_y is None else ev_y.clone(),
                None if ev_margins is None else ev_margins.clone())
            return self.static
        for dst, src in ((st.data, data), (st.ev_data, ev_data)):
            if src is not None:
                _copy_codes(dst.codes, src.codes)
                _copy_codes(dst.codes_cm, src.codes_cm)
                dst.is_categorical.copy_(src.is_categorical)
        for dst, src in ((st.y, y), (st.margins, margins),
                         (st.ev_y, ev_y), (st.ev_margins, ev_margins)):
            if src is not None:
                dst.copy_(src)
        return st

    def _body(self, st: _RoundState):
        predict_round = (_predict_forest if self.loss.n_outputs is not None
                         else _predict_one_tree)
        tree = _grow_round(self.config, self.plan, self.loss, st.data, st.y,
                           st.margins, st.draws)
        predict_round(tree, st.data, self.plan, st.margins)
        tl = torch.mean(self.loss.value(st.margins, st.y))
        evl = None
        if st.ev_data is not None:
            predict_round(tree, st.ev_data, self.plan, st.ev_margins)
            evl = torch.mean(self.loss.value(st.ev_margins, st.ev_y))
        return tree, tl, evl

    def run(self, st: _RoundState, draws: Dict[str, torch.Tensor]):
        """One round on ``st`` with ``draws``: ``((tree, train loss, eval
        loss), launches, first)`` — the launches the round made on the card
        and whether it was this step's first run (a capture on the card, a
        trace elsewhere)."""
        first = self.runs == 0
        self.runs += 1
        if not self.use_graph:
            st.draws = draws
            before = _build.launch_counts()
            out = self._body(st)
            return out, _count_delta(before), first
        if st.draws is None:
            st.draws = {k: v.clone() for k, v in draws.items()}
        else:
            for k, v in draws.items():
                st.draws[k].copy_(v)
        if self.graph is None:
            out, eager = self._capture(st)
            return out, eager, first
        self.graph.replay()
        tree, tl, evl = self.outputs
        out = (TreeArrays(*[a.clone() for a in tree]), tl.clone(),
               None if evl is None else evl.clone())
        return out, dict(self.captured), first

    def _capture(self, st: _RoundState):
        dev = st.margins.device
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        before = _build.launch_counts()
        with torch.cuda.stream(stream):
            out = self._body(st)           # this round, eagerly
            eager = _count_delta(before)
            mid = _build.launch_counts()
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                outputs = self._body(st)
            except Exception as exc:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass        # the capture is already invalid
                raise RuntimeError(
                    "a fused round could not be captured as a CUDA graph "
                    f"({self.plan.describe()}): {_where(exc)}") from exc
            graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(stream)
        self.captured = _count_delta(mid)
        self.graph, self.outputs = graph, outputs
        return out, eager


def _count_delta(before: Dict[str, int]) -> Dict[str, int]:
    now = _build.launch_counts()
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


def _where(exc: BaseException) -> str:
    """The operation that raised: the innermost frame of this package in
    the traceback, and the error."""
    frames = traceback.extract_tb(exc.__traceback__)
    own = [f for f in frames if "repro_torch" in f.filename] or frames
    f = own[-1]
    return (f"{f.name} at {f.filename.rsplit('/', 1)[-1]}:{f.lineno} "
            f"({(f.line or '').strip()}) raised {type(exc).__name__}: {exc}")


def _round_step(config: GBDTConfig, plan: ExecutionPlan,
                data: BinnedDataset, n_eval: Optional[int]) -> _RoundStep:
    """The cached step of ``config``'s step key, the plan and the shapes of
    ``data`` (on its device), made on first use (the least recently used
    of ``ROUND_STEP_CACHE`` steps makes room)."""
    device = data.codes.device
    key = (_fused_step_key(config), plan, data.n_records, data.n_fields,
           data.n_bins, n_eval, isinstance(data.codes, PackedCodes), device)
    step = _ROUND_STEPS.get(key)
    if step is None:
        use_graph = device.type == "cuda" and not plan.host_offload_split
        step = _ROUND_STEPS[key] = _RoundStep(key[0], plan, use_graph)
        while len(_ROUND_STEPS) > ROUND_STEP_CACHE:
            _ROUND_STEPS.popitem(last=False)
    _ROUND_STEPS.move_to_end(key)
    return step


def round_step_cache_clear() -> None:
    """Drop every cached fused round step (and its graph and buffers)."""
    _ROUND_STEPS.clear()


def _train_fused(config, plan, loss, data, y, ev_data, ev_y, trees, margins,
                 eval_margins, model, history, step_times, callback, verbose,
                 device, recovery=None, shutdown=None) -> TrainResult:
    """The boosting loop over fused rounds (:class:`_RoundStep`).

    The host reads no per-round value unless it has to: losses stay device
    scalars, read in bulk at the end.  Early stopping reads the eval loss
    each round; the divergence sentinel reads one ``isfinite`` over the
    loss and the margins every ``config.log_every`` rounds.  A trip with a
    ``recovery`` policy rolls the fit back to the last finite sentinel
    snapshot and replays at the same learning rate (a one-off glitch
    replays bit-equal), backing the rate off by
    ``recovery.divergence_backoff`` when the same window diverges twice
    (the learning rate is part of the step key, so that recaptures);
    without a policy the sentinel raises :class:`NumericalDivergenceError`.

    ``stats``: ``fused_graph`` (rounds ran as a CUDA graph),
    ``graph_captures`` (steps met first: captures on the card, traces
    elsewhere), ``graph_replays`` (the other rounds) and ``launches``
    (each kernel's launches in the fit: the eager rounds' and the captured
    launches times the replays).
    """
    live = config                      # LR backoff replaces this copy only
    n, F = data.n_records, data.n_fields
    n_eval = None if ev_data is None else ev_data.n_records
    step = _round_step(live, plan, data, n_eval)
    st = step.begin(data, y, margins, ev_data, ev_y, eval_margins)
    train_dev: List[torch.Tensor] = []
    eval_dev: List[torch.Tensor] = []
    best_eval, best_round = np.inf, -1
    rstats = {"fused_graph": step.use_graph, "graph_captures": 0,
              "graph_replays": 0, "divergence_rollbacks": 0}
    launches: Dict[str, int] = collections.Counter()
    t_loop = time.perf_counter()
    start = len(trees)
    end = start + config.n_trees

    def flush_history():
        # one bulk read materialises the whole loss trajectory
        for name, dev_list in (("train_loss", train_dev),
                               ("eval_loss", eval_dev)):
            if dev_list:
                history[name].extend(torch.stack(dev_list).cpu().tolist())
        step_times["fused_rounds"] = time.perf_counter() - t_loop

    def result(**extra) -> TrainResult:
        flush_history()
        return TrainResult(
            model=model(), history=history, step_times=step_times,
            stats={"n_rows": n, "fused_rounds": True, **rstats,
                   "launches": dict(launches), **extra},
            margins=st.margins.clone())

    def snapshot(t_next):
        """The resumable loop state, taken only at finite sentinel checks,
        so a rollback always lands on finite state."""
        return {"t": t_next, "trees": len(trees), "dev": len(train_dev),
                "margins": st.margins.clone(),
                "eval": (None if st.ev_margins is None
                         else st.ev_margins.clone()),
                "best": (best_eval, best_round)}

    snap = snapshot(start)
    diverged_at = -1                   # sentinel window of the last trip
    t_idx = start
    stop_early = False
    while t_idx < end and not stop_early:
        draws = _round_draws(live, _round_generator(config, t_idx, device),
                             n, F)
        (tree, tl, evl), ran, first = step.run(st, draws)
        launches.update(ran)
        rstats["graph_captures" if first else "graph_replays"] += 1
        trees.append(tree)
        train_dev.append(tl)
        if evl is not None:
            eval_dev.append(evl)
            if config.early_stopping_rounds is not None:
                ev_f = float(evl)               # the one per-round read
                if ev_f < best_eval - 1e-12:
                    best_eval, best_round = ev_f, t_idx
                if t_idx - best_round >= config.early_stopping_rounds:
                    if verbose:
                        print(f"[gbdt] early stop at tree {t_idx} "
                              f"(best {best_round}: {best_eval:.6f})")
                    stop_early = True
        if verbose and (t_idx % config.log_every == 0 or t_idx == end - 1):
            print(f"[gbdt] tree {t_idx:4d}  train_loss={float(tl):.6f}")

        # ---- divergence sentinel (one device reduction, one read)
        if t_idx % config.log_every == 0 or t_idx == end - 1 or stop_early:
            finite = bool(torch.isfinite(tl)
                          & torch.isfinite(st.margins).all())
            if not finite:
                if (recovery is None or rstats["divergence_rollbacks"]
                        >= recovery.max_divergence_rollbacks):
                    raise NumericalDivergenceError(
                        f"non-finite loss/margins at round {t_idx}",
                        round_index=t_idx, what="loss/margins")
                rstats["divergence_rollbacks"] += 1
                obs.record("recoveries")
                del trees[snap["trees"]:]
                del train_dev[snap["dev"]:]
                del eval_dev[snap["dev"]:]
                best_eval, best_round = snap["best"]
                if diverged_at == snap["t"]:
                    # the same window diverged on its replay: genuine
                    # divergence, not a glitch — shrink the steps
                    live = dataclasses.replace(
                        live, learning_rate=(live.learning_rate
                                             * recovery.divergence_backoff))
                    step = _round_step(live, plan, data, n_eval)
                    rstats["fused_graph"] &= step.use_graph
                    if verbose:
                        print(f"[gbdt] round {snap['t']} diverged twice; "
                              f"learning_rate -> {live.learning_rate:g}")
                elif verbose:
                    print(f"[gbdt] divergence at round {t_idx}; rolling "
                          f"back to round {snap['t']}")
                # copies: an eager round updates its margins in place
                st = step.begin(data, y, snap["margins"].clone(), ev_data,
                                ev_y, None if snap["eval"] is None
                                else snap["eval"].clone())
                diverged_at = snap["t"]
                t_idx = snap["t"]
                stop_early = False
                continue
            snap = snapshot(t_idx + 1)
        if callback is not None:
            callback(t_idx, model())
        if shutdown is not None and shutdown.requested:
            _interrupt(shutdown, t_idx, result(interrupted=True))
        t_idx += 1
    _sync(device)
    return _fit_end(result())


def _as_model(trees, base_margin, config, missing_bin, F) -> GBDTModel:
    K = config.n_classes or 1
    stacked = _stack_forests(trees) if K > 1 else _stack_trees(trees)
    return GBDTModel(trees=stacked, base_margin=base_margin,
                     objective=config.objective, missing_bin=missing_bin,
                     n_fields=F, max_depth=config.max_depth, n_classes=K)


def _warm_model(model: GBDTModel, config: GBDTConfig, K: Optional[int],
                depth: int, device: torch.device) -> GBDTModel:
    """``model`` checked against the fit it seeds, its trees on
    ``device``."""
    if model.max_depth != depth:
        raise ValueError(f"init_model has max_depth={model.max_depth}; this "
                         f"fit grows max_depth={depth}")
    if model.n_classes != (K or 1) or model.objective != config.objective:
        raise ValueError(
            f"init_model was trained with objective={model.objective!r}, "
            f"n_classes={model.n_classes}; this fit uses "
            f"{config.objective!r}, n_classes={K or 1}")
    return dataclasses.replace(
        model, trees=TreeArrays(*[a.to(device) for a in model.trees]))


def _replay_margins(model: GBDTModel, data: BinnedDataset,
                    plan: ExecutionPlan) -> torch.Tensor:
    """Seed margins for a continued fit: the base margin plus each round's
    leaves, added round by round in place through step ⑤, as the first
    fit added them, so checkpoint resume and warm start replay bit-exactly
    (and equal the direct ``predict_margin``, which sums in the same
    order).  The trees come from outside, so their field ids are checked
    once (one host read) and not again each round."""
    n, K = data.n_records, model.n_classes
    base = base_margin_tensor(model.base_margin, model.trees.feature.device)
    margins = base.expand((n,) + base.shape).clone()       # (n,) or (n, K)
    trav_k.check_fields(trav_k.pack_node_table(model.trees), data.n_fields,
                        "warm start")
    for r in range(model.n_rounds):
        forest = TreeArrays(*[a[r * K:(r + 1) * K] for a in model.trees])
        margins = _predict_forest(forest, data, plan, margins)
    return margins


def _predict_forest(forest: TreeArrays, data: BinnedDataset,
                    plan: ExecutionPlan, margins=None) -> torch.Tensor:
    """Step-⑤ traversal of one round's K class trees (stacked (K, ...)) in
    one launch: (n, K) leaf values, or, given ``margins`` ((n, K), or (n,)
    at K = 1), those leaves added into them in place (``margins + leaf``,
    bit for bit).  The kernel reads the row-major codes, 4-bit packed or
    not, as they lie: no column gather, no unpack, and no device->host read
    (the grower's field ids are < F by construction).  ``repro`` gathers
    the tree's renumbered columns from the column-major copy where F >
    2^D − 1 (its TPU's memory layout); the decisions, and so the leaves,
    are the same."""
    return ops.traverse_forest(forest, data.codes,
                               missing_bin=data.missing_bin, plan=plan,
                               margins=margins, check_fields=False)


def _predict_one_tree(tree: TreeArrays, data: BinnedDataset,
                      plan: ExecutionPlan, margins=None) -> torch.Tensor:
    """Step-⑤ traversal of one tree -> (n,), or added into (n,)
    ``margins``: the K = 1 case of :func:`_predict_forest`."""
    forest = TreeArrays(*[a[None] for a in tree])
    out = _predict_forest(forest, data, plan, margins)
    return out if margins is not None else out[:, 0]


# --------------------------------------------------------------------------
# out-of-core training: chunk-streamed passes, binned on the device
# --------------------------------------------------------------------------
def binned_pass(source, binner, rows: int, packed: bool, device):
    """One full pass over ``source``: ``(lo, hi, codes)`` for every chunk
    of ``rows`` rows, its raw floats staged in pinned memory and uploaded
    on the copy stream by a :class:`PrefetchIterator`, then binned
    (``Binner.transform_chunk``) and, where ``packed``, 4-bit packed on
    ``device``."""
    from repro_torch.data.pipeline import PrefetchIterator

    def raw():
        for X_chunk, _ in source.chunks(rows):
            X_chunk = np.asarray(X_chunk)
            if X_chunk.shape[0] > rows:
                raise ValueError(
                    f"source yielded a {X_chunk.shape[0]}-row chunk "
                    f"for a {rows}-row request")
            yield X_chunk

    lo = 0
    with PrefetchIterator(raw(), device=device, depth=2) as batches:
        for X in batches:
            codes = binner.transform_chunk(X)
            if packed:
                codes = PackedCodes.pack(codes)
            yield lo, lo + X.shape[0], codes
            lo += X.shape[0]


def _streamed_margins(model: GBDTModel, chunks, n: int, plan: ExecutionPlan,
                      device: torch.device) -> torch.Tensor:
    """Warm-start margins without the matrix: one chunked inference pass.
    The ensemble kernel adds each record's leaves onto the base margin in
    tree order (``ops.predict_ensemble(out=)``), the order in which the fit
    added them round by round, so a checkpoint resume replays bit-exactly
    and equals ``predict_margin`` on the same codes."""
    K = model.n_classes
    base = base_margin_tensor(model.base_margin, device).reshape(-1)
    out = torch.empty((n, K), dtype=torch.float32, device=device)
    for lo, hi, codes in chunks():
        rows = codes.shape[0]
        m = base.expand(rows, K).clone()
        ops.predict_ensemble(model.trees, codes, missing_bin=model.missing_bin,
                             depth=model.max_depth, plan=plan, n_classes=K,
                             out=m if K > 1 else m.view(rows))
        out[lo:hi] = m[:hi - lo]
    return out if K > 1 else out.view(n)


def train_streaming(config: GBDTConfig, source, binner, y, *,
                    eval_set: Optional[Tuple[BinnedDataset, object]] = None,
                    init_model: Optional[GBDTModel] = None,
                    callback: Optional[Callable[[int, GBDTModel], None]] = None,
                    verbose: bool = False,
                    plan: Optional[ExecutionPlan] = None,
                    chunk_rows: Optional[int] = None,
                    recovery: Optional[RecoveryPolicy] = None,
                    shutdown: Optional[GracefulShutdown] = None,
                    device=None) -> TrainResult:
    """Out-of-core twin of :func:`train` on ``device`` (CUDA by default):
    the binned matrix is never materialized.  Each tree level re-streams
    ``source`` in chunks of ``chunk_rows`` records; a worker thread stages
    each raw chunk in pinned memory and uploads it on a copy stream
    (:class:`repro_torch.data.PrefetchIterator`), the chunk is binned on the
    device, bit-equal to ``binner.transform_codes`` (and 4-bit packed when
    the plan packs), and the chunked grower accumulates its histogram and
    routes its node ids.  Margins and labels live on the device; the
    per-record g, h and node ids on the host (pinned).

    source:      a :class:`repro_torch.data.DataSource` of raw float chunks;
                 successive passes must yield identical chunks.
    binner:      a fitted ``Binner``/``StreamingBinner``.
    y:           (n,) labels, gathered from the source by the caller.
    eval_set:    optional in-memory ``(BinnedDataset, y_val)`` pair; drives
                 ``eval_loss`` and early stopping.
    init_model:  continue a fit: its margins come from one streamed
                 inference pass (:func:`_streamed_margins`).
    chunk_rows:  records per chunk; defaults to the plan's ``chunk_bytes``
                 budget (``ExecutionPlan.chunk_rows``), never more than n.
    recovery:    a :class:`repro_torch.resilience.RecoveryPolicy` making
                 rounds self-healing: a transient source failure replays
                 the round (from the newest ``checkpoint_dir`` checkpoint
                 when one exists, else from the in-memory state of the
                 previous round), and a device OOM halves ``chunk_rows``
                 (down to ``min_chunk_rows``, at most ``max_oom_halvings``
                 times) and retries; the chunked sums do not depend on the
                 chunk size.  A round commits its state only after its
                 compute succeeded, and its random stream is keyed by
                 ``(seed, round)``, so a replayed round reproduces the
                 fault-free fit.  ``None`` fails fast.
    shutdown:    a :class:`repro_torch.resilience.GracefulShutdown`: a
                 delivered signal finishes the round in flight, commits it
                 (with a final checkpoint when ``recovery.checkpoint_dir``
                 is set) and raises :class:`TrainingInterrupted` carrying
                 the partial result.

    Data passes a round: ``max_depth + 1`` (one a level, the previous
    level's partition applied in the same pass, and a final partition
    pass).  Step ⑤ needs no pass: the margins update from the final leaf
    slots.  GOSS, subsample and colsample are drawn as :func:`train` draws
    them.  ``config.fused_rounds`` is ignored (a round is a host-driven
    chunk pipeline); ``plan.hist_subtraction`` applies.  A
    :class:`RetryingSource` is closed on every exit.
    """
    device = resolve_device(device)
    plan = (ExecutionPlan.from_config(config) if plan is None
            else resolve_plan(plan))
    if config.grow_policy != "depthwise":
        raise ValueError("streaming training supports only the depthwise "
                         "grow_policy")
    loss = losses_mod.get_loss(config.objective, config.n_classes)
    K = loss.n_outputs
    y = torch.as_tensor(np.asarray(y), dtype=torch.float32, device=device)
    ev_data = ev_y = None
    if eval_set is not None:
        ev_data = eval_set[0].to(device)
        ev_y = torch.as_tensor(np.asarray(eval_set[1]), dtype=torch.float32,
                               device=device)
    if K is not None:
        _validate_multiclass_labels(K, y, ev_y)
    n = int(y.shape[0])
    F = int(source.n_fields)
    depth = config.max_depth
    # resolve the layout before sizing chunks: 4-bit packing halves the
    # code bytes a row, so the same budget holds ~2x the records
    if plan.packed_codes is None:
        plan = plan.replace(
            packed_codes=binner.max_bins <= binning_mod.PACK_MAX_BINS)
    elif plan.packed_codes and binner.max_bins > binning_mod.PACK_MAX_BINS:
        raise ValueError(
            f"plan requests 4-bit packed codes but the binner has "
            f"max_bins={binner.max_bins} > {binning_mod.PACK_MAX_BINS}")
    packed = bool(plan.packed_codes)
    kernel_plan = plan.without_chunking()
    if chunk_rows is None:
        chunk_rows = plan.chunk_rows(F, K or 1)
    # never pad past the data: a small dataset under a large budget would
    # otherwise stream mostly padding
    chunk_state = {"rows": max(1, min(int(chunk_rows), n))}
    missing_bin = binner.max_bins - 1
    is_cat_field = torch.as_tensor(binner._is_cat, device=device)
    n_chunks = [0]

    def binned_chunks():
        """One full pass (:func:`binned_pass`).  The chunk size is read
        once, at the pass's start, so an OOM halving takes effect on the
        retried round's first pass."""
        hi = count = 0
        with contextlib.closing(binned_pass(source, binner,
                                            chunk_state["rows"], packed,
                                            device)) as chunks:
            for lo, hi, codes in chunks:
                yield lo, hi, codes
                count += 1
        if hi != n:
            raise ValueError(
                f"source pass yielded {hi} rows but len(y) == {n}; "
                "DataSource passes must be identical and label-complete")
        n_chunks[0] = count

    trees: List[TreeArrays] = []
    history: Dict[str, List[float]] = {"train_loss": []}
    if eval_set is not None:
        history["eval_loss"] = []
    step_times = {"binning_split": 0.0, "partition": 0.0, "traversal": 0.0,
                  "other": 0.0}

    eval_margins = None
    if init_model is not None:
        init_model = _warm_model(init_model, config, K, depth, device)
        trees = _model_rounds(init_model, K)
        base_margin = init_model.base_margin
        margins = _streamed_margins(init_model, binned_chunks, n,
                                    kernel_plan, device)
        if eval_set is not None:
            eval_margins = init_model.predict_margin(ev_data,
                                                     plan=kernel_plan)
    else:
        base_margin = (loss.base_margin(y).cpu().numpy().astype(np.float32)
                       if K is not None else float(loss.base_margin(y)))
        base = base_margin_tensor(base_margin, device)
        margins = base.expand((n,) + base.shape).clone()   # (n,) or (n, K)
        if eval_set is not None:
            eval_margins = base.expand((ev_y.shape[0],)
                                       + base.shape).clone()
    # the round's statistics cross to the host once, into pinned buffers
    # that the grower's chunk uploads read
    cuda = device.type == "cuda"
    g_host = torch.empty((K or 1, n), dtype=torch.float32, pin_memory=cuda)
    h_host = torch.empty((K or 1, n), dtype=torch.float32, pin_memory=cuda)
    predict_round = _predict_forest if K is not None else _predict_one_tree

    best_eval, best_round = np.inf, -1
    start = len(trees)
    end = start + config.n_trees
    rstats = {"recoveries": 0, "oom_halvings": 0, "replayed_rounds": 0}
    pending_restore = False

    def model() -> GBDTModel:
        return _as_model(trees, base_margin, config, missing_bin, F)

    def save_round_checkpoint(rounds_done: int) -> None:
        # lazy imports: repro_torch.api depends on this module
        from repro_torch.api import serialize
        from repro_torch.core.inference import GBDTPipeline
        serialize.save_checkpoint(recovery.checkpoint_dir,
                                  GBDTPipeline(binner=binner, model=model()),
                                  rounds_done)

    def restore_state():
        """Trainer state from the newest valid checkpoint: trees from the
        bundled model, margins from one streamed inference pass (no
        per-record state is checkpointed)."""
        from repro_torch.api import serialize
        pipe, _step = serialize.load_checkpoint(recovery.checkpoint_dir,
                                                device=device)
        restored = _warm_model(pipe.model, config, K, depth, device)
        rmargins = _streamed_margins(restored, binned_chunks, n,
                                     kernel_plan, device)
        rev = (restored.predict_margin(ev_data, plan=kernel_plan)
               if eval_set is not None else None)
        rtrees = _model_rounds(restored, K)
        return rtrees, rmargins, rev, len(rtrees)

    def stats() -> Dict:
        return {"n_rows": n, "chunk_rows": int(chunk_state["rows"]),
                "n_chunks": int(n_chunks[0]),
                "passes_per_round": depth + 1, **rstats}

    t_idx = t_done = start
    try:
        while t_idx < end:
            try:
                if pending_restore:
                    trees, margins, eval_margins, t_idx = restore_state()
                    rstats["replayed_rounds"] += max(0, t_done - t_idx)
                    del history["train_loss"][t_idx - start:]
                    if eval_set is not None:
                        del history["eval_loss"][t_idx - start:]
                        evs = history["eval_loss"]
                        best_eval = min(evs) if evs else np.inf
                        best_round = (start + int(np.argmin(evs))) if evs \
                            else -1
                    pending_restore = False

                t0 = time.perf_counter()
                g, h = loss.grad_hess(margins, y)
                g, h, field_mask = _round_stats(
                    config, _round_generator(config, t_idx, device), g, h,
                    n, F, K)
                g_host.copy_(g.T if K is not None else g[None],
                             non_blocking=True)
                h_host.copy_(h.T if K is not None else h[None],
                             non_blocking=True)
                forest, leaf_ids = tree_mod.fit_forest_chunked(
                    binned_chunks, g_host, h_host, depth=depth,
                    n_bins=binner.max_bins, missing_bin=missing_bin,
                    is_cat_field=is_cat_field, field_mask=field_mask,
                    lambda_=config.lambda_, gamma=config.gamma,
                    min_child_weight=config.min_child_weight,
                    plan=kernel_plan)
                forest = forest._replace(
                    leaf_value=forest.leaf_value * config.learning_rate)
                _sync(device)
                t1 = time.perf_counter()

                # step ⑤ without a pass: the chunk-local node ids end as
                # leaf slots, so the margins update by a leaf lookup
                delta = torch.gather(forest.leaf_value, 1, leaf_ids.long())
                tree = forest if K is not None else TreeArrays(
                    *[a[0] for a in forest])
                new_margins = margins + (delta.T if K is not None
                                         else delta[0])
                _sync(device)
                t2 = time.perf_counter()

                new_eval_margins, ev = None, None
                if eval_set is not None:
                    new_eval_margins = predict_round(
                        tree, ev_data, kernel_plan, eval_margins.clone())
                    ev = float(torch.mean(loss.value(new_eval_margins,
                                                     ev_y)))
            except Exception as exc:  # noqa: BLE001 — classified below
                action = classify(exc) if recovery is not None else "fatal"
                if action == "oom":
                    rows = chunk_state["rows"]
                    new_rows = max(recovery.min_chunk_rows, rows // 2)
                    if (new_rows >= rows or rstats["oom_halvings"]
                            >= recovery.max_oom_halvings):
                        raise
                    rstats["oom_halvings"] += 1
                    obs.record("recoveries")
                    chunk_state["rows"] = new_rows
                    if cuda:
                        torch.cuda.empty_cache()
                    if verbose:
                        print(f"[gbdt] device OOM at tree {t_idx}: "
                              f"chunk_rows {rows} -> {new_rows}; "
                              "retrying round")
                    continue
                if action == "transient":
                    if rstats["recoveries"] >= recovery.max_recoveries:
                        raise
                    rstats["recoveries"] += 1
                    obs.record("recoveries")
                    if recovery.retry_delay_s:
                        time.sleep(recovery.retry_delay_s)
                    if recovery.checkpoint_dir is not None:
                        from repro_torch.api import serialize
                        pending_restore = serialize.has_checkpoint(
                            recovery.checkpoint_dir)
                    if verbose:
                        how = ("restoring newest checkpoint"
                               if pending_restore
                               else "replaying round in memory")
                        print(f"[gbdt] transient failure at tree {t_idx} "
                              f"({type(exc).__name__}: {exc}); {how}")
                    continue
                raise

            # ---- commit: the round succeeded, mutate state at once
            step_times["binning_split"] += t1 - t0
            step_times["traversal"] += t2 - t1
            margins = new_margins
            trees.append(tree)
            train_loss = float(torch.mean(loss.value(margins, y)))
            history["train_loss"].append(train_loss)
            stop_early = False
            if eval_set is not None:
                eval_margins = new_eval_margins
                history["eval_loss"].append(ev)
                if ev < best_eval - 1e-12:
                    best_eval, best_round = ev, t_idx
                if (config.early_stopping_rounds is not None
                        and t_idx - best_round
                        >= config.early_stopping_rounds):
                    if verbose:
                        print(f"[gbdt] early stop at tree {t_idx} "
                              f"(best {best_round}: {best_eval:.6f})")
                    stop_early = True
            step_times["other"] += time.perf_counter() - t2

            if verbose and (t_idx % config.log_every == 0
                            or t_idx == end - 1):
                print(f"[gbdt] tree {t_idx:4d}  "
                      f"train_loss={train_loss:.6f}  "
                      f"({n_chunks[0]} chunks x {chunk_state['rows']} rows)")
            t_done = t_idx + 1
            if (recovery is not None and recovery.checkpoint_dir is not None
                    and (t_done - start) % recovery.checkpoint_every == 0):
                save_round_checkpoint(t_done)
            if callback is not None:
                callback(t_idx, model())
            t_idx = t_done
            if shutdown is not None and shutdown.requested:
                # the round in flight is committed: persist the resumable
                # state, then exit with a typed status
                if (recovery is not None
                        and recovery.checkpoint_dir is not None
                        and (t_done - start) % recovery.checkpoint_every):
                    save_round_checkpoint(t_done)
                partial = TrainResult(
                    model=model(), history=history, step_times=step_times,
                    stats={**stats(), "interrupted": True}, margins=margins)
                raise TrainingInterrupted(
                    f"shutdown ({shutdown.signal_name}) after round "
                    f"{t_done - 1}", rounds_done=len(trees),
                    signal_name=shutdown.signal_name,
                    checkpoint_dir=(recovery.checkpoint_dir
                                    if recovery is not None else None),
                    result=partial)
            if stop_early:
                break

        return TrainResult(model=model(), history=history,
                           step_times=step_times, stats=stats(),
                           margins=margins)
    finally:
        # a fit never leaks the retry wrapper's watchdog thread or its
        # open shard handles, however it exits
        if isinstance(source, RetryingSource):
            source.close()

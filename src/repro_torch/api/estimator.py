"""sklearn/XGBoost-style estimators over the port's training engine.

The counterpart of :mod:`repro.api.estimator` for the in-memory path.
``BoosterRegressor`` / ``BoosterClassifier`` own the whole vertical: raw
NaN-carrying feature matrices in, predictions out.  Binning, kernel
selection (:class:`~repro_torch.api.plan.ExecutionPlan`), training
(``core.gbdt.train``), warm start, checkpoint resume and the serving
engine all live behind ``fit`` / ``predict``.  The estimator runs on
``device`` (a constructor parameter, CUDA by default); like ``plan`` it is
a runtime choice, and a bundle never carries it.

The training variants reach ``train`` as they do in ``repro``:
``grow_policy="lossguide"`` with ``max_leaves``, GOSS, ``fused_rounds``,
and ``fit(recovery=, shutdown=)``.  ``fit(data=...)`` (a ``DataSource``, an
``(X, y)`` tuple or an npz-shard directory), or arrays under
``ExecutionPlan(chunk_bytes=...)``, trains out-of-core through
``core.gbdt.train_streaming``.  ``fit(mesh=...)`` (or a plan carrying a
mesh) trains data-parallel through
``distributed.trainer.train_distributed``, and ``predict`` under a plan
with a mesh goes through ``core.inference.sharded_predict``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.api import serialize
from repro_torch.api.plan import ExecutionPlan, resolve_device, resolve_plan
from repro_torch.core.binning import Binner, StreamingBinner
from repro_torch.core.gbdt import (GBDTConfig, GBDTModel, TrainResult,
                                   _predict_forest, base_margin_tensor,
                                   train, train_streaming)
from repro_torch.core.inference import (GBDTPipeline, feature_importance,
                                        pad_trees, sharded_predict)
from repro_torch.kernels.ref import TreeArrays
from repro_torch.resilience.errors import TrainingInterrupted
from repro_torch.resilience.recovery import RecoveryPolicy


def _validate_labels(y: np.ndarray, what: str = "y") -> None:
    """Reject NaN/inf labels up front: one non-finite label poisons every
    gradient, so the fit would produce a garbage model instead of failing
    here with the row index."""
    if np.issubdtype(y.dtype, np.number):
        finite = np.isfinite(np.asarray(y, np.float64))
        if not finite.all():
            bad = int(y.shape[0] - finite.sum())
            first = int(np.argmin(finite))
            raise ValueError(
                f"{what} contains {bad} non-finite label(s) (first at row "
                f"{first}); NaN/inf labels are never valid — clean or drop "
                "those rows before fitting")


def _validate_fit_arrays(X: np.ndarray, y: np.ndarray,
                         what: str = "fit") -> None:
    """Shape/content checks shared by the fit entry points: 2-D X, equal
    lengths, at least one row, finite labels."""
    if X.ndim != 2:
        raise ValueError(
            f"{what} expects a 2-D feature matrix, got shape {X.shape}")
    if X.shape[0] == 0:
        raise ValueError(f"{what} received an empty dataset (X has 0 rows)")
    if y.shape[0] != X.shape[0]:
        raise ValueError(
            f"{what}: X has {X.shape[0]} rows but y has {y.shape[0]} "
            "labels — they must align row-for-row")
    _validate_labels(y, what=f"{what} labels")


# the keys of repro's estimator, plus the runtime device
_PARAM_DEFAULTS: Dict[str, Any] = dict(
    n_trees=100, max_depth=6, learning_rate=0.1, lambda_=1.0, gamma=0.0,
    min_child_weight=1.0, objective=None, subsample=1.0,
    colsample_bytree=1.0, goss_top_rate=0.0, goss_other_rate=0.0,
    grow_policy="depthwise", max_leaves=None, fused_rounds=False,
    log_every=10,
    early_stopping_rounds=None, max_bins=256, categorical_fields=None,
    sketch_size=32768, n_classes=None, seed=0, plan=None, device=None)


class NotFittedError(RuntimeError):
    """Raised when predict/save is called before ``fit``."""


class BoosterEstimator:
    """Base estimator: hyper-parameters + a fitted (binner, model) pair.

    ``get_params`` / ``set_params`` follow the sklearn contract; every
    constructor argument is a parameter.  ``plan`` (an
    :class:`ExecutionPlan`) and ``device`` are runtime choices; ``plan``
    may also be given per ``fit``/``predict`` call.
    """

    _default_objective: str = "reg:squarederror"

    def __init__(self, **params):
        unknown = set(params) - set(_PARAM_DEFAULTS)
        if unknown:
            raise TypeError(f"unknown estimator parameter(s): "
                            f"{sorted(unknown)}")
        for name, default in _PARAM_DEFAULTS.items():
            setattr(self, name, self._normalize(name,
                                                params.get(name, default)))
        self._model: Optional[GBDTModel] = None
        self._binner: Optional[Binner] = None
        self._result: Optional[TrainResult] = None

    @staticmethod
    def _normalize(name: str, value: Any) -> Any:
        # sequences of categorical field ids become plain int tuples so
        # params stay hashable, comparable and JSON-safe
        if (name == "categorical_fields" and value is not None
                and not isinstance(value, tuple)):
            return tuple(int(c) for c in value)
        return value

    # -- sklearn plumbing --------------------------------------------------
    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        return {name: getattr(self, name) for name in _PARAM_DEFAULTS}

    def set_params(self, **params) -> "BoosterEstimator":
        unknown = set(params) - set(_PARAM_DEFAULTS)
        if unknown:
            raise ValueError(f"invalid parameter(s) for "
                             f"{type(self).__name__}: {sorted(unknown)}")
        for name, value in params.items():
            setattr(self, name, self._normalize(name, value))
        return self

    def __repr__(self) -> str:
        changed = {k: v for k, v in self.get_params().items()
                   if v != _PARAM_DEFAULTS[k]}
        args = ", ".join(f"{k}={v!r}" for k, v in sorted(changed.items()))
        return f"{type(self).__name__}({args})"

    # -- fitted-state access ----------------------------------------------
    @property
    def is_fitted(self) -> bool:
        return self._model is not None

    def _check_fitted(self) -> GBDTModel:
        if self._model is None:
            raise NotFittedError(
                f"this {type(self).__name__} instance is not fitted yet; "
                "call fit(X, y) first")
        return self._model

    @property
    def model_(self) -> GBDTModel:
        return self._check_fitted()

    @property
    def binner_(self) -> Binner:
        self._check_fitted()
        return self._binner

    @property
    def n_trees_(self) -> int:
        return self._check_fitted().n_trees

    @property
    def history_(self) -> Dict[str, list]:
        self._check_fitted()
        return self._result.history if self._result is not None else {}

    def evals_result(self) -> Dict[str, list]:
        return self.history_

    @property
    def step_times_(self) -> Dict[str, float]:
        """Host seconds per paper step from the last ``fit``, summed over
        its rounds.  The host loop takes them without a sync: the device
        catches up at the round's loss read, which falls under
        ``"other"``; the sum a round is still the round's wall time."""
        self._check_fitted()
        return self._result.step_times if self._result is not None else {}

    @property
    def stats_(self) -> Dict[str, Any]:
        """Trainer extras from the last ``fit``."""
        self._check_fitted()
        return self._result.stats if self._result is not None else {}

    @property
    def feature_importances_(self) -> np.ndarray:
        """Gain-style per-field importances (normalized to sum 1)."""
        return feature_importance(self._check_fitted(), kind="gain")

    # -- plan, device, objective -------------------------------------------
    def _resolve_plan(self, plan: Optional[ExecutionPlan]) -> ExecutionPlan:
        return resolve_plan(plan if plan is not None else self.plan)

    def _device(self, mesh=None) -> torch.device:
        """The estimator's device; unset, a mesh's first device, else
        CUDA."""
        if self.device is None and mesh is not None:
            return mesh.devices.flat[0]
        return resolve_device(self.device)

    def _resolve_objective(self, y: np.ndarray
                           ) -> Tuple[str, Optional[int]]:
        """(objective, n_classes) for this fit.  The classifier overrides
        this to auto-detect multi-class label sets."""
        return self.objective or self._default_objective, self.n_classes

    def _config(self, n_trees: int, objective: Optional[str] = None,
                n_classes: Optional[int] = None) -> GBDTConfig:
        """``objective``/``n_classes`` are the *resolved* pair from
        ``_resolve_objective``; ``n_classes`` is used verbatim (a resolved
        scalar objective carries K = None)."""
        return GBDTConfig(
            n_trees=n_trees, max_depth=self.max_depth,
            learning_rate=self.learning_rate, lambda_=self.lambda_,
            gamma=self.gamma, min_child_weight=self.min_child_weight,
            objective=objective or self.objective or self._default_objective,
            subsample=self.subsample,
            colsample_bytree=self.colsample_bytree,
            goss_top_rate=self.goss_top_rate,
            goss_other_rate=self.goss_other_rate,
            grow_policy=self.grow_policy, max_leaves=self.max_leaves,
            fused_rounds=self.fused_rounds, log_every=self.log_every,
            early_stopping_rounds=self.early_stopping_rounds,
            n_classes=n_classes, seed=self.seed)

    # -- fit ---------------------------------------------------------------
    def fit(self, X=None, y=None, *, data: Any = None,
            eval_set: Optional[Tuple] = None,
            xgb_model: Any = None, plan: Optional[ExecutionPlan] = None,
            mesh: Any = None,
            checkpoint_dir: Optional[str] = None,
            checkpoint_every: int = 25, callback=None,
            verbose: bool = False,
            recovery: Optional[RecoveryPolicy] = None,
            shutdown: Any = None) -> "BoosterEstimator":
        """Bin ``X`` (raw floats, NaN == missing) and boost ``self.n_trees``
        trees on the estimator's device.

        eval_set:        optional raw ``(X_val, y_val)`` pair — enables the
                         eval history and ``early_stopping_rounds``.
        xgb_model:       warm start: a fitted estimator, ``GBDTPipeline``,
                         ``GBDTModel``, or a bundle path (of either
                         package) — ``n_trees`` *additional* trees are
                         grown (XGBoost semantics).
        data:            out-of-core input in place of (X, y): a
                         ``repro_torch.data.DataSource``, an ``(X, y)``
                         tuple or an npz-shard directory path.  One pass
                         gathers the labels and feeds a
                         ``StreamingBinner``'s sketches, then
                         ``train_streaming`` re-streams the chunks a level
                         at a time.  Arrays with a plan that sets
                         ``chunk_bytes`` stream through an ``ArraySource``.
        plan:            ExecutionPlan override for this fit.
        mesh:            a data-parallel training mesh
                         (:class:`repro_torch.launch.mesh.Mesh`): records
                         shard over its data axes and the fit runs through
                         ``train_distributed``; the same as
                         ``plan.replace(mesh=mesh)``.  Not with ``data=``
                         or ``plan.chunk_bytes`` (out-of-core).  Binning
                         runs on the mesh's first device unless the
                         estimator names a device.
        checkpoint_dir:  when set, resumes from the newest valid step
                         checkpoint and writes one every
                         ``checkpoint_every`` rounds (atomic, sha-verified).
                         An explicit ``xgb_model`` takes precedence over
                         any existing checkpoints (a warning is emitted).
        recovery:        a :class:`repro_torch.resilience.RecoveryPolicy`
                         arming the divergence sentinels (the host loop
                         raises the typed error, fused rounds roll back and
                         back the learning rate off); a streamed fit
                         replays transient failures from a checkpoint or
                         memory and halves its chunks on a device OOM (its
                         ``checkpoint_dir`` defaults to this fit's).
        shutdown:        a :class:`repro_torch.resilience.GracefulShutdown`
                         — on SIGTERM/SIGINT the trainer finishes the round
                         in flight and raises a resumable
                         :class:`TrainingInterrupted`; the estimator keeps
                         the partial model as fitted state and, with
                         ``checkpoint_dir``, saves a resume checkpoint
                         before re-raising.
        """
        plan = self._resolve_plan(plan)
        if mesh is not None:
            plan = plan.replace(mesh=mesh)
        if plan.mesh is not None and (data is not None
                                      or plan.chunk_bytes is not None):
            raise ValueError(
                "distributed training (mesh=) shards in-memory records and "
                "cannot combine with the out-of-core streaming path "
                "(data=/plan.chunk_bytes); drop one of the two")
        if data is None and plan.chunk_bytes is not None and X is not None:
            if y is None:
                raise TypeError("fit needs (X, y) arrays or data=DataSource")
            from repro_torch.data.pipeline import ArraySource
            # no eager float64 copy: the chunk_bytes cap is the point
            data, X, y = ArraySource(np.asarray(X), np.asarray(y)), None, None
        if data is not None:
            if X is not None or y is not None:
                raise ValueError(
                    "pass either (X, y) arrays or data=..., not both")
            return self._fit_streaming(
                data, eval_set=eval_set, xgb_model=xgb_model, plan=plan,
                checkpoint_dir=checkpoint_dir,
                checkpoint_every=checkpoint_every, callback=callback,
                verbose=verbose, recovery=recovery, shutdown=shutdown)
        if (recovery is not None and recovery.checkpoint_dir is None
                and checkpoint_dir is not None):
            recovery = dataclasses.replace(
                recovery, checkpoint_dir=checkpoint_dir,
                checkpoint_every=checkpoint_every)
        device = self._device(plan.mesh)
        if X is None or y is None:
            raise TypeError("fit needs (X, y) arrays or data=DataSource")
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y)
        _validate_fit_arrays(X, y)
        objective, n_classes = self._resolve_objective(y)

        init_model, binner, n_trees = self._resume_or_warm_start(
            xgb_model, checkpoint_dir, verbose)
        objective, n_classes = self._check_warm_model(init_model, objective,
                                                      n_classes)
        config = self._config(n_trees, objective, n_classes)

        if binner is None:
            binner = Binner(max_bins=self.max_bins,
                            categorical_fields=self.categorical_fields)
            binner.fit(X)
        data = binner.transform(X, device=device)
        ev = None
        if eval_set is not None:
            X_val, y_val = eval_set
            X_val = np.asarray(X_val, dtype=np.float64)
            y_val = np.asarray(y_val, dtype=np.float32)
            _validate_fit_arrays(X_val, y_val, what="eval_set")
            ev = (binner.transform(X_val, device=device), y_val)

        def cb(t_idx, model):
            if callback is not None:
                callback(t_idx, model)
            if (checkpoint_dir is not None
                    and (t_idx + 1) % checkpoint_every == 0):
                serialize.save_checkpoint(
                    checkpoint_dir,
                    GBDTPipeline(binner=binner, model=model), t_idx + 1)

        try:
            result = train(config, data, y, eval_set=ev,
                           init_model=init_model, callback=cb,
                           verbose=verbose, plan=plan, device=device,
                           recovery=recovery, shutdown=shutdown)
        except TrainingInterrupted as stop:
            self._finish_interrupted(stop, binner, checkpoint_dir)
            raise
        self._model, self._binner, self._result = result.model, binner, result
        if checkpoint_dir is not None:
            # step numbers count ROUNDS (the unit of the per-round saves)
            serialize.save_checkpoint(checkpoint_dir, self,
                                      result.model.n_rounds)
        return self

    def _fit_streaming(self, data, *, eval_set, xgb_model, plan,
                       checkpoint_dir, checkpoint_every, callback,
                       verbose, recovery=None,
                       shutdown=None) -> "BoosterEstimator":
        """``fit`` over a chunked DataSource: one pass gathers the labels
        and feeds a ``StreamingBinner`` (unless a warm start fixes the
        bins), then ``core.gbdt.train_streaming`` re-streams the chunks a
        level at a time; the binned matrix never exists."""
        from repro_torch.data.pipeline import as_source

        device = self._device()
        source = as_source(data)
        F = source.n_fields
        init_model, binner, n_trees = self._resume_or_warm_start(
            xgb_model, checkpoint_dir, verbose)

        # pass 0: the labels, and the quantile sketches when no warm binner
        # fixes the bin edges already
        sketch = None
        if binner is None:
            binner = sketch = StreamingBinner(
                max_bins=self.max_bins,
                categorical_fields=self.categorical_fields,
                sketch_size=self.sketch_size)
        ys = []
        for X_chunk, y_chunk in source.chunks(plan.chunk_rows(F)):
            if y_chunk is None:
                raise ValueError(
                    "streaming fit needs a labeled DataSource (every "
                    "chunk must yield a y)")
            if sketch is not None:
                sketch.partial_fit(X_chunk)
            ys.append(np.asarray(y_chunk))
        if not ys:
            raise ValueError("DataSource yielded no chunks")
        if sketch is not None:
            sketch.finalize()
        y = np.concatenate(ys)
        _validate_labels(y, what="streamed labels")

        objective, n_classes = self._resolve_objective(y)
        objective, n_classes = self._check_warm_model(init_model, objective,
                                                      n_classes)
        ev = None
        if eval_set is not None:
            X_val, y_val = eval_set
            X_val = np.asarray(X_val, dtype=np.float64)
            y_val = np.asarray(y_val, dtype=np.float32)
            _validate_fit_arrays(X_val, y_val, what="eval_set")
            ev = (binner.transform(X_val, device=device), y_val)

        if (recovery is not None and recovery.checkpoint_dir is None
                and checkpoint_dir is not None):
            recovery = dataclasses.replace(
                recovery, checkpoint_dir=checkpoint_dir,
                checkpoint_every=checkpoint_every)
        # when the trainer checkpoints, the callback must not write the
        # same steps again
        trainer_saves = (recovery is not None
                         and recovery.checkpoint_dir is not None)

        def cb(t_idx, model):
            if callback is not None:
                callback(t_idx, model)
            if (not trainer_saves and checkpoint_dir is not None
                    and (t_idx + 1) % checkpoint_every == 0):
                serialize.save_checkpoint(
                    checkpoint_dir,
                    GBDTPipeline(binner=binner, model=model), t_idx + 1)

        try:
            result = train_streaming(
                self._config(n_trees, objective, n_classes), source, binner,
                y, eval_set=ev, init_model=init_model, callback=cb,
                verbose=verbose, plan=plan, recovery=recovery,
                shutdown=shutdown, device=device)
        except TrainingInterrupted as stop:
            self._finish_interrupted(stop, binner, checkpoint_dir)
            raise
        self._model, self._binner, self._result = result.model, binner, result
        if checkpoint_dir is not None:
            serialize.save_checkpoint(checkpoint_dir, self,
                                      result.model.n_rounds)
        return self

    def _finish_interrupted(self, stop: TrainingInterrupted, binner,
                            checkpoint_dir: Optional[str]) -> None:
        """A graceful shutdown stopped the fit after a committed round:
        keep the partial ensemble as fitted state and save a resume
        checkpoint (step = rounds, the unit of the per-round saves), then
        let the typed error propagate."""
        if stop.result is None or stop.result.model is None:
            return
        self._model, self._binner = stop.result.model, binner
        self._result = stop.result
        if checkpoint_dir is not None and self._model.n_rounds > 0:
            serialize.save_checkpoint(checkpoint_dir, self,
                                      self._model.n_rounds)
            if stop.checkpoint_dir is None:
                stop.checkpoint_dir = checkpoint_dir

    def _resume_or_warm_start(self, xgb_model: Any,
                              checkpoint_dir: Optional[str],
                              verbose: bool):
        """(init_model, binner, n_trees_to_grow) from an explicit warm
        start and/or the newest valid step checkpoint (xgb_model wins)."""
        n_trees = self.n_trees
        init_model, binner = self._warm_start(xgb_model)
        if checkpoint_dir is not None and serialize.has_checkpoint(
                checkpoint_dir):
            if xgb_model is not None:
                warnings.warn(
                    f"{checkpoint_dir!r} already holds checkpoints; the "
                    "explicit xgb_model wins and they are ignored (new "
                    "checkpoints will overwrite colliding steps)",
                    UserWarning, stacklevel=3)
            else:
                try:
                    restored, step = serialize.load_checkpoint(
                        checkpoint_dir, device=self._device())
                except (FileNotFoundError, ValueError, KeyError):
                    # step dirs exist but none holds a valid bundle payload
                    restored = None
                if restored is not None:
                    init_model, binner = self._warm_parts(restored)
                    # multi-class rounds grow K trees each — count rounds
                    n_trees = max(0, self.n_trees - init_model.n_rounds)
                    if verbose:
                        print(f"[{type(self).__name__}] resuming from "
                              f"checkpoint step {step} "
                              f"({init_model.n_rounds} rounds)")
        return init_model, binner, n_trees

    def _check_warm_model(self, init_model: Optional[GBDTModel],
                          objective: str, n_classes: Optional[int]):
        """Validate warm-start/checkpoint compatibility; returns the
        (objective, n_classes) pair the continued fit must use."""
        if init_model is None:
            return objective, n_classes
        if init_model.max_depth != self.max_depth:
            raise ValueError(
                f"warm-start/checkpoint model has max_depth="
                f"{init_model.max_depth} but this estimator is "
                f"configured with max_depth={self.max_depth}")
        if init_model.n_classes > 1:
            # the fitted model's objective/K win: labels of a continuation
            # batch only bound K from below
            if (self.objective not in (None, init_model.objective)
                    or objective not in ("binary:logistic",
                                         init_model.objective)):
                raise ValueError(
                    f"warm-start/checkpoint model was trained with "
                    f"objective={init_model.objective!r} but this "
                    f"estimator uses {objective!r}")
            if self.n_classes not in (None, init_model.n_classes):
                raise ValueError(
                    f"warm-start/checkpoint model has n_classes="
                    f"{init_model.n_classes} but this estimator sets "
                    f"n_classes={self.n_classes}")
            if (n_classes or 0) > init_model.n_classes:
                raise ValueError(
                    f"labels reach class {n_classes - 1} but the "
                    f"warm-start/checkpoint model has n_classes="
                    f"{init_model.n_classes}")
            return init_model.objective, init_model.n_classes
        if init_model.objective != objective:
            raise ValueError(
                f"warm-start/checkpoint model was trained with "
                f"objective={init_model.objective!r} but this "
                f"estimator uses {objective!r}")
        return objective, n_classes

    def _warm_start(self, xgb_model: Any
                    ) -> Tuple[Optional[GBDTModel], Optional[Binner]]:
        if xgb_model is None:
            return None, None
        if isinstance(xgb_model, str):
            xgb_model = serialize.load(xgb_model, device=self._device())
        return self._warm_parts(xgb_model)

    @staticmethod
    def _warm_parts(obj: Any) -> Tuple[GBDTModel, Optional[Binner]]:
        if isinstance(obj, BoosterEstimator):
            return obj._check_fitted(), obj._binner
        if isinstance(obj, GBDTPipeline):
            return obj.model, obj.binner
        if isinstance(obj, GBDTModel):
            return obj, None
        raise TypeError(f"cannot warm-start from {type(obj).__name__}")

    # -- predict -----------------------------------------------------------
    def _bin(self, X):
        self._check_fitted()
        return self._binner.transform(np.asarray(X, dtype=np.float64),
                                      device=self._model.trees.feature.device)

    def predict_margin(self, X, *, plan: Optional[ExecutionPlan] = None
                       ) -> torch.Tensor:
        """Raw ensemble margins for raw (unbinned) ``X``, through the
        serving engine: binned on the device, predicted through the
        shape-bucketed graph cache (:mod:`repro_torch.core.inference`).
        A plan carrying a mesh runs ``sharded_predict`` on it instead."""
        model = self._check_fitted()
        plan = self._resolve_plan(plan)
        if plan.mesh is not None:
            # paper §III-D: trees shard over "model" (zero-padded to divide
            # it, in multiples of K), records over the data axes
            padded = pad_trees(model, plan.mesh.shape.get("model", 1)
                               * max(model.n_classes, 1))
            return sharded_predict(plan.mesh, padded, self._bin(X).codes,
                                   plan=plan)
        return self.to_pipeline().predict_margin(X, plan=plan)

    def predict(self, X, *, plan: Optional[ExecutionPlan] = None
                ) -> torch.Tensor:
        model = self._check_fitted()
        return model.loss.transform(self.predict_margin(X, plan=plan))

    def staged_predict(self, X, *, plan: Optional[ExecutionPlan] = None
                       ) -> Iterator[torch.Tensor]:
        """Yield predictions after each boosting round (1..n_rounds).

        For scalar objectives the k-th yield equals ``predict`` of the
        k-tree prefix ensemble; multi-class models add one forest (K
        class trees) a stage and yield the (n, K) softmax rows.  Each
        round's leaves are added in tree order, so the last stage equals
        ``predict`` bit for bit where both bin ``X`` alike.
        """
        model = self._check_fitted()
        plan = self._resolve_plan(plan)
        data = self._bin(X)
        K = model.n_classes
        base = base_margin_tensor(model.base_margin,
                                  model.trees.feature.device)
        margin = base.expand((data.n_records,) + base.shape)
        for r in range(model.n_rounds):
            forest = TreeArrays(*[a[r * K:(r + 1) * K] for a in model.trees])
            # a fresh tensor each stage: a yielded one is never mutated
            margin = margin + _predict_forest(forest, data, plan).reshape(
                margin.shape)
            yield model.loss.transform(margin)

    # -- serialization -----------------------------------------------------
    def _pack(self):
        model = self._check_fitted()
        meta = {"class": type(self).__name__,
                "params": serialize.estimator_params_to_meta(
                    self.get_params())}
        return serialize._pack_parts(model, self._binner, meta)

    @classmethod
    def _from_parts(cls, est_meta: Dict, model: GBDTModel, binner: Binner,
                    device: torch.device) -> "BoosterEstimator":
        klass = {c.__name__: c for c in (BoosterRegressor,
                                         BoosterClassifier)}.get(
            est_meta.get("class"), cls)
        est = klass(**est_meta.get("params", {}))
        est.device = device
        est._model, est._binner = model, binner
        return est

    def save(self, path: str) -> str:
        """Write this fitted estimator as an atomic npz+json bundle."""
        return serialize.save(path, self)

    @classmethod
    def load(cls, path: str, device=None) -> "BoosterEstimator":
        """Load an estimator bundle of either package (a pipeline bundle is
        promoted), its model on ``device`` (CUDA by default)."""
        obj = serialize.load(path, device=device)
        if isinstance(obj, GBDTPipeline):     # promote: same payload family
            est = cls(device=obj.device)
            est._model, est._binner = obj.model, obj.binner
            return est
        if not isinstance(obj, BoosterEstimator):
            raise TypeError(f"bundle at {path!r} holds a "
                            f"{type(obj).__name__}, not an estimator")
        return obj

    def to_pipeline(self) -> GBDTPipeline:
        """The binner+model bundle view (for the functional APIs)."""
        return GBDTPipeline(binner=self.binner_, model=self.model_)


class BoosterRegressor(BoosterEstimator):
    """Gradient-boosted regression trees (default squared-error loss)."""

    _default_objective = "reg:squarederror"


class BoosterClassifier(BoosterEstimator):
    """Gradient-boosted classifier (binary logistic or multi-class softmax).

    The objective is auto-detected from the label set when left unset:
    labels {0, 1} train ``binary:logistic``; integer labels 0..K-1 with
    K > 2 train ``multi:softmax`` with K class trees a round.  ``predict``
    returns hard class labels; ``predict_proba`` the (n, K) class
    probabilities, XGBoost-style.
    """

    _default_objective = "binary:logistic"

    def _resolve_objective(self, y: np.ndarray
                           ) -> Tuple[str, Optional[int]]:
        labels = np.unique(np.asarray(y))
        integral = bool(labels.size == 0
                        or (np.all(labels >= 0)
                            and np.all(labels == np.round(labels))))
        if not integral and self.objective in (None, "multi:softmax"):
            # auto-detection and softmax need class ids; an explicit
            # scalar objective may take soft targets
            raise ValueError(
                "classifier labels must be non-negative integers "
                f"(got values like {labels[:5]})")
        detected = (int(labels.max()) + 1 if labels.size and integral
                    else 2)
        if self.objective == "multi:softmax" or (
                self.objective is None
                and (detected > 2 or (self.n_classes or 0) > 2)):
            K = self.n_classes if self.n_classes is not None else max(
                detected, 2)
            if detected > K:
                raise ValueError(
                    f"labels reach class {detected - 1} but n_classes={K}")
            return "multi:softmax", K
        obj = self.objective or self._default_objective
        # a wider K conflicts with an explicit scalar objective: fail loudly
        # instead of training a binary model on K classes
        if self.n_classes is not None and self.n_classes > 2:
            raise ValueError(
                f"n_classes={self.n_classes} conflicts with "
                f"objective={obj!r}; use objective='multi:softmax' "
                "(or leave objective unset)")
        if detected > 2:
            raise ValueError(
                f"labels span {detected} classes but objective={obj!r} "
                "is scalar; use objective='multi:softmax' (or leave "
                "objective unset for auto-detection)")
        return obj, None

    def predict_proba(self, X, *, plan: Optional[ExecutionPlan] = None
                      ) -> np.ndarray:
        model = self._check_fitted()
        p = model.loss.transform(self.predict_margin(X, plan=plan)
                                 ).cpu().numpy()
        if model.n_classes > 1:
            return p                       # (n, K) softmax rows
        return np.stack([1.0 - p, p], axis=-1)

    def predict(self, X, *, plan: Optional[ExecutionPlan] = None
                ) -> np.ndarray:
        model = self._check_fitted()
        if model.n_classes > 1:
            return self.predict_proba(X, plan=plan).argmax(
                axis=-1).astype(np.int32)
        return (self.predict_proba(X, plan=plan)[:, 1] > 0.5).astype(
            np.int32)

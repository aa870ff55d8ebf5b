"""Data-parallel distributed GBDT training with elastic fault tolerance.

The counterpart of :mod:`repro.distributed.trainer`.  The paper's §III-B
decomposition, wired into a fit: records are partitioned across the
mesh's data axes, each shard runs the class-batched histogram kernel over
its own records, and the shards' histograms are summed once at the end of
step ① of every level — O(nodes·F·bins) bytes a level instead of the
record stream.  Step ② runs once, on the mesh's first device, on the
summed histogram; its decisions go back to the shards, so every shard
grows the same tree, and step ③ routes each shard's records on its own
device.  The final node ids are leaf slots, so step ⑤ is a leaf lookup.

One process drives the mesh (single-controller, as ``repro``): a round is
a host loop over the shards, each shard's kernels launched on its device;
there is no CUDA graph across devices.  The sums are :mod:`sharding`'s
fixed-order ones, so a fit is deterministic for a given mesh.

Determinism contract:

  * a round's random stream is keyed by ``(seed, round)`` and every
    stochastic filter (GOSS, subsample, colsample) is drawn on the global
    statistics before they are sharded, so the draws do not depend on the
    shard count and trees differ across meshes only by the histogram
    sums' association;
  * one shard adds padding rows of zero statistics (exactly +0.0 a cell),
    so on the CPU D = 1 equals the host-loop ``core.gbdt.train``;
  * for D > 1 each histogram cell is a sum of per-shard partial sums:
    exact where those sums are exactly representable (dyadic statistics),
    else within float32 rounding.

Elasticity and fault tolerance (:class:`DistributedConfig`): a worker
failure surfaces as an exception from the round; recovery re-meshes onto
the surviving devices, restores the newest ``checkpoint.save_named``
round and replays deterministically — the fit never restarts.  A changed
device list between rounds re-meshes up or down without a restore.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.api.plan import ExecutionPlan
from repro_torch.core import gbdt as gbdt_mod
from repro_torch.core import losses as losses_mod
from repro_torch.core import tree as tree_mod
from repro_torch.core.binning import BinnedDataset
from repro_torch.core.gbdt import (GBDTConfig, GBDTModel, TrainResult,
                                   _as_model, _model_rounds, model_from_meta)
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed.sharding import (ShardedRecords, shard_dataset,
                                              shard_plan)
from repro_torch.kernels.ref import TreeArrays
from repro_torch.launch.mesh import (Mesh, cuda_devices, data_axes,
                                     make_mesh, n_data_shards)
from repro_torch.resilience.errors import (NumericalDivergenceError,
                                           Preemption, TrainingInterrupted)
from repro_torch.resilience.recovery import RecoveryPolicy, classify
from repro_torch.resilience.shutdown import GracefulShutdown


@dataclasses.dataclass
class DistributedConfig:
    """Elasticity and fault-tolerance policy for :func:`train_distributed`.

    checkpoint_dir:     where ``checkpoint.save_named`` rounds land (under
                        ``rounds/``); None disables checkpointing (a
                        failure then replays the fit from its first round)
    checkpoint_every:   save cadence in completed rounds
    keep_last:          checkpoint GC horizon
    max_restarts:       failures tolerated before the exception propagates
    fault_injector:     any object with ``check(round)`` raising to
                        simulate a worker loss, checked after the round's
                        compute and before its commit
    fault_schedule:     a :class:`repro_torch.resilience.FaultSchedule`:
                        site ``"round"`` fires where ``fault_injector``
                        does, ``"elastic"`` just before the between-round
                        device poll
    available_devices:  optional ``round -> device list`` polled between
                        rounds; a changed list re-meshes the fit
    survivors:          maps the failed mesh's device list to the
                        surviving one; by default drops the last device
                        (keeps the mesh when one device remains)
    """

    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 25
    keep_last: int = 3
    max_restarts: int = 2
    fault_injector: Optional[object] = None
    fault_schedule: Optional[object] = None
    available_devices: Optional[Callable[[int], Sequence]] = None
    survivors: Optional[Callable[[Sequence], Sequence]] = None


def data_parallel_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A ``("data",)`` mesh over ``devices`` (default: every CUDA
    device)."""
    devs = list(devices) if devices is not None else cuda_devices()
    return make_mesh((len(devs),), ("data",), devices=devs)


def _check_data_parallel(mesh: Mesh) -> None:
    """The trainer shards records only; a real model axis is refused."""
    if "model" in mesh.axis_names and mesh.shape["model"] != 1:
        raise ValueError(
            "train_distributed is data-parallel: the mesh's 'model' axis "
            f"must have size 1, got {mesh.shape['model']} (use "
            "distributed_fit_tree for field sharding)")
    if not data_axes(mesh):
        raise ValueError("mesh has no data axes to shard records over")


# --------------------------------------------------------------------------
# placement + checkpoint plumbing
# --------------------------------------------------------------------------
def _round_ckpt_dir(dist: DistributedConfig) -> str:
    # under checkpoint_dir, so the estimator's bundles (same step_<k>
    # layout) never collide with the trainer's round snapshots
    return os.path.join(dist.checkpoint_dir, "rounds")


def _save_round_checkpoint(dist: DistributedConfig, model: GBDTModel,
                           margins, eval_margins, history,
                           rounds_done: int) -> None:
    arrays = {f"trees/{f}": getattr(model.trees, f).cpu().numpy()
              for f in TreeArrays._fields}
    arrays["margins"] = margins.cpu().numpy()
    arrays["train_loss"] = np.asarray(history["train_loss"], np.float32)
    if eval_margins is not None:
        arrays["eval_margins"] = eval_margins.cpu().numpy()
        arrays["eval_loss"] = np.asarray(history["eval_loss"], np.float32)
    ckpt.save_named(_round_ckpt_dir(dist), arrays, step=rounds_done,
                    keep_last=dist.keep_last,
                    extra_meta={"round": rounds_done, "model": model.meta()})


def _restore_round_checkpoint(dist: DistributedConfig, K: Optional[int],
                              device: torch.device):
    """Newest valid round -> (rounds, margins, eval_margins, history,
    rounds_done) on ``device``; None when there is none (replay from the
    fit's first round).  Reads ``repro``'s round checkpoints too."""
    if dist.checkpoint_dir is None:
        return None
    try:
        arrays, _, meta = ckpt.restore_named(_round_ckpt_dir(dist))
    except FileNotFoundError:
        return None
    trees = TreeArrays(*[torch.as_tensor(arrays[f"trees/{f}"],
                                         device=device)
                         for f in TreeArrays._fields])
    model = model_from_meta(trees, meta["model"])
    margins = torch.as_tensor(arrays["margins"], device=device)
    eval_margins = (torch.as_tensor(arrays["eval_margins"], device=device)
                    if "eval_margins" in arrays else None)
    history = {"train_loss": [float(v) for v in arrays["train_loss"]]}
    if "eval_loss" in arrays:
        history["eval_loss"] = [float(v) for v in arrays["eval_loss"]]
    return (_model_rounds(model, K), margins, eval_margins, history,
            int(meta["round"]))


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------
def train_distributed(config: GBDTConfig, data: BinnedDataset, y, *,
                      mesh: Optional[Mesh] = None,
                      dist: Optional[DistributedConfig] = None,
                      eval_set: Optional[Tuple[BinnedDataset, object]] = None,
                      init_model: Optional[GBDTModel] = None,
                      callback: Optional[Callable[[int, GBDTModel], None]]
                      = None,
                      verbose: bool = False,
                      plan: Optional[ExecutionPlan] = None,
                      recovery: Optional[RecoveryPolicy] = None,
                      shutdown: Optional[GracefulShutdown] = None
                      ) -> TrainResult:
    """Fit a GBDT ensemble data-parallel across ``mesh`` (see the module
    doc).  ``mesh`` defaults to ``plan.mesh``; one of the two must be set.
    Margins, labels, the split search and the committed trees live on the
    mesh's first device; each shard's records and statistics on its own.
    ``config.fused_rounds`` and ``early_stopping_rounds`` do not apply, as
    in ``repro``'s distributed trainer.

    ``stats`` holds the distributed evidence: ``n_shards``, ``devices``,
    ``restarts``, every re-mesh as ``(kind, round, n_shards)`` in
    ``remesh_events``, ``hist_slices`` and the recovery counters.

    ``recovery`` (a :class:`repro_torch.resilience.RecoveryPolicy`) arms
    typed recovery of a round:

      * a :class:`Preemption` re-meshes onto the survivors, restores the
        newest checkpoint and replays;
      * another transient failure retries the round on the same mesh
        after ``retry_delay_s`` (its state is uncommitted), at most
        ``max_recoveries`` times;
      * a device OOM doubles ``hist_slices`` and retries, at most
        ``max_oom_halvings`` times;
      * a :class:`NumericalDivergenceError` (the finiteness sentinel on
        loss and margins at ``log_every`` cadence) replays the round at
        the same learning rate, and backs the rate off by
        ``divergence_backoff`` when the same round diverges twice, at
        most ``max_divergence_rollbacks`` times.

    Without a policy any failure of a round re-meshes and restores, up to
    ``dist.max_restarts`` times.  ``shutdown`` (a
    :class:`repro_torch.resilience.GracefulShutdown`) commits the round in
    flight and a checkpoint, then raises :class:`TrainingInterrupted`
    carrying the partial result.
    """
    plan = ExecutionPlan.from_config(config) if plan is None else plan
    if mesh is None:
        mesh = plan.mesh
    if mesh is None:
        raise ValueError("train_distributed needs a mesh (argument or "
                         "plan.mesh)")
    _check_data_parallel(mesh)
    if plan.data_axes is not None and \
            tuple(plan.data_axes) != data_axes(mesh):
        raise ValueError(f"the trainer shards records over every data axis "
                         f"of the mesh ({data_axes(mesh)}), not "
                         f"{plan.data_axes}")
    kernel_plan = shard_plan(plan)
    dist = dist or DistributedConfig()
    if (recovery is not None and recovery.checkpoint_dir is not None
            and dist.checkpoint_dir is None):
        # one policy object drives every trainer: its checkpoint knobs map
        # onto this trainer's round checkpoints
        dist = dataclasses.replace(dist,
                                   checkpoint_dir=recovery.checkpoint_dir,
                                   checkpoint_every=recovery.checkpoint_every)
    if config.grow_policy != "depthwise":
        raise ValueError("distributed training supports only the depthwise "
                         "grow_policy")

    loss = losses_mod.get_loss(config.objective, config.n_classes)
    K = loss.n_outputs
    Kb = K or 1
    devices = list(mesh.devices.flat)
    owner = devices[0]
    data = data.to(owner)
    y = torch.as_tensor(np.asarray(y), dtype=torch.float32, device=owner)
    ev_data = ev_y = None
    if eval_set is not None:
        ev_data = eval_set[0].to(owner)
        ev_y = torch.as_tensor(np.asarray(eval_set[1]), dtype=torch.float32,
                               device=owner)
    if K is not None:
        gbdt_mod._validate_multiclass_labels(K, y, ev_y)
    n, F = data.n_records, data.n_fields
    depth = config.max_depth
    predict_round = (gbdt_mod._predict_forest if K is not None
                     else gbdt_mod._predict_one_tree)

    # -- initial state, as core.gbdt.train's ---------------------------------
    trees: List[TreeArrays] = []
    eval_margins = None
    if init_model is not None:
        init_model = gbdt_mod._warm_model(init_model, config, K, depth, owner)
        trees = _model_rounds(init_model, K)
        base_margin = init_model.base_margin
        # a matching round checkpoint carries the exact live margins, so a
        # resume continues from them; otherwise replay round by round
        margins = None
        snap = _restore_round_checkpoint(dist, K, owner)
        if snap is not None and snap[4] == init_model.n_rounds and all(
                torch.equal(u, v) for a, b in zip(snap[0], trees)
                for u, v in zip(a, b)):
            margins, eval_margins = snap[1], snap[2]
        if margins is None:
            margins = gbdt_mod._replay_margins(init_model, data, kernel_plan)
        if eval_set is not None and eval_margins is None:
            eval_margins = gbdt_mod._replay_margins(init_model, ev_data,
                                                    kernel_plan)
        if eval_set is None:
            eval_margins = None
    else:
        base_margin = (loss.base_margin(y).cpu().numpy().astype(np.float32)
                       if K is not None else float(loss.base_margin(y)))
        base = gbdt_mod.base_margin_tensor(base_margin, owner)
        margins = base.expand((n,) + base.shape).clone()
        if eval_set is not None:
            eval_margins = base.expand((ev_y.shape[0],)
                                       + base.shape).clone()
    init_margins, init_eval_margins = margins, eval_margins

    history: Dict[str, List[float]] = {"train_loss": []}
    if eval_set is not None:
        history["eval_loss"] = []
    step_times = {"rounds": 0.0}
    start = len(trees)
    end = start + config.n_trees
    round_config = config
    events: List[Tuple[str, int, int]] = []
    restarts = 0
    hist_slices = 1                    # OOM degradation state (doubles)
    diverged_at = -1                   # round of the last sentinel trip
    rstats = {"recoveries": 0, "oom_halvings": 0, "replayed_rounds": 0,
              "divergence_rollbacks": 0}
    placed = None
    is_cat = None

    def model() -> GBDTModel:
        return _as_model(trees, base_margin, config, data.missing_bin, F)

    def mkstats(**extra) -> Dict:
        return {"n_rows": n, "distributed": True,
                "n_shards": n_data_shards(mesh),
                "devices": [str(d) for d in devices], "restarts": restarts,
                "remesh_events": list(events), "hist_slices": hist_slices,
                **rstats, **extra}

    def place(new_mesh: Mesh) -> None:
        """Re-place the training state on ``new_mesh``; the state is
        mesh-agnostic, so this is a relayout, not a restore."""
        nonlocal mesh, devices, owner, placed, is_cat, data, y, margins
        nonlocal eval_margins, ev_data, ev_y, trees, init_margins
        nonlocal init_eval_margins
        mesh = new_mesh
        devices = list(mesh.devices.flat)
        owner = devices[0]
        moved = [data, y, margins, ev_data, ev_y, eval_margins,
                 init_margins, init_eval_margins]
        (data, y, margins, ev_data, ev_y, eval_margins, init_margins,
         init_eval_margins) = [None if x is None else x.to(owner)
                               for x in moved]
        trees = [TreeArrays(*[a.to(owner) for a in t]) for t in trees]
        # pad rows replicate the last record and get zero statistics; a
        # packed column-major copy ships as bytes where every shard's
        # record count is even
        placed = shard_dataset(data, mesh)
        is_cat = data.is_categorical

    place(mesh)
    t_loop = time.perf_counter()
    t_idx = start
    while t_idx < end:
        try:
            # elastic grow/shrink between rounds
            if dist.fault_schedule is not None:
                dist.fault_schedule.apply("elastic", t_idx)
            if dist.available_devices is not None:
                want = [torch.device(d)
                        for d in dist.available_devices(t_idx)]
                if [str(d) for d in want] != [str(d) for d in devices]:
                    kind = "grow" if len(want) > len(devices) else "shrink"
                    place(data_parallel_mesh(want))
                    events.append((kind, t_idx, n_data_shards(mesh)))
                    if verbose:
                        print(f"[dist] {kind} -> {n_data_shards(mesh)} "
                              f"shards at round {t_idx}")
            g, h = loss.grad_hess(margins, y)
            g, h, field_mask = gbdt_mod._round_stats(
                round_config, gbdt_mod._round_generator(config, t_idx,
                                                        owner),
                g, h, n, F, K)
            records = ShardedRecords(
                placed, *[x.T if K is not None else x[None] for x in (g, h)],
                plan=kernel_plan, hist_slices=hist_slices)
            forest = tree_mod.grow_levels(
                records, depth=depth, is_cat_field=is_cat,
                field_mask=field_mask, lambda_=config.lambda_,
                gamma=config.gamma, min_child_weight=config.min_child_weight)
            leaf_ids = records.node_ids
            forest = forest._replace(
                leaf_value=forest.leaf_value * round_config.learning_rate)
            # step ⑤ without a pass: the final node ids are leaf slots
            delta = torch.cat([
                torch.gather(forest.leaf_value.to(ids.device), 1,
                             ids.long()).to(owner) for ids in leaf_ids],
                dim=1)[:, :n]
            new_margins = margins + (delta.T if K is not None else delta[0])
            tree = forest if K is not None else TreeArrays(
                *[a[0] for a in forest])
            tl = torch.mean(loss.value(new_margins, y))
            new_eval = ev = None
            if eval_set is not None:
                new_eval = predict_round(tree, ev_data, kernel_plan,
                                         eval_margins.clone())
                ev = torch.mean(loss.value(new_eval, ev_y))
            if dist.fault_injector is not None:
                dist.fault_injector.check(t_idx)   # a worker dies mid-round
            if dist.fault_schedule is not None:
                dist.fault_schedule.apply("round", t_idx)
            if (recovery is not None
                    and (t_idx % config.log_every == 0 or t_idx == end - 1)
                    and not bool(torch.isfinite(torch.maximum(
                        new_margins.abs().max(), tl.abs())))):
                raise NumericalDivergenceError(
                    f"non-finite loss/margins at round {t_idx}",
                    round_index=t_idx, what="loss/margins")
        except Exception as e:  # noqa: BLE001 — classified below
            action = classify(e) if recovery is not None else "remesh"
            if action == "transient" and isinstance(e, Preemption):
                action = "remesh"      # preemptions re-mesh; others retry
            if action == "divergence":
                if (rstats["divergence_rollbacks"]
                        >= recovery.max_divergence_rollbacks):
                    raise
                rstats["divergence_rollbacks"] += 1
                obs.record("recoveries")
                if diverged_at == t_idx:
                    # the same round diverged on its replay: shrink steps
                    round_config = dataclasses.replace(
                        round_config,
                        learning_rate=(round_config.learning_rate
                                       * recovery.divergence_backoff))
                    if verbose:
                        print(f"[dist] round {t_idx} diverged twice; "
                              f"learning_rate -> "
                              f"{round_config.learning_rate:g}")
                elif verbose:
                    print(f"[dist] divergence at round {t_idx}; replaying "
                          "from the last finite round")
                diverged_at = t_idx
                continue   # the round is uncommitted: replay = rollback
            if action == "oom":
                if rstats["oom_halvings"] >= recovery.max_oom_halvings:
                    raise
                rstats["oom_halvings"] += 1
                obs.record("recoveries")
                hist_slices *= 2
                if owner.type == "cuda":
                    torch.cuda.empty_cache()
                if verbose:
                    print(f"[dist] device OOM at round {t_idx}: "
                          f"hist_slices -> {hist_slices}; retrying round")
                continue
            if action == "transient":
                if rstats["recoveries"] >= recovery.max_recoveries:
                    raise
                rstats["recoveries"] += 1
                obs.record("recoveries")
                if recovery.retry_delay_s:
                    time.sleep(recovery.retry_delay_s)
                if verbose:
                    print(f"[dist] transient failure at round {t_idx} "
                          f"({type(e).__name__}: {e}); retrying on the "
                          "same mesh")
                continue
            if action == "fatal":
                raise
            # a preemption (or any failure without a policy): re-mesh onto
            # the survivors, restore the newest checkpoint, replay
            restarts += 1
            if restarts > dist.max_restarts:
                raise
            if recovery is not None:
                obs.record("recoveries")
            surv = (dist.survivors(devices) if dist.survivors is not None
                    else (devices[:-1] if len(devices) > 1 else devices))
            place(data_parallel_mesh([torch.device(d) for d in surv]))
            events.append(("shrink", t_idx, n_data_shards(mesh)))
            if verbose:
                print(f"[dist] fault at round {t_idx} ({e}); resuming on "
                      f"{n_data_shards(mesh)} shards")
            t_before = t_idx
            restored = _restore_round_checkpoint(dist, K, owner)
            if restored is None:       # no checkpoint yet: replay the fit
                trees = trees[:start]
                margins, eval_margins = init_margins, init_eval_margins
                history = {k: [] for k in history}
                t_idx = start
            else:
                trees, margins, eval_margins, history, t_idx = restored
            rstats["replayed_rounds"] += max(0, t_before - t_idx)
            continue

        # -- commit the round -------------------------------------------------
        margins, eval_margins = new_margins, new_eval
        trees.append(tree)
        history["train_loss"].append(float(tl))
        if eval_set is not None:
            history["eval_loss"].append(float(ev))
        rounds_done = t_idx + 1
        if (dist.checkpoint_dir is not None
                and rounds_done % dist.checkpoint_every == 0):
            _save_round_checkpoint(dist, model(), margins, eval_margins,
                                   history, rounds_done)
        if verbose and (t_idx % config.log_every == 0 or t_idx == end - 1):
            print(f"[dist] round {t_idx:4d}  "
                  f"train_loss={history['train_loss'][-1]:.6f}  "
                  f"shards={n_data_shards(mesh)}")
        if callback is not None:
            callback(t_idx, model())
        if shutdown is not None and shutdown.requested:
            # the round in flight is committed: persist the resumable
            # state, then exit with a typed status
            if (dist.checkpoint_dir is not None
                    and rounds_done % dist.checkpoint_every):
                _save_round_checkpoint(dist, model(), margins, eval_margins,
                                       history, rounds_done)
            step_times["rounds"] = time.perf_counter() - t_loop
            partial = TrainResult(model=model(), history=history,
                                  step_times=step_times,
                                  stats=mkstats(interrupted=True),
                                  margins=margins)
            raise TrainingInterrupted(
                f"shutdown ({shutdown.signal_name}) after round {t_idx}",
                rounds_done=len(trees), signal_name=shutdown.signal_name,
                checkpoint_dir=dist.checkpoint_dir, result=partial)
        t_idx += 1

    step_times["rounds"] = time.perf_counter() - t_loop
    return TrainResult(model=model(), history=history, step_times=step_times,
                       stats=mkstats(), margins=margins)

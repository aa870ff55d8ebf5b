"""Training launcher: the counterpart of :mod:`repro.launch.train`.

    python -m repro_torch.launch.train --records 1000000 --trees 100 \\
        --ckpt-dir build/train_ckpt [--device cpu] [--data-shards N] \\
        [--stream] [--resume]

``--mode gbdt`` (the default) fits the paper's workload, a
``paper_dataset`` analog, through the estimator on ``--device`` (CUDA
unless named), with atomic checkpoints every ``--ckpt-every`` rounds and
a step journal.  ``--data-shards N`` shards the records over an N-way
``("data",)`` mesh of the visible CUDA devices (more shards than devices
is refused), or of N CPU shards with ``--device cpu``, and fits through
the data-parallel trainer.  ``--stream`` stages the set as checksummed npz
shards and trains out-of-core from them through a ``RetryingSource``.
SIGTERM or SIGINT finish the round in flight, commit a checkpoint and
exit with code 75 (EX_TEMPFAIL); ``--resume`` then grows the remaining
trees, the same ensemble as an uninterrupted run.  The last line of a
run's output is its loss history as JSON.  ``--mode lm`` is LM training,
which is not ported (ROADMAP Queue 1 item 10b).
"""
from __future__ import annotations

import argparse
import json
import os

import torch

EX_TEMPFAIL = 75


def _mesh(args):
    """The ``--data-shards`` mesh, or None for one device."""
    from repro_torch.launch.mesh import cuda_devices, make_mesh

    if args.data_shards <= 1:
        return None
    if args.stream:
        raise SystemExit("--stream (out-of-core) and --data-shards "
                         "(in-memory distributed) cannot combine")
    if torch.device(args.device).type == "cpu":
        devices = ["cpu"] * args.data_shards
    else:
        devices = cuda_devices()
        if args.data_shards > len(devices):
            raise SystemExit(
                f"--data-shards {args.data_shards} exceeds the "
                f"{len(devices)} visible CUDA devices")
    return make_mesh((args.data_shards,), ("data",), devices=devices)


def run_gbdt(args) -> None:
    from repro_torch.api import (BoosterClassifier, BoosterRegressor,
                                 ExecutionPlan, GracefulShutdown,
                                 RecoveryPolicy, TrainingInterrupted,
                                 paper_dataset, serialize)
    from repro_torch.distributed.fault import StepJournal

    if args.resume and not serialize.has_checkpoint(args.ckpt_dir):
        raise SystemExit(f"--resume: no checkpoint found under "
                         f"{args.ckpt_dir!r}; nothing to resume from")
    mesh = _mesh(args)
    X, y, cats, spec = paper_dataset(args.dataset, n_override=args.records,
                                     seed=args.seed)
    klass = BoosterClassifier if spec.task == "binary" else BoosterRegressor
    est = klass(n_trees=args.trees, max_depth=args.depth,
                learning_rate=args.lr, max_bins=args.max_bins,
                categorical_fields=cats, seed=args.seed, device=args.device)
    journal = StepJournal(os.path.join(args.ckpt_dir, "journal.jsonl"))

    def cb(t_idx, model):
        if (t_idx + 1) % args.ckpt_every == 0:
            journal.append(t_idx, {})

    plan = ExecutionPlan(hist_strategy=args.strategy)
    recovery = RecoveryPolicy(checkpoint_dir=args.ckpt_dir,
                              checkpoint_every=args.ckpt_every)
    source = None
    fit = dict(plan=plan, checkpoint_dir=args.ckpt_dir,
               checkpoint_every=args.ckpt_every, callback=cb, verbose=True,
               recovery=recovery)
    try:
        with GracefulShutdown() as sd:
            if args.stream:
                from repro_torch.api import (ArraySource, NpzShardSource,
                                             RetryingSource, RetryPolicy,
                                             write_npz_shards)
                shard_dir = os.path.join(args.ckpt_dir, "shards")
                if not os.path.isdir(shard_dir):
                    write_npz_shards(shard_dir, ArraySource(X, y),
                                     rows_per_shard=max(1024,
                                                        args.records // 8))
                source = RetryingSource(NpzShardSource(shard_dir),
                                        RetryPolicy(chunk_timeout_s=60.0))
                est.fit(data=source, shutdown=sd, **fit)
            else:
                est.fit(X, y, mesh=mesh, shutdown=sd, **fit)
    except TrainingInterrupted as stop:
        print(f"[train] interrupted ({stop.signal_name}) after "
              f"{stop.rounds_done} committed rounds; checkpoint in "
              f"{stop.checkpoint_dir or args.ckpt_dir}; rerun with "
              f"--resume to finish the remaining trees")
        history = stop.result.history if stop.result is not None else {}
        print(f"[train] history {json.dumps(history)}", flush=True)
        raise SystemExit(EX_TEMPFAIL)
    loss = est.history_.get("train_loss") or [float("nan")]
    st = est.stats_
    print(f"[train] done: {est.n_trees_} trees, loss {loss[-1]:.6f}, "
          f"shards {st.get('n_shards', 1)} on "
          f"{st.get('devices', [args.device])}")
    if args.stream:
        print(f"[train] resilience: {st.get('recoveries', 0)} recoveries, "
              f"{st.get('oom_halvings', 0)} OOM halvings, "
              f"{source.stats['retries']} source retries "
              f"(chunk_rows {st.get('chunk_rows')})")
    print(f"[train] history {json.dumps(est.history_)}", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", default="gbdt", choices=["gbdt", "lm"])
    ap.add_argument("--dataset", default="higgs")
    ap.add_argument("--device", default="cuda",
                    help="where the fit runs (CUDA unless named)")
    ap.add_argument("--records", type=int, default=20_000)
    ap.add_argument("--trees", type=int, default=100,
                    help="boosting rounds")
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--max-bins", type=int, default=128)
    ap.add_argument("--strategy", default="auto",
                    help="step-① histogram strategy of the plan")
    ap.add_argument("--data-shards", type=int, default=1,
                    help="data-parallel shards (1 = one device)")
    ap.add_argument("--stream", action="store_true",
                    help="out-of-core: stage checksummed npz shards, stream "
                         "them through a RetryingSource, recover rounds "
                         "from checkpoints")
    ap.add_argument("--ckpt-dir", default="build/repro_torch_train_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true",
                    help="finish an interrupted fit from the newest "
                         "checkpoint under --ckpt-dir (fails if none)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.mode == "lm":
        raise NotImplementedError(
            "--mode lm needs LM training, which is not ported "
            "(ROADMAP Queue 1 item 10b)")
    run_gbdt(args)


if __name__ == "__main__":
    main()

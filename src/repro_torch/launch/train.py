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
run's output is its loss history as JSON.

``--mode lm --arch <id>`` trains the architecture's smoke config of the
LM substrate (:mod:`repro_torch.models.lm`) from random weights (seed
``--seed``) on ``--device``: ``--trees`` AdamW steps
(``lm.make_train_step``, the config's LR schedule, warmup 20) on batches
of 8 x 32 tokens from ``data.pipeline.token_batches``, printing
``[lm] step i loss x`` every 20 steps.  As ``repro``'s driver, it trains
at ``--lr`` (0.1 unless given).

    python -m repro_torch.launch.train --mode lm --arch qwen3-14b \
        --trees 100 [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

EX_TEMPFAIL = 75
LM_BATCH, LM_SEQ = 8, 32


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


def lm_train_batch(cfg, arrays: dict, device) -> dict:
    """``token_batches``' numpy tokens and labels on ``device`` (int64),
    with the frontends' stub inputs where the family has them, as
    ``repro``'s driver feeds them: M-RoPE positions (3, B, S), four zero
    patch embeddings (B, 4, d) for a VLM, zero audio frames (B,
    frontend_len, d) for an encoder-decoder."""
    batch = {k: torch.from_numpy(v).to(device).long()
             for k, v in arrays.items()}
    b, s = batch["tokens"].shape
    if cfg.mrope:
        batch["positions"] = torch.arange(s, device=device)[
            None, None].expand(3, b, s)
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.zeros((b, 4, cfg.d_model),
                                            device=device)
    if cfg.family == "encdec":
        batch["audio_embeds"] = torch.zeros(
            (b, cfg.frontend_len, cfg.d_model), device=device)
    return batch


def run_lm(args) -> None:
    from repro_torch.api.plan import resolve_device
    from repro_torch.configs import get_smoke
    from repro_torch.data.pipeline import token_batches
    from repro_torch.models import lm, optim

    cfg = get_smoke(args.arch)
    dev = resolve_device(args.device)
    model = lm.init_params(cfg, torch.Generator().manual_seed(args.seed),
                           dev)
    opt = optim.adamw_init(model)
    base_lr = args.lr or 3e-3
    step = lm.make_train_step(cfg, base_lr=base_lr, warmup=20,
                              total_steps=args.trees)
    print(f"[lm] {cfg.name}: {lm.param_count(cfg):,} params on {dev}, "
          f"batches {LM_BATCH}x{LM_SEQ}, {args.trees} steps, "
          f"{cfg.lr_schedule} schedule at base lr {base_lr}")
    stream = token_batches(np.random.default_rng(args.seed), cfg.vocab,
                           LM_BATCH, LM_SEQ, args.trees)
    metrics = None
    for i, arrays in enumerate(stream):
        batch = lm_train_batch(cfg, arrays, dev)
        model, opt, metrics = step(model, opt, batch)
        if i % 20 == 0:
            print(f"[lm] step {i} loss {float(metrics['loss']):.4f}",
                  flush=True)
    if metrics is not None:
        print(f"[lm] done: {args.trees} steps on {dev}, loss "
              f"{float(metrics['loss']):.4f}, gnorm "
              f"{float(metrics['gnorm']):.4f}", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", default="gbdt", choices=["gbdt", "lm"])
    ap.add_argument("--dataset", default="higgs")
    ap.add_argument("--arch", default="qwen3-14b",
                    help="--mode lm: the architecture whose smoke config "
                         "trains")
    ap.add_argument("--device", default="cuda",
                    help="where the fit runs (CUDA unless named)")
    ap.add_argument("--records", type=int, default=20_000)
    ap.add_argument("--trees", type=int, default=100,
                    help="boosting rounds (gbdt) or steps (lm)")
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--lr", type=float, default=0.1,
                    help="learning rate (gbdt), or AdamW's base rate (lm: "
                         "the default 0.1 trains at 0.1, as repro's driver "
                         "does; 0 means 3e-3)")
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
        run_lm(args)
    else:
        run_gbdt(args)


if __name__ == "__main__":
    main()

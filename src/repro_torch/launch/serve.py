"""Serving driver: the counterpart of :mod:`repro.launch.serve`.

    python -m repro_torch.launch.serve --mode gbdt --batch 4096 \\
        --model-dir build/serve_bundles [--device cpu]

``--mode gbdt`` (the default) is a thin driver over the port's serving
daemon (:mod:`repro_torch.serving`): it publishes ``--models`` demo
tenants into a :class:`ModelRegistry` (training and saving small demo
models under ``--model-dir`` where none exist), warms every power-of-two
flush bucket the request mix can reach, then drives a mixed multi-model
load of ragged request sizes through :meth:`Server.submit`, republishing
tenant 0 at a new version half way through.  A warm server must show zero
predict-cache captures after warm-up and zero silent drops across the
swap; the driver prints both verdicts (``OK`` or not).

``--mode lm --arch <id>`` serves the architecture's smoke config of the LM
substrate (:mod:`repro_torch.models.lm`) from random weights (seed 0):
one prefill of ``--batch`` random prompts of ``--prompt-len`` tokens
(:func:`lm_batch`), then ``--gen - 1`` single-token decode steps against
the (ring-buffered where a sliding window bounds them) KV/SSM caches,
greedy or, with ``--no-greedy``, sampled at ``--temperature`` from an
explicit generator on the device, seeded with ``--seed``.

    python -m repro_torch.launch.serve --mode lm --arch mixtral-8x22b \
        --batch 4 --prompt-len 32 --gen 32 [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np


def request_sizes(batch: int):
    """The ragged request-size mix: one definition for the measured loop
    and the warm-up coverage check."""
    return [max(1, batch), max(1, batch // 2), max(1, (3 * batch) // 4),
            max(1, batch // 3)]


def _demo_bundle(path: str, device: str, task: str, seed: int,
                 learning_rate: float = 0.2) -> str:
    """Train and save a small demo tenant at ``path`` unless one exists."""
    from repro_torch.api import (BoosterClassifier, BoosterRegressor,
                                 make_tabular)

    if os.path.isdir(path):
        return path
    print(f"[serve] no bundle at {path}; training demo model ({task})")
    X, y, cats = make_tabular(20_000, 20, 8, n_cats=12, task=task,
                              seed=seed)
    cls = BoosterClassifier if task == "binary" else BoosterRegressor
    est = cls(n_trees=100, max_depth=6, learning_rate=learning_rate,
              max_bins=64, categorical_fields=cats, seed=seed, device=device)
    est.fit(X, y)
    est.save(path)
    return path


def run_gbdt(args) -> bool:
    """Drive the daemon; returns whether both verdicts hold."""
    from repro_torch.api import (ExecutionPlan, ModelRegistry, Server, load,
                                 warmup_buckets)
    from repro_torch.core.inference import ROW_BUCKET_FLOOR, bucket_pow2
    from repro_torch.serving import (DeadlineExceededError,
                                     DispatcherCrashError, QueueFullError)

    plan = ExecutionPlan()
    registry = ModelRegistry(plan, device=args.device)
    tasks = ["binary", "regression"]
    names = []
    for i in range(max(1, args.models)):
        task = tasks[i % len(tasks)]
        name = f"m{i}_{task}"
        path = _demo_bundle(os.path.join(args.model_dir, name), args.device,
                            task, seed=i)
        registry.publish(name, path)
        est = load(path, device=args.device)
        print(f"[serve] published {name} v1: {type(est).__name__} with "
              f"{est.n_trees_} trees")
        names.append(name)
    n_fields = registry.pipeline(names[0]).model.n_fields
    print(f"[serve] {plan.describe()} on {args.device}")

    sizes = request_sizes(args.batch)
    mb = args.microbatch or max(sizes)
    bounded = (args.max_queue_rows is not None
               or args.timeout_ms is not None)
    server = Server(registry, max_batch=mb, default_slack_ms=args.slack_ms,
                    log_every_s=args.log_every_s,
                    max_queue_rows=args.max_queue_rows,
                    timeout_ms=args.timeout_ms)
    try:
        # every flush holds <= max_batch rows, so the warm-up buckets cover
        # what the measured mix can reach: checked from the same helpers
        reachable = {bucket_pow2(min(s, mb) if lo + mb >= s else mb,
                                 ROW_BUCKET_FLOOR)
                     for s in sizes for lo in range(0, s, mb)}
        if not reachable <= set(warmup_buckets(mb)):
            raise RuntimeError(f"warm-up misses buckets {reachable} of "
                               f"max_batch {mb}")
        for name in names:
            traces = server.warmup(name)
            print(f"[serve] warmed {name}: buckets {warmup_buckets(mb)} "
                  f"({traces} traces)")
        warm_traces = {name: server.stats()[name]["traces"]
                       for name in names}

        # the mixed multi-model loop with a hot swap half way: a new
        # version of tenant 0 (same tree count, so the same buckets) lands
        # while requests are in flight
        rng = np.random.default_rng(0)
        swap_at = args.requests // 2
        pending = []
        t_loop = time.perf_counter()
        for i in range(args.requests):
            if i == swap_at:
                v2 = _demo_bundle(os.path.join(args.model_dir,
                                               names[0] + "_v2"),
                                  args.device, tasks[0], seed=100,
                                  learning_rate=0.15)
                version = registry.publish(names[0], v2)
                print(f"[serve] hot-swapped {names[0]} -> v{version} "
                      "mid-run")
            n_rows = sizes[i % len(sizes)]
            Xb = rng.normal(size=(n_rows, n_fields))
            Xb[rng.random(Xb.shape) < 0.02] = np.nan     # missing values
            pending.append(server.submit(names[i % len(names)], Xb))
        # zero silent drops: every request resolves, with rows or with one
        # of the typed overload or crash failures
        served = total = 0
        typed = {"shed": 0, "deadline": 0, "crash": 0}
        for req in pending:
            try:
                req.result(timeout=600)
                served += 1
                total += req.n_rows
            except QueueFullError:
                typed["shed"] += 1
            except DeadlineExceededError:
                typed["deadline"] += 1
            except DispatcherCrashError:
                typed["crash"] += 1
        wall = time.perf_counter() - t_loop
        stats = server.stats()
        health = server.health()
    finally:
        server.stop()
    print(f"[serve] sustained: {total / wall:.0f} records/s over "
          f"{args.requests} requests, {len(names)} models "
          f"(max_batch {mb}, slack {args.slack_ms} ms)")
    no_retrace = True
    for name in names:
        s = stats[name]
        print(f"[serve]   {name} v{s['version']}: {s['requests']} req, "
              f"p50 {s['p50_ms']:.3f} ms, p99 {s['p99_ms']:.3f} ms, "
              f"fill {s['batch_fill']:.2f}, dropped {s['dropped']}, "
              f"shed {s['shed']}, expired {s['deadline_failures']}, "
              f"retraces after warmup {s['traces'] - warm_traces[name]}")
        no_retrace &= s["traces"] == warm_traces[name]
        if not bounded:
            no_retrace &= s["dropped"] == 0
    accounted = served + sum(typed.values())
    no_drop = accounted == len(pending)
    print(f"[serve] health: alive={health.alive} ready={health.ready} "
          f"restarts={health.dispatcher_restarts} "
          f"typed_failures={health.failed_requests}")
    print(f"[serve] accounting: {served} served + {typed['shed']} shed + "
          f"{typed['deadline']} expired + {typed['crash']} crash-failed "
          f"= {accounted}/{len(pending)} (zero silent drops: "
          f"{'OK' if no_drop else 'VIOLATED'})")
    print(f"[serve] zero retraces across hot-swap: "
          f"{'OK' if no_retrace and no_drop else 'UNEXPECTED'}")
    return no_retrace and no_drop


def lm_batch(cfg, batch: int, prompt_len: int, seed: int, device) -> dict:
    """Random prompts for ``cfg`` on ``device``, drawn from numpy's
    generator at ``seed``: tokens (B, S) int64 below ``cfg.vocab``, with
    the frontends' stub inputs where the family has them: M-RoPE
    positions (3, B, S), four patch embeddings (B, 4, d) for a VLM, the
    audio frames (B, frontend_len, d) for an encoder-decoder."""
    import torch

    rng = np.random.default_rng(seed)
    B, S = batch, prompt_len
    out = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))}
    if cfg.mrope:
        out["positions"] = torch.arange(S)[None, None].expand(3, B, S)
    if cfg.family == "vlm":
        out["patch_embeds"] = torch.from_numpy(
            rng.normal(size=(B, 4, cfg.d_model)).astype(np.float32))
    if cfg.family == "encdec":
        out["audio_embeds"] = torch.from_numpy(rng.normal(
            size=(B, cfg.frontend_len, cfg.d_model)).astype(np.float32))
    return {k: v.to(device) for k, v in out.items()}


def run_lm(args) -> None:
    """Prefill, then ``--gen - 1`` decode steps; prints the prefill and
    decode lines of ``repro``'s driver."""
    import torch

    from repro_torch.api.plan import resolve_device
    from repro_torch.configs import get_smoke
    from repro_torch.models import lm

    dev = resolve_device(args.device)
    cfg = get_smoke(args.arch)
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    B, S = args.batch, args.prompt_len
    batch = lm_batch(cfg, B, S, 0, dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    logits, cache = lm.prefill(cfg, params, batch, max_len=S + args.gen,
                               cache_dtype=torch.float32)
    sync()
    t_prefill = time.perf_counter() - t0
    print(f"[serve] prefill {B}x{S}: {t_prefill*1e3:.1f} ms "
          f"({B*S/t_prefill:.0f} tok/s)")

    gen = torch.Generator(dev).manual_seed(args.seed)

    def pick(logits):
        """Greedy argmax, or temperature sampling with --no-greedy."""
        if args.greedy:
            return logits.argmax(-1)[:, None]
        probs = torch.softmax(logits / max(args.temperature, 1e-6), -1)
        return torch.multinomial(probs, 1, generator=gen)

    tok = pick(logits)
    out_tokens = [tok]
    t0 = time.perf_counter()
    for i in range(args.gen - 1):
        logits, cache = lm.decode_step(cfg, params, cache, tok, S + i)
        tok = pick(logits)
        out_tokens.append(tok)
    sync()
    t_dec = time.perf_counter() - t0
    generated = torch.cat(out_tokens, dim=1).cpu().numpy()
    mode = ("greedy" if args.greedy
            else f"sampled@T={args.temperature:g}")
    print(f"[serve] decoded {args.gen - 1} steps x {B} seqs ({mode}): "
          f"{t_dec*1e3:.1f} ms ({B*(args.gen-1)/max(t_dec, 1e-9):.0f} "
          f"tok/s) on {args.device}")
    print(f"[serve] first sequence: {generated[0][:16].tolist()} ...")


def main(argv=None) -> None:
    from repro_torch.configs import ARCH_IDS

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", default="gbdt", choices=["gbdt", "lm"])
    ap.add_argument("--device", default="cuda",
                    help="where the models serve (CUDA unless named)")
    ap.add_argument("--model-dir", default="build/repro_torch_serve_bundle")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--microbatch", type=int, default=0,
                    help="flush capacity in rows (0 = the largest request)")
    ap.add_argument("--models", type=int, default=2,
                    help="demo tenants published into the registry")
    ap.add_argument("--max-queue-rows", type=int, default=None,
                    help="per-model queue bound; overload is shed with "
                         "typed QueueFullError futures (default unbounded)")
    ap.add_argument("--timeout-ms", type=float, default=None,
                    help="hard queue deadline; expired requests fail with "
                         "DeadlineExceededError (default none)")
    ap.add_argument("--slack-ms", type=float, default=20.0,
                    help="per-request deadline slack (queue-wait budget)")
    ap.add_argument("--log-every-s", type=float, default=None,
                    help="daemon stats log-line cadence (default: silent)")
    ap.add_argument("--batch", type=int, default=None,
                    help="records of the largest request (gbdt, default "
                         "4096) or sequences (lm, default 4)")
    # lm serving
    ap.add_argument("--arch", default="qwen3-14b", choices=ARCH_IDS)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--greedy", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="argmax decoding; --no-greedy samples at "
                         "--temperature")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0,
                    help="the sampling generator's seed")
    args = ap.parse_args(argv)
    if args.batch is None:
        args.batch = 4096 if args.mode == "gbdt" else 4
    if args.mode == "lm":
        run_lm(args)
    elif not run_gbdt(args):
        raise SystemExit(1)


if __name__ == "__main__":
    main()

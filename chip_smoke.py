"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--records N] [--trees T] [--seed S]

(defaults: N = 10,000,000, T = 8, S = 1)

Phases, each of which fails the script (non-zero exit) if it fails:

1. Environment: the card's name and power limit (``nvidia-smi``), the
   torch, CUDA and nvcc versions, then the build of every kernel from
   ``src/repro_torch/csrc`` (one ``nvcc`` per source, all at once).
2. Kernel parity at the main path's shapes (n = N records, 28 fields, 256
   bins): every kernel's wrapper against its plain PyTorch version on the
   same inputs, with its time (CUDA events, median of 5 after a warm-up),
   the plain version's time, the least time the card could take and,
   where one PyTorch call computes the same function, that call's time.
   The partition and traversal rows give the kernel's own device time
   (``torch.profiler``) as ``ms`` and the wrapper's as ``wrapper_ms``; the
   partition rows add the bound that reads the 32-byte sectors of the
   split columns that the node ids touch.  Step ⑤ (the traversal rows) is
   the ensemble kernel at T = K, also added into margins.
   The ensemble (here and in 2b) is held bit-equal on dyadic leaves, then
   on real leaves against a float64 sum of the plain version's leaf
   choices within rtol 1e-5 of each record's sum of |leaf| (its largest
   error printed beside the float32 plain version's); its row names the
   launch's geometry (R records a block, U a thread, TB trees a staged
   block).  The ensemble's wide entry (code rows read from global memory,
   one field past the staged limit, 20,000 records) gets a row of its own,
   with 0 launches: no path is that wide.
2b. Class-batched parity at the multi-class path's shapes (581,012
   records, 54 fields, 256 bins, K = 7 classes, 32 nodes a class; the
   ensemble at T = 504 trees = 72 rounds x 7 classes): the histogram,
   partition, traversal and ensemble kernels with their class axis against
   their plain versions on random codes, timed as in phase 2.
3. The main path: a Higgs-shaped dataset (``paper_dataset("higgs")``, N
   training records plus N/10 held out), ``Binner(256)`` fit and transform
   to the card, ``train`` of 8 depth-6 ``binary:logistic`` trees and
   ``predict_margin``.  Launch counts are zeroed just before and read just
   after; every kernel must have run, the train loss must fall every
   round, held-out accuracy must beat the majority class and prediction
   must replay the fit's margins.
3b. The multi-class path: a Covertype-shaped dataset (UCI Covertype's
   581,012 training records plus 58,101 held out, 10 numeric fields and 44
   two-category fields, 7 classes; ``make_tabular`` with a data seed S),
   ``Binner(256, categorical_fields=...)``, ``train`` of 8 rounds of
   depth-6 ``multi:softmax`` (7 trees a round), then ``predict_margin`` and
   ``predict``.  Launch counts are zeroed just before and read just after:
   the class-batched histogram and partition once per level per round,
   the traversal once per round, the ensemble at least once; the train
   loss must fall every round, held-out argmax accuracy must beat the
   majority class, ``predict_margin`` must replay the fit's (n, 7) margins
   and ``predict``'s rows must sum to 1.  Then the class-batched
   histogram's dyadic parity and timing of phase 2b on this path's own
   codes, which give its kernel row (the random-code times stay as extra
   keys), and on real g, h its agreement with a float64 sum of the plain
   version, within rtol 1e-5 of each bin's sum of |stat|, at NN = 1 and
   32.  Then the naive-packing histogram on the same codes, held as in
   phase 2c (real stats against the float64 sum) and timed against the
   grouped kernel: the ``histogram_naive`` row's ``*_k7`` keys.
2c. 4-bit packed codes: the nibble histogram against its plain version
   and against the uint8 kernel on the same codes, at the IoT-shaped
   path's shape (2,000,000 records, 115 fields, 16 bins; NN = 1 and 32)
   and at K = 7 (581,012 records, 54 fields, 224 slots); the nibble
   column-major partition at an odd record count, K = 1 and 7; step ⑤ on
   packed rows (the traversal's nibble entry, the IoT shape); the
   naive-packing histogram (the Fig. 9 ablation twin) against its plain
   version and the grouped kernel at the Higgs shape (NN = 1 and 32),
   timed in turns with the grouped kernel; their ratio is printed at each
   shape.
2d. Step ②'s split-search kernel at the deepest level of the two main
   paths (Higgs: 32 nodes x 28 fields x 256 bins; Covertype: 7 x 32 = 224
   nodes x 54 fields, 44 of them categorical): bit-equal to its plain
   version on dyadic histograms, search and fused fold (the six tree
   tables after ``_decide_level``); on real statistics the largest gain
   difference; its device time (``torch.profiler``), the plain version's,
   the bound, and the host time a level of both (the kernel's wrapper and
   the plain search with its fold), without a sync.
3a. A short fit of the Higgs-shaped data (2 trees) under
   ``ExecutionPlan(hist_strategy="cuda_packed")``: the naive-packing
   histogram must run once per level and the train loss must fall.
3c. The packed path: an IoT-shaped dataset (``paper_dataset("iot")``,
   paper Table III's botnet set, 115 numeric fields, binary; 2,000,000
   training records plus 200,000 held out; data seed S + 1),
   ``Binner(16)``, whose transform stores both copies as 4-bit
   ``PackedCodes``, then ``train`` of 8 depth-6 ``binary:logistic`` trees
   and ``predict_margin`` on the held-out packed codes.  The nibble
   histogram and the nibble partition must run once per level, the
   traversal once per tree (its nibble entry, on the packed row-major
   codes as they lie), the ensemble at least once; the loss, accuracy and
   replay gates of phase 3; then the device time of one round's step ⑤.
4. Where the time of one boosting round goes (``torch.profiler``), for
   each of the three paths.
5. The serving path at the Higgs-shaped cell's width (28 fields, 256
   bins, depth 6, ``binary:logistic``; ``paper_dataset("higgs")``, 1,000,000
   training records and 100,000 held out for requests):
   ``BoosterClassifier(n_trees=8).fit``, ``save`` and
   ``BoosterClassifier.load``; a warm start of 8 more trees from the bundle,
   whose replayed margins must equal v1's direct ``predict_margin`` bit for
   bit, whose first 8 trees must be v1's and whose loss must fall every
   round (whether a 16-tree fit in one go is bit-equal is printed, not
   gated: the card's atomics add in no fixed order); then
   ``ModelRegistry.publish`` of v1, a ``Server(max_batch=4096)`` warmed over
   ``warmup_buckets(4096)`` (one CUDA graph per bucket), and 256 requests
   (sizes log-uniform over 1-4096 rows, slack 0-5 ms) from 4 client
   threads while ``publish`` hot-swaps v2.  The fits must have launched
   the histogram and the partition once a level and tree, and the
   traversal once a round and replayed round, and no other kernel entry.
   Every answer must equal the direct predict of its own rows by the
   version that served it, bit for bit, and the plain version's on the
   card (``traversal_strategy="reference"``) too; each bucket's graph, for
   both versions, must equal the plain version bit for bit; captures
   happen only in the warm-up and in ``publish``, and no kernel launches
   while serving but those captures' (a replay launches nothing through a
   wrapper); graph replays equal flushes (plus publish's warm-up); nothing
   is dropped.  Then the same requests again at slack 0 (each flushed at
   once) with v2 live: no capture, answers bit-equal to v2's direct
   predict.  The request latency (p50, p99) of both runs and each bucket's
   replay time against the direct eager call go into the ``ensemble`` row
   (``serve_*``), with the card's name and power limit.

6. The training variants (log lines ``variants ...``), on phase
   3's Higgs-shaped data (N records, 28 fields, 256 bins, depth 6) and
   phase 3b's Covertype-shaped data, each part a gate:
   (a) 8 fused rounds (``fused_rounds=True``: one CUDA graph a round)
   against the host loop: one capture and 7 replays, the fit's launches
   (the eager round's and the captured ones times the replays) histogram =
   partition = 6 x 8 and traversal = 8, the wrappers' counts those of the
   eager round and the capture only, round 0's trees equal (feature,
   threshold, is_cat), losses within rtol 1e-4; the steady round wall of
   each and its idle share (a graph replay's span on the card, and phase
   4's one-round profile); (b) ``hist_subtraction=True`` under the host
   loop and fused rounds: levels >= 1 bin n // 2 records, round 0's tree
   within the subtraction contract of the direct fit's (feature,
   threshold, is_cat exact, leaves rtol 1e-4, atol 1e-5), the losses
   within rtol 1e-4 (later trees' differing nodes counted), and on
   exact-grid statistics the subtraction tree bit-equal to the direct
   one; then at each level >= 1 of a tree
   on the path's codes the histogram's device time with and without
   subtraction and the subtraction's whole device time; (c) the lossguide
   grower, ``max_leaves=32``, 4 trees: the loss falls, at most 32 leaves, 1
   + splits histogram launches; (d) GOSS 0.2/0.1 under the host loop and
   fused rounds: losses within rtol 1e-4; (e) on the Covertype-shaped data
   8 fused rounds against phase 3b's host loop (steady round, idle share),
   then 4 fused rounds with subtraction (the masked class-batched route
   inside the graph: one launch of all n records a level) against the host
   loop with subtraction; (f) the kernels of each part against their plain
   versions on the same inputs: the subtraction's level histogram
   (compacted at K = 1, masked at K = 7) bit-equal to the direct pass and to
   its plain version on exact-grid statistics, the lossguide node
   histogram, the host split offload against the device split search, GOSS
   weights on the card against the CPU's.  The numbers go into the
   ``histogram`` and ``histogram_classes`` rows with the card's name and
   power limit (``variants_card``).
7. Out-of-core training (log lines ``stream ...``), run last, on the raw
   float32 matrices of phases 3, 3b and 3c, each streamed from an
   ``ArraySource`` in host memory with that phase's binner and the
   default ``chunk_bytes`` (64 MiB): chunks staged in pinned memory,
   uploaded on a copy stream and binned on the card.  Each part is a gate:
   (a) ``fit_forest_chunked`` on the stream against ``fit_forest`` on the
   phase's in-memory codes, on exact-grid statistics: trees and final node
   ids bit-equal, and every chunk's codes binned on the card bit-equal to
   the host's (the IoT packed stream also against its uint8 stream);
   (b) ``train_streaming`` of the phase's rounds against its in-memory
   fit: histogram and partition launched once a chunk a level, the loss
   falling every round, round 0's split fields and categorical flags
   exact and its leaves within rtol 1e-4 + 1e-5 (on the Covertype-shaped
   cell its roots' fields and flags: below an indicator's split, float32
   rounding decides splits of no real gain), every loss within rtol 1e-4,
   later rounds' differing nodes counted; the
   steady streamed round against the in-memory host loop's, and one level
   pass split into host staging, upload, card binning and growth (CUDA
   events), overlapped, and its peak device memory against
   ``chunk_bytes``; (c) a warm start of 2 trees from the streamed Higgs
   model: ``_streamed_margins`` bit-equal to ``predict_margin`` on the
   same codes, the ensemble launched once a chunk, the warm start's
   margins equal to its model's ``predict_margin``; (d) the Covertype
   stream through ``RetryingSource(FaultySource(...))`` under a seeded
   error storm and one injected ``DeviceOOMError``: the storm absorbed,
   ``chunk_rows`` halved and counted in ``stats``, the model within (b)'s
   contract of (b)'s.  The kernel rows gain ``stream_launches``, the
   histogram rows the streamed round and the pass breakdown.
8. Distributed training and the launch drivers (log lines ``dist ...``),
   last, on phase 3's Higgs-shaped and phase 3b's Covertype-shaped data,
   on single-controller meshes that repeat the card (``[cuda:0] * D``;
   where more cards are visible, also one over them).  Each part is a
   gate: (a) on a D = 4 ``("data",)`` mesh, on exact-grid statistics,
   ``distributed_histogram`` bit-equal to ``ops.build_histogram`` (one
   launch a shard), ``distributed_fit_tree`` explicit and with
   ``partition_bits`` (trees and final node ids) and ``pjit_fit_tree``
   bit-equal to ``fit_forest``; the bf16 sum within bfloat16 rounding of
   the float32 one; (b) ``train_distributed``, 8 rounds at D = 1 and
   D = 4, against phase 3's host loop: histogram and partition once a
   shard a level, no traversal (step ⑤ is a leaf lookup), round 0 under
   phase 7's ``round0_contract``, the loss falling every round, losses
   within rtol 1e-4; the Covertype K = 7 fit at D = 4 likewise; a 2-round
   warm start replaying the D = 4 model (the ensemble at T = K once a
   round); (c) a worker lost at round 3 of the D = 4 fit (``FaultInjector``):
   the mesh shrinks to 3, the round-2 checkpoint is restored and round 2
   replayed, within (b)'s contract of an uninterrupted D = 3 fit; one
   injected ``DeviceOOMError`` doubles ``hist_slices``; (d)
   ``sharded_predict`` over a (1, 4) ``("data", "model")`` mesh: the
   ensemble launched once a shard, margins within rtol 1e-6 (atol 1e-6)
   of ``predict_margin``, bit-equal on dyadic leaves; (e) the CLIs as
   subprocesses: ``python -m repro_torch.launch.train`` on 1,000,000
   Higgs-shaped records, one run given SIGTERM after its first
   checkpoint (exit code 75) and finished by ``--resume``, within (b)'s
   contract of an uninterrupted run, and ``python -m
   repro_torch.launch.serve --mode gbdt`` (its zero-retrace and
   zero-drop lines OK); (f) the steady round at D = 1 and D = 4 against
   the host loop's, one level at NN = 32 split into the shards'
   histograms, the sum, the split search and the partitions (CUDA
   events), and the collective bytes ``collective_stats()`` counts.  Each
   kernel row gains ``dist_launches`` (0 where phase 8 launches none).
9. The LM substrate's serving path (log lines ``lm ...``, last), with
   TF32 off; it launches none of the kernels above (``repro`` computes
   this path in jnp, without Pallas).  Each part is a gate: (a) each of
   the ten smoke configs on the card against the CPU from the same
   parameters: ``prefill``'s logits and 8 greedy ``decode_step``s within
   1e-4 of the largest |logit|, the greedy tokens identical; (b) at full
   width, minicpm-2b (40 layers, float32 weights, B 4 x 512, 32 steps),
   mamba2-370m (48 layers, likewise) and mixtral-8x22b cut to 2 layers
   (bfloat16 weights, B 2 x 4,160 past its 4,096 window, 16 steps):
   ``decode_step``'s logits at steps 0 and last against
   ``forward_train``'s at the same positions, within 5e-3 of the largest
   |logit| in a float32-compute witness of the same weights; computing in
   bfloat16, the decode's distance from the witness's forward pass within
   1.5 x the bf16 forward pass's (both printed, with the bf16 decode
   against the bf16 forward); (c) ``python -m
   repro_torch.launch.serve --mode lm --arch qwen3-14b --prompt-len 16
   --gen 8`` as a subprocess exits 0; (d) for each (b) run the prefill's
   time and tokens/s (CUDA events, after a warm-up that casts the
   weights), the median decode step (CUDA events, steps after the
   first), peak memory, the decode step's byte bound (the weight bytes it
   reads / 3.35 TB/s; for MoE also counting only the experts the step's
   tokens route to) and the prefill's FLOP bound (2 x active params x
   tokens / 989 TFLOP/s), and one decode step under ``torch.profiler``:
   its kernels, device time and the host's share of the median step;
   printed as ``lm summary {...}``.
10. LM training (log lines ``lm train ...``), with TF32 off; no
   kernel of the table either (``repro`` trains with ``jax.grad``,
   ``jax.checkpoint`` and a jnp AdamW).  Each part is a gate: (a) each
   of the ten smoke configs (float32) on the card against the CPU from
   the same parameters and batch: ``loss_fn`` within rtol 1e-5, each
   gradient leaf within 1e-4 of its largest |g| (leaves that are zero in
   exact arithmetic below 1e-7 of the largest |g|), three
   ``make_train_step`` losses within rtol 1e-4, and on the card remat
   off and "dots" within 1e-6 of "full"; (b) minicpm-2b as configured
   (40 layers, float32 weights, bf16 compute, remat "full", WSD), B 4 x
   512 from ``token_batches``: step 0 against a float32-compute witness
   of the same weights and batch (loss within 1e-2 relative, gradient
   cosine >= 0.99), then 10 steps on the batch (base lr 3e-4, warmup 2):
   every loss and gradient norm finite, the last loss below step 0's;
   the median step (CUDA events), loss and backward alone, AdamW alone,
   one step under ``torch.profiler`` (device time, host share), peak
   memory, beside the FLOP bound (6 x active params x tokens / 989
   TFLOP/s, and 8 x with remat's repeated forward) and AdamW's byte
   bound (p, g, m, v read, p, m, v written, / 3.35 TB/s); (c) on the
   same weights, loss and backward at B 1 x 512 under remat off, "full"
   and "dots" (time, peak memory, gradients within 1e-4 of remat
   off's), and ``loss_fn_blocked`` (8 chunks) against ``loss_fn`` in the
   float32 witness at B 4 x 512 (loss within 1e-5, peak memory below
   ``loss_fn``'s); (d) as (b) without the witness: mamba2-370m as
   configured (48 SSD layers, cosine) at B 4 x 512, and mixtral-8x22b at
   full width cut to 1 layer (bf16 weights, float32 moments) at B 1 x
   4,160 past its 4,096 window; (e) ``python -m repro_torch.launch.train
   --mode lm --arch qwen3-14b --trees 3`` as a subprocess exits 0 on the
   card with its step-0 loss line; printed as ``lm train summary
   {...}``.
11. The dry runs and the report (log lines ``dryrun ...``, last),
   held against the card; ``repro``'s dry runs reach no kernel of the
   table.  Each part is a gate: (a) ``python -m
   repro_torch.launch.dryrun_gbdt --mesh both`` exits 0 for each of the
   five variants, and each plan's per-card terms are printed (200 M
   records x 64 fields, 256 bins, depth 6; datasheet peaks, not
   measurements); (b) the single-pod plan's card shard, 12,500,000
   random records x 4 fields, grown into one tree on the card by
   ``core.tree.fit_forest``, each level's histogram and partition call
   timed by CUDA events and printed beside the plan's memory terms (a
   witness, not a band), then ``distributed_fit_tree`` (each
   ``explicit*`` variant) and ``pjit_fit_tree`` on a (2, 2) mesh that
   repeats the card, at 25,000,000 x 8: ``collective_stats()`` of the
   tree equals the plan's collectives for that mesh and size by kind,
   count and bytes; (c) ``python -m repro_torch.launch.dryrun --arch all
   --shape all --mesh both --jobs 6`` as a subprocess that runs on the
   host's cores beside (a), (b) and (d), exits 0 with every runnable
   cell planned on both meshes (66 records), skips only where
   ``cell_is_runnable`` says so (14), 0 FAIL, its wall time printed;
   (d) minicpm-2b as phase 10 (b) trains it (float32 weights, bf16
   compute, remat "full", B 4 x 512) planned on a (1, 1) meta mesh, then
   one real ``make_train_step`` on the card under ``FlopCounterMode``:
   its FLOPs equal the plan's exactly, and the plan's
   ``bytes_per_device`` lies within 0.8–1.25 of the step's
   ``torch.cuda.max_memory_allocated``; (e) ``python -m
   repro_torch.launch.report`` over (c)'s records exits 0 with 40 rows
   for each mesh; printed as ``dryrun summary {...}``.  Its files go to
   ``build/smoke_dryrun`` (removed after).

The last two lines of standard output are JSON: the kernel table, then
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
repository's ``src/repro_torch`` beside this file, the script exits
non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM memory rate
SCALAR_OPS_PER_S = 67e12         # H100 SXM float32 rate outside tensor cores
OPS_PER_HOP = 8                  # integer operations of one tree-walk hop
N_FIELDS, N_BINS, DEPTH = 28, 256, 6
ENSEMBLE_TREES = 500             # the paper's tree count
# UCI Covertype: 581,012 records, 10 numeric fields, 44 binary indicators,
# 7 classes; the multi-class path trains 8 rounds (56 trees) of it
MC_NUMERIC, MC_BINARY, MC_CLASSES = 10, 44, 7
MC_FIELDS = MC_NUMERIC + MC_BINARY
MC_RECORDS, MC_ROUNDS = 581_012, 8
MC_ROUNDS_TIMED = 72             # 504 trees in the timed ensemble
# paper Table III's IoT botnet set: 115 numeric fields, binary; 7 M records
# in full, cut to 2 M (+10 % held out) to bound the host's quantile fit
IOT_RECORDS, IOT_FIELDS, IOT_BINS = 2_000_000, 115, 16
NAIVE_TREES = 2                  # trees of the cuda_packed fit (phase 3a)
# phase 5, the serving path: a Higgs-shaped model served to raw requests
SERVE_RECORDS, SERVE_HELD_OUT = 1_000_000, 100_000
SERVE_TREES, SERVE_BATCH = 8, 4096
SERVE_REQUESTS, SERVE_CLIENTS = 256, 4
WIDE_RECORDS = 20_000            # records of the wide ensemble entry's row


def log(*parts) -> None:
    print(*parts, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, reps: int = 5) -> float:
    """Median device time of ``fn`` over ``reps`` runs after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


PROFILE_ATTEMPTS = 3               # profiles taken before an empty one fails


def device_ms(fn, kernel: str, reps: int = 3) -> float:
    """Device time of one call of ``fn`` spent in kernels whose name holds
    ``kernel`` (every kernel for ``""``; ``torch.profiler``, mean of
    ``reps`` calls after a warm-up).  A profile now and then comes back
    without device events (PERF.md §7), so an empty one is taken again,
    up to ``PROFILE_ATTEMPTS`` profiles; fails where none sees the
    kernel."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    total = 0.0
    for attempt in range(PROFILE_ATTEMPTS):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(_device_us(e) for e in prof.key_averages()
                    if kernel in e.key
                    and "CUDA" in str(getattr(e, "device_type", "")))
        if total > 0:
            break
        log(f"torch.profiler saw no device time of {kernel or 'a kernel'} "
            f"(profile {attempt + 1} of {PROFILE_ATTEMPTS})")
    check(total > 0,
          f"torch.profiler saw device time of {kernel or 'a kernel'}")
    return total / reps / 1e3


def _device_us(e) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(e, attr):
            return getattr(e, attr)
    return 0.0


def sector_reading(nid, split_feature, row_len: int, packed: bool) -> int:
    """Bytes of the 32-byte sectors of the split columns that the node ids
    ``nid`` ((n,) or (K, n)) touch, over all classes (a sector read by two
    classes counted once): record r of a node splitting on field f reads
    byte f * row_len + r (r // 2 packed) of the column-major copy."""
    feat = torch.gather(split_feature.reshape(-1, split_feature.shape[-1]),
                        1, nid.reshape(split_feature.numel()
                                       // split_feature.shape[-1], -1).long())
    r = torch.arange(feat.shape[1], device=feat.device)
    byte = feat.long() * row_len + ((r >> 1) if packed else r)
    return 32 * int(torch.unique((byte[feat >= 0]) >> 5).numel())


def bound(n_bytes: float, n_ops: float):
    """(least time in ms, what bounds it) for this much work."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def environment(build) -> str:
    """Log the card, the versions and the build; returns the card's name
    and power limit as ``nvidia-smi`` gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    log(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
        f"python {sys.version.split()[0]}  nvcc: {nvcc}")
    log(f"device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    paths = build.build_all()
    log(f"build: {time.perf_counter() - t0:.3f} s  ->  "
        + ", ".join(p.name for p in paths.values()))
    for p in paths.values():
        log_file = p.with_suffix(".so.log")
        if log_file.exists():
            for line in log_file.read_text().splitlines():
                if "Used" in line or "Compiling entry" in line:
                    log("  ptxas " + line.strip())
    return smi


def random_trees(T: int, F: int, gen, dev):
    """T random depth-6 trees over F fields with dyadic leaves (every order
    of summation is exact), pass-through nodes and categorical splits."""
    from repro_torch.kernels import ref

    n_int = 2 ** DEPTH - 1
    ints = [torch.randint(lo, hi, (T, n_int), generator=gen, device=dev,
                          dtype=torch.int32)
            for lo, hi in ((-1, F), (0, N_BINS - 1), (0, 2), (0, 2))]
    leaves = torch.randint(-64, 65, (T, 2 ** DEPTH), generator=gen,
                           device=dev) / 64.0
    return ref.TreeArrays(*ints, leaves)


def hist_within_tolerance(got, want, mag) -> bool:
    """The plain version sums in float32 record by record, the kernel on a
    fixed-point grid: rtol 1e-5 plus 1e-5 of the sum of |stat| over the
    node's records (``mag``)."""
    return bool(torch.all((got - want).abs() <= 1e-5 * want.abs()
                          + 1e-5 * mag))


def partition_times(fn, nid, split_feature, row_len: int,
                    packed: bool) -> dict:
    """A partition launch's times: the kernel's device time (``ms``), the
    wrapper's (CUDA events around the call), the 9-bytes-a-record bound
    (node id in, code byte, node id out), and beside it the bound that
    reads the 32-byte sectors of the split columns that these node ids
    touch (:func:`sector_reading`) instead of one byte a record."""
    n_ids = nid.numel()
    code_bytes = n_ids / 2 if packed else n_ids
    b_ms, b_by = bound(8 * n_ids + code_bytes + 16 * split_feature.numel(),
                       6 * n_ids)
    sectors = sector_reading(nid, split_feature, row_len, packed)
    return dict(ms=device_ms(fn, "partition_kernel"), wrapper_ms=time_ms(fn),
                bound_ms=b_ms, bound_by=b_by, sector_bytes=sectors,
                sector_bound_ms=(8 * n_ids + sectors
                                 + 16 * split_feature.numel())
                / HBM_BYTES_PER_S * 1e3)


def row_summary(row: dict) -> str:
    """A kernel row's times for the log."""
    out = (f"kernel {row['ms']:.4f} ms (device)  wrapper "
           f"{row['wrapper_ms']:.4f} ms  bound {row['bound_ms']:.4f} ms "
           f"({row['bound_by']})")
    if "sector_bound_ms" in row:
        out += (f"  split-column sectors {row['sector_bytes'] / 1e6:.1f} MB"
                f" -> {row['sector_bound_ms']:.4f} ms")
    return out


def traversal_times(forest, codes, row_bytes: int, missing_bin: int,
                    gen) -> dict:
    """A step-⑤ launch's times as a round makes it (leaves added into
    (n, K) margins in place, no field check): the kernel's device time
    (``ms``), the wrapper's, and the bound (each record's code row read,
    its K margins read and written, the trees read; 8 operations a hop)."""
    from repro_torch.kernels import traversal as trav_k

    K = forest.feature.shape[0]
    n = codes.shape[0]
    margins = torch.randn((n, K), generator=gen, device=codes.device)
    fn = lambda: trav_k.traverse_forest_cuda(
        forest, codes, missing_bin=missing_bin, margins=margins,
        check_fields=False)
    b_ms, b_by = bound(n * row_bytes + 8 * n * K
                       + 4 * K * (2 ** (DEPTH + 1) - 1),
                       n * K * DEPTH * OPS_PER_HOP)
    return dict(ms=device_ms(fn, "ensemble_kernel"), wrapper_ms=time_ms(fn),
                bound_ms=b_ms, bound_by=b_by)


def kernel_parity(n: int, seed: int, dev) -> dict:
    """Phase 2: each kernel against its plain version at the main path's
    shapes.  Returns the kernel rows (without launch counts)."""
    from repro_torch.kernels import histogram as hist_k
    from repro_torch.kernels import partition as part_k
    from repro_torch.kernels import ref
    from repro_torch.kernels import traversal as trav_k

    gen = torch.Generator(device=dev).manual_seed(seed)
    F, NB = N_FIELDS, N_BINS
    codes = torch.randint(0, NB, (n, F), generator=gen, device=dev,
                          dtype=torch.uint8)
    codes_cm = codes.T.contiguous()
    g_dy = torch.randint(-64, 64, (n,), generator=gen, device=dev) / 64.0
    h_dy = torch.randint(1, 64, (n,), generator=gen, device=dev) / 64.0
    g = torch.randn((n,), generator=gen, device=dev)
    h = torch.rand((n,), generator=gen, device=dev) * 0.9 + 0.1
    rows = {}

    # -- histogram -------------------------------------------------------
    hist_err = 0.0
    for NN, nn_rows in ((1, n), (32, n), (512, min(n, 1_000_000))):
        nid = torch.randint(0, NN, (nn_rows,), generator=gen, device=dev,
                            dtype=torch.int32)
        c = codes[:nn_rows]
        got = hist_k.histogram_cuda(c, g_dy[:nn_rows], h_dy[:nn_rows], nid,
                                    n_nodes=NN, n_bins=NB)
        want = hist_k.histogram_plain(c, g_dy[:nn_rows], h_dy[:nn_rows], nid,
                                      NN, NB)
        check(torch.equal(got, want), f"histogram NN={NN} dyadic bit-equal")
        got = hist_k.histogram_cuda(c, g[:nn_rows], h[:nn_rows], nid,
                                    n_nodes=NN, n_bins=NB)
        want = hist_k.histogram_plain(c, g[:nn_rows], h[:nn_rows], nid, NN,
                                      NB)
        mag = hist_k.histogram_plain(c, g[:nn_rows].abs(), h[:nn_rows], nid,
                                     NN, NB).sum(dim=2, keepdim=True)
        check(hist_within_tolerance(got, want, mag),
              f"histogram NN={NN} within rtol 1e-5 + 1e-5 node sum|stat|")
        hist_err = max(hist_err, float((got - want).abs().max()))
        del got, want, mag
        if NN != 2 ** (DEPTH - 1):
            log(f"histogram NN={NN} n={nn_rows}: parity ok")
            continue
        # timed at the deepest level of the depth-6 main path (NN = 32)
        ms = time_ms(lambda: hist_k.histogram_cuda(c, g, h, nid, n_nodes=NN,
                                                   n_bins=NB))
        ms_nn1 = time_ms(lambda: hist_k.histogram_cuda(
            c, g, h, torch.zeros_like(nid), n_nodes=1, n_bins=NB))
        plain_ms = time_ms(lambda: hist_k.histogram_plain(c, g, h, nid, NN,
                                                          NB), reps=3)
        idx = ((nid.long()[:, None] * F + torch.arange(F, device=dev))
               * NB + c.long()).reshape(-1)
        wg = g[:, None].expand(n, F).reshape(-1)
        wh = h[:, None].expand(n, F).reshape(-1)
        lib_ms = time_ms(lambda: (
            torch.bincount(idx, weights=wg, minlength=NN * F * NB),
            torch.bincount(idx, weights=wh, minlength=NN * F * NB)), reps=3)
        del idx, wg, wh
        b_ms, b_by = bound(n * F + 12 * n + NN * F * NB * 8, 2 * n * F)
        rows["histogram"] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms, shape=f"n={n} F={F} NB={NB} NN={NN}, "
            f"{grouped_label(n, 1, NN, F, NB)}", ms_nn1=ms_nn1)
        log(f"histogram NN={NN} n={n}: parity ok  kernel {ms:.3f} ms  "
            f"(NN=1 {ms_nn1:.3f} ms)  plain {plain_ms:.3f} ms  "
            f"bincount {lib_ms:.3f} ms  bound {b_ms:.3f} ms ({b_by})")
    rows["histogram"]["max_abs_err"] = hist_err

    # -- partition, both entries -----------------------------------------
    NN = 32
    nid = torch.randint(0, NN, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    split = [torch.randint(-1, F, (NN,), generator=gen, device=dev,
                           dtype=torch.int32),
             torch.randint(0, NB, (NN,), generator=gen, device=dev,
                           dtype=torch.int32),
             torch.randint(0, 2, (NN,), generator=gen, device=dev,
                           dtype=torch.int32),
             torch.randint(0, 2, (NN,), generator=gen, device=dev,
                           dtype=torch.int32)]
    got = part_k.partition_cm_cuda(nid, codes_cm, *split,
                                   missing_bin=NB - 1)
    want = part_k.partition_cm_plain(nid, codes_cm, *split, NB - 1)
    check(torch.equal(got, want), "partition (column-major entry) bit-equal")
    codes_lvl = codes_cm[split[0].clamp(min=0).long()].T.contiguous()
    renum = torch.where(split[0] >= 0,
                        torch.arange(NN, device=dev, dtype=torch.int32), -1)
    got_rows = part_k.partition_cuda(nid, codes_lvl, renum, *split[1:],
                                     missing_bin=NB - 1)
    check(torch.equal(got_rows, want), "partition (row entry) bit-equal")
    cm = lambda: part_k.partition_cm_cuda(nid, codes_cm, *split,
                                          missing_bin=NB - 1)
    by_rows = lambda: part_k.partition_cuda(nid, codes_lvl, renum,
                                            *split[1:], missing_bin=NB - 1)
    plain_ms = time_ms(lambda: part_k.partition_cm_plain(
        nid, codes_cm, *split, NB - 1), reps=3)
    rows["partition"] = dict(
        **partition_times(cm, nid, split[0], n, False),
        plain_ms=plain_ms, library_ms=None, max_abs_err=float(
            torch.maximum((got - want).abs().max(),
                          (got_rows - want).abs().max())),
        shape=f"n={n} F={F} NN={NN}",
        rows_entry_ms=device_ms(by_rows, "partition_kernel"),
        rows_entry_wrapper_ms=time_ms(by_rows))
    log(f"partition n={n} NN={NN}: parity ok (both entries)  "
        f"{row_summary(rows['partition'])}  row entry "
        f"{rows['partition']['rows_entry_ms']:.4f} ms  plain "
        f"{plain_ms:.3f} ms")
    del codes_lvl, got, got_rows, want

    # -- traversal and ensemble ------------------------------------------
    one = ref.TreeArrays(*[a[0] for a in random_trees(1, F, gen, dev)])
    got = trav_k.traverse_cuda(one, codes, missing_bin=NB - 1)
    want = trav_k.traverse_plain(one, codes, NB - 1)
    check(torch.equal(got, want), "traversal bit-equal")
    plain_ms = time_ms(lambda: trav_k.traverse_plain(one, codes, NB - 1),
                       reps=3)
    rows["traversal"] = dict(
        **traversal_times(ref.TreeArrays(*[a[None] for a in one]), codes, F,
                          NB - 1, gen),
        plain_ms=plain_ms, library_ms=None,
        max_abs_err=float((got - want).abs().max()),
        shape=f"n={n} F={F} depth={DEPTH}, {ensemble_label(n, F, 1, dev)}")
    log(f"traversal n={n} depth={DEPTH}: parity ok  "
        f"{row_summary(rows['traversal'])}  plain {plain_ms:.3f} ms")

    T, n_words = ENSEMBLE_TREES, 2 ** (DEPTH + 1) - 1
    trees = random_trees(T, F, gen, dev)
    got = trav_k.predict_ensemble_cuda(trees, codes, missing_bin=NB - 1)
    t0 = time.perf_counter()
    want = trav_k.predict_ensemble_plain(trees, codes, NB - 1)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    err = (got - want).abs()
    check(bool(torch.all(err <= 1e-5 * want.abs())),
          "ensemble within rtol 1e-5 (dyadic leaves: exact)")
    ms = time_ms(lambda: trav_k.predict_ensemble_cuda(trees, codes,
                                                      missing_bin=NB - 1))
    # one timed run after the parity run above, which warmed it up
    plain_ms = time_ms(lambda: trav_k.predict_ensemble_plain(trees, codes,
                                                             NB - 1), reps=1)
    hops = n * T * DEPTH
    b_ms, b_by = bound(n * F + 4 * n + 4 * T * n_words, hops * OPS_PER_HOP)
    real = ensemble_real_leaves(trees, codes, 1, gen, dev, "ensemble")
    rows["ensemble"] = dict(
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, max_abs_err=float(err.max()),
        shape=f"n={n} F={F} T={T} depth={DEPTH}, "
        f"{ensemble_label(n, F, T, dev)}",
        bytes_bound_ms=(n * F + 4 * n + 4 * T * n_words)
        / HBM_BYTES_PER_S * 1e3, **real)
    log(f"ensemble n={n} T={T} depth={DEPTH}: parity ok  kernel {ms:.3f} ms"
        f"  plain {plain_ms:.3f} ms (first run {plain_s * 1e3:.1f} ms)  "
        f"bound {b_ms:.3f} ms ({b_by}; {hops:.3g} hops)")
    rows["ensemble_wide"] = ensemble_wide(seed, dev)
    return rows


def ensemble_label(n: int, F: int, T: int, dev, packed: bool = False) -> str:
    """The traversal kernel's geometry: records a block, a thread, trees a
    staged block, and the entry."""
    from repro_torch.kernels import traversal as trav_k

    geo = trav_k.ensemble_geometry(n, F, T, DEPTH,
                                   trav_k.ensemble_limits(dev), packed)
    return (f"R={geo.records} U={geo.per_thread} TB={geo.trees} "
            f"({geo.entry})")


def ensemble_real_leaves(trees, codes, K: int, gen, dev, label: str) -> dict:
    """The ensemble kernel on real (normal) leaves against a float64 sum of
    the plain version's leaf choices, within rtol 1e-5 of each record's
    sum of |leaf| (per class).  Returns the kernel's and the float32 plain
    version's largest errors, absolute and relative to that sum."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import traversal as trav_k

    n, mb = codes.shape[0], N_BINS - 1
    real = trees._replace(leaf_value=0.1 * torch.randn(
        tuple(trees.leaf_value.shape), generator=gen, device=dev))
    got = trav_k.predict_ensemble_cuda(real, codes, missing_bin=mb,
                                       n_classes=K).reshape(n, K).double()
    plain = trav_k.predict_ensemble_plain(real, codes, mb,
                                          K).reshape(n, K).double()
    want = torch.zeros((n, K), dtype=torch.float64, device=dev)
    mag = torch.zeros_like(want)
    for c in range(K):          # class c: trees c, c + K, ... in f64
        cls = ref.TreeArrays(*[a[c::K] for a in real])
        leaf = cls.leaf_value.double()
        if leaf.shape[0]:
            want[:, c] = trav_k.predict_ensemble_plain(
                cls._replace(leaf_value=leaf), codes, mb)
            mag[:, c] = trav_k.predict_ensemble_plain(
                cls._replace(leaf_value=leaf.abs()), codes, mb)
    err, plain_err = (got - want).abs(), (plain - want).abs()
    check(bool(torch.all(err <= 1e-5 * mag)),
          f"{label} on real leaves within rtol 1e-5 of sum|leaf| (float64)")
    tiny = torch.finfo(torch.float64).tiny
    out = dict(real_max_abs_err=float(err.max()),
               real_max_rel_err=float((err / mag.clamp(min=tiny)).max()),
               plain_real_max_abs_err=float(plain_err.max()),
               plain_real_max_rel_err=float(
                   (plain_err / mag.clamp(min=tiny)).max()))
    log(f"{label} real leaves vs float64: kernel max err "
        f"{out['real_max_abs_err']:.3g} ({out['real_max_rel_err']:.3g} of "
        f"sum|leaf|), float32 plain {out['plain_real_max_abs_err']:.3g} "
        f"({out['plain_real_max_rel_err']:.3g})")
    return out


def ensemble_wide(seed: int, dev) -> dict:
    """The ensemble kernel's wide entry (code rows read from global memory)
    at one field past the staged limit, WIDE_RECORDS records, against its
    plain version on dyadic and real leaves.  Returns its kernel row."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import traversal as trav_k

    gen = torch.Generator(device=dev).manual_seed(seed + 6)
    n, T, NB = WIDE_RECORDS, ENSEMBLE_TREES, N_BINS
    F = trav_k.max_staged_fields(DEPTH, trav_k.ensemble_limits(dev)) + 1
    codes = torch.randint(0, NB, (n, F), generator=gen, device=dev,
                          dtype=torch.uint8)
    trees = random_trees(T, F, gen, dev)
    before = _build.launch_counts()["ensemble_wide"]
    got = trav_k.predict_ensemble_cuda(trees, codes, missing_bin=NB - 1)
    check(_build.launch_counts()["ensemble_wide"] == before + 1,
          f"F={F} takes the wide entry")
    want = trav_k.predict_ensemble_plain(trees, codes, NB - 1)
    check(torch.equal(got, want), "wide ensemble bit-equal (dyadic leaves)")
    real = ensemble_real_leaves(trees, codes, 1, gen, dev, "wide ensemble")
    ms = time_ms(lambda: trav_k.predict_ensemble_cuda(trees, codes,
                                                      missing_bin=NB - 1))
    plain_ms = time_ms(lambda: trav_k.predict_ensemble_plain(trees, codes,
                                                             NB - 1), reps=1)
    hops = n * T * DEPTH
    n_words = 2 ** (DEPTH + 1) - 1
    b_ms, b_by = bound(n * F + 4 * n + 4 * T * n_words, hops * OPS_PER_HOP)
    log(f"wide ensemble n={n} F={F} T={T}: parity ok  kernel {ms:.3f} ms  "
        f"plain {plain_ms:.3f} ms  bound {b_ms:.3f} ms ({b_by})")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, max_abs_err=float((got - want).abs().max()),
                shape=f"n={n} F={F} T={T} depth={DEPTH}, "
                f"{ensemble_label(n, F, T, dev)}; on no path", **real)


def dyadic_stats(shape, gen, dev):
    """g, h on a 1/64 grid: every order of summation is exact."""
    return (torch.randint(-64, 64, shape, generator=gen, device=dev) / 64.0,
            torch.randint(1, 64, shape, generator=gen, device=dev) / 64.0)


def real_stats(shape, gen, dev):
    return (torch.randn(shape, generator=gen, device=dev),
            torch.rand(shape, generator=gen, device=dev) * 0.9 + 0.1)


def histogram_index(codes, nid, n_nodes: int, n_bins: int):
    """The flat (class, node, field, bin) index of every (record, field)
    pair, from the codes unpacked: the input of a ``torch.bincount``
    histogram."""
    from repro_torch.core.binning import as_unpacked

    c = as_unpacked(codes).long()
    n, F = c.shape
    K = nid.numel() // n
    slot = (nid.long().reshape(K, n)
            + torch.arange(K, device=c.device)[:, None] * n_nodes)
    return ((slot[:, :, None] * F + torch.arange(F, device=c.device))
            * n_bins + c[None]).reshape(-1)


def bincount_histogram(idx, g, h, size: int):
    """The histogram as one ``torch.bincount`` a statistic over ``idx``."""
    F = idx.numel() // g.numel()
    return tuple(torch.bincount(idx, weights=w.reshape(-1, 1).expand(-1, F)
                                .reshape(-1), minlength=size) for w in (g, h))


def grouped_label(n: int, K: int, NN: int, F: int, NB: int) -> str:
    """The grouped kernel's launch at this shape, for a row's ``shape``."""
    from repro_torch.kernels import histogram as hist_k

    geo = hist_k.grouped_geometry(n, K, NN, F, NB,
                                  hist_k.grouped_limits("cuda:0"))
    sort = "one slot, no sort" if K * NN == 1 else "counting sort"
    return (f"records sorted by slot ({sort}), "
            f"{geo.blocks} blocks x {geo.n_ftiles} field tile(s) of "
            f"{geo.field_tile} fields, {geo.per_block} positions a block, a "
            f"warp per record and a lane per field")


def histogram_f64(codes, g, h, nid, n_nodes: int, n_bins: int):
    """The plain histogram's scatter-add in float64 (g, h, nid (K, n)),
    and beside it each bin's sum of |g| and of h: (K, NN, F, NB, 2) each."""
    idx = histogram_index(codes, nid, n_nodes, n_bins)
    K, (n, F) = g.shape[0], codes.shape
    size = K * n_nodes * F * n_bins

    def total(w):
        return torch.bincount(idx, weights=w.double().reshape(-1, 1)
                              .expand(-1, F).reshape(-1), minlength=size)

    shape = (K, n_nodes, F, n_bins, 2)
    want = torch.stack([total(g), total(h)], dim=-1).reshape(shape)
    mag = torch.stack([total(g.abs()), total(h)], dim=-1).reshape(shape)
    return want, mag


def nibble_histogram(codes, K: int, nn_levels, gen, dev, label: str) -> dict:
    """The nibble histogram on uint8 ``codes`` (n, F) <= 15, packed here:
    at each NN of ``nn_levels`` bit-equal to its plain version and to the
    uint8 kernel on dyadic g, h, within tolerance on real ones, and timed
    beside the uint8 kernel on the same codes (nibble, uint8, uint8,
    nibble).  At the last NN also the plain version, the bincount call and
    the bound."""
    from repro_torch.core.binning import PackedCodes
    from repro_torch.kernels import histogram as hist_k

    (n, F), NB = codes.shape, IOT_BINS
    packed = PackedCodes.pack(codes)
    shape = (n,) if K == 1 else (K, n)
    g_dy, h_dy = dyadic_stats(shape, gen, dev)
    g, h = real_stats(shape, gen, dev)
    out, err = {}, 0.0
    for nn in nn_levels:
        nid = torch.randint(0, nn, shape, generator=gen, device=dev,
                            dtype=torch.int32)
        got = hist_k.histogram_cuda(packed, g_dy, h_dy, nid, n_nodes=nn,
                                    n_bins=NB)
        check(torch.equal(got, hist_k.histogram_plain(packed, g_dy, h_dy, nid,
                                                      nn, NB)),
              f"nibble histogram K={K} NN={nn} ({label}) dyadic bit-equal")
        check(torch.equal(got, hist_k.histogram_cuda(codes, g_dy, h_dy, nid,
                                                     n_nodes=nn, n_bins=NB)),
              f"nibble histogram K={K} NN={nn} ({label}) bit-equal to the "
              "uint8 kernel")
        got = hist_k.histogram_cuda(packed, g, h, nid, n_nodes=nn, n_bins=NB)
        want = hist_k.histogram_plain(packed, g, h, nid, nn, NB)
        mag = hist_k.histogram_plain(packed, g.abs(), h, nid, nn,
                                     NB).sum(dim=-2, keepdim=True)
        check(hist_within_tolerance(got, want, mag),
              f"nibble histogram K={K} NN={nn} ({label}) within rtol 1e-5 "
              "+ 1e-5 node sum|stat|")
        err = max(err, float((got - want).abs().max()))
        del got, want, mag
        nib = lambda: hist_k.histogram_cuda(packed, g, h, nid, n_nodes=nn,
                                            n_bins=NB)
        u8 = lambda: hist_k.histogram_cuda(codes, g, h, nid, n_nodes=nn,
                                           n_bins=NB)
        t = [time_ms(f) for f in (nib, u8, u8, nib)]
        out[nn] = ((t[0] + t[3]) / 2, (t[1] + t[2]) / 2)
        log(f"nibble histogram K={K} NN={nn} n={n} F={F} ({label}): parity "
            f"ok  nibble {t[0]:.3f}, {t[3]:.3f} ms  uint8 {t[1]:.3f}, "
            f"{t[2]:.3f} ms")
    nn = nn_levels[-1]
    plain_ms = time_ms(lambda: hist_k.histogram_plain(packed, g, h, nid, nn,
                                                      NB), reps=3)
    # unpack, index and bincount: the index depends on the packed codes
    lib_ms = time_ms(lambda: bincount_histogram(
        histogram_index(packed, nid, nn, NB), g, h, K * nn * F * NB), reps=3)
    b_ms, b_by = bound(n * ((F + 1) // 2) + 12 * K * n
                       + K * nn * F * NB * 8, 2 * K * n * F)
    log(f"nibble histogram K={K} NN={nn} ({label}): plain {plain_ms:.3f} ms"
        f"  unpack + bincount {lib_ms:.3f} ms  bound {b_ms:.4f} ms ({b_by})")
    row = dict(ms=out[nn][0], plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               library_ms=lib_ms, max_abs_err=err, uint8_ms=out[nn][1],
               shape=f"n={n} F={F} NB={NB} K={K} NN={nn}, "
               f"{grouped_label(n, K, nn, F, NB)}, {label}")
    if len(nn_levels) > 1:
        row.update(ms_nn1=out[nn_levels[0]][0],
                   uint8_ms_nn1=out[nn_levels[0]][1])
    return row


def nibble_partition(n: int, F: int, K: int, gen, dev) -> dict:
    """The nibble column-major partition at ``n`` records (odd: every
    packed row ends in a pad nibble): bit-equal to its plain version and
    to the uint8 entry on the same codes; timed."""
    from repro_torch.core.binning import PackedCodes
    from repro_torch.kernels import partition as part_k

    NN, NB = 2 ** (DEPTH - 1), IOT_BINS
    codes_cm = torch.randint(0, NB, (F, n), generator=gen, device=dev,
                             dtype=torch.uint8)
    packed = PackedCodes.pack(codes_cm)
    shape = (NN,) if K == 1 else (K, NN)
    nid = torch.randint(0, NN, shape[:-1] + (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    split = [torch.randint(lo, hi, shape, generator=gen, device=dev,
                           dtype=torch.int32)
             for lo, hi in ((-1, F), (0, NB), (0, 2), (0, 2))]
    got = part_k.partition_cm_cuda(nid, packed, *split, missing_bin=NB - 1)
    want = part_k.partition_cm_plain(nid, packed, *split, NB - 1)
    check(torch.equal(got, want), f"nibble partition K={K} n={n} bit-equal")
    check(torch.equal(got, part_k.partition_cm_cuda(nid, codes_cm, *split,
                                                    missing_bin=NB - 1)),
          f"nibble partition K={K} n={n} bit-equal to the uint8 entry")
    nib = lambda: part_k.partition_cm_cuda(nid, packed, *split,
                                           missing_bin=NB - 1)
    u8 = lambda: part_k.partition_cm_cuda(nid, codes_cm, *split,
                                          missing_bin=NB - 1)
    t = [device_ms(f, "partition_kernel") for f in (nib, u8, u8, nib)]
    plain_ms = time_ms(lambda: part_k.partition_cm_plain(
        nid, packed, *split, NB - 1), reps=3)
    # per record: node id in, half a code byte, node id out
    row = partition_times(nib, nid, split[0], (n + 1) // 2, True)
    row.update(ms=(t[0] + t[3]) / 2, uint8_ms=(t[1] + t[2]) / 2)
    log(f"nibble partition K={K} NN={NN} n={n}: parity ok  nibble "
        f"{t[0]:.4f}, {t[3]:.4f} ms  uint8 entry {t[1]:.4f}, {t[2]:.4f} ms "
        f"(device)  {row_summary(row)}  plain {plain_ms:.3f} ms")
    return dict(**row, plain_ms=plain_ms, library_ms=None,
                max_abs_err=float((got - want).abs().max()),
                shape=f"n={n} F={F} NB={NB} K={K} NN={NN}")


def nibble_traversal(n: int, F: int, gen, dev) -> dict:
    """Step ⑤ on 4-bit packed rows (the nibble entry) at the IoT-shaped
    path's shape: one tree, bit-equal to its plain version and to the uint8
    entry on the same codes, and added into margins bit-equal to
    ``margins + leaf``; timed (nibble, uint8, uint8, nibble)."""
    from repro_torch.core.binning import PackedCodes
    from repro_torch.kernels import traversal as trav_k

    NB = IOT_BINS
    codes = torch.randint(0, NB, (n, F), generator=gen, device=dev,
                          dtype=torch.uint8)
    packed = PackedCodes.pack(codes)
    forest = random_trees(1, F, gen, dev)
    forest = forest._replace(threshold=forest.threshold % NB)
    got = trav_k.traverse_forest_cuda(forest, packed, missing_bin=NB - 1)
    want = trav_k.traverse_forest_plain(forest, packed, NB - 1)
    check(torch.equal(got, want), "nibble traversal bit-equal")
    check(torch.equal(got, trav_k.traverse_forest_cuda(
        forest, codes, missing_bin=NB - 1)),
          "nibble traversal bit-equal to the uint8 entry")
    margins = torch.randn((n,), generator=gen, device=dev)
    expect = margins + want[:, 0]
    check(torch.equal(trav_k.traverse_forest_cuda(
        forest, packed, missing_bin=NB - 1, margins=margins), expect),
          "nibble traversal into the margins bit-equal to margins + leaf")
    nib = lambda: trav_k.traverse_forest_cuda(
        forest, packed, missing_bin=NB - 1, margins=margins,
        check_fields=False)
    u8 = lambda: trav_k.traverse_forest_cuda(
        forest, codes, missing_bin=NB - 1, margins=margins,
        check_fields=False)
    t = [device_ms(f, "ensemble_kernel") for f in (nib, u8, u8, nib)]
    plain_ms = time_ms(lambda: trav_k.traverse_forest_plain(
        forest, packed, NB - 1), reps=3)
    row = traversal_times(forest, packed, (F + 1) // 2, NB - 1, gen)
    row.update(ms=(t[0] + t[3]) / 2, uint8_ms=(t[1] + t[2]) / 2)
    log(f"nibble traversal n={n} F={F}: parity ok  nibble {t[0]:.4f}, "
        f"{t[3]:.4f} ms  uint8 entry {t[1]:.4f}, {t[2]:.4f} ms (device)  "
        f"{row_summary(row)}  plain {plain_ms:.3f} ms")
    return dict(**row, plain_ms=plain_ms, library_ms=None,
                max_abs_err=float((got - want).abs().max()),
                shape=f"n={n} F={F} NB={NB} depth={DEPTH}, "
                f"{ensemble_label(n, F, 1, dev, packed=True)}")


def naive_levels(codes, K: int, gen, dev, label: str):
    """The naive-packing histogram on ``codes`` (n, F) at NN = 1 and 32:
    bit-equal to its plain version and to the grouped kernel on dyadic g,
    h; on real g, h within rtol 1e-5 + 1e-5 node sum|stat| of the float32
    plain version (K = 1), or within rtol 1e-5 of each bin's sum|stat| of a
    float64 sum (K > 1: the cell's two-category codes put so many records
    on one bin that the float32 plain version is itself that far off, as
    ``class_histogram`` says); both kernels timed in turns (naive, grouped,
    grouped, naive).  Returns {NN: (naive ms, grouped ms)}, the largest
    error and the real stats and node ids of NN = 32."""
    from repro_torch.kernels import histogram as hist_k

    (n, F), NB = codes.shape, N_BINS
    shape = (n,) if K == 1 else (K, n)
    g_dy, h_dy = dyadic_stats(shape, gen, dev)
    g, h = real_stats(shape, gen, dev)
    ms, err = {}, 0.0
    for nn in (1, 2 ** (DEPTH - 1)):
        what = f"naive histogram K={K} NN={nn} ({label})"
        nid = torch.randint(0, nn, shape, generator=gen, device=dev,
                            dtype=torch.int32)
        got = hist_k.histogram_naive_cuda(codes, g_dy, h_dy, nid, n_nodes=nn,
                                          n_bins=NB)
        check(torch.equal(got, hist_k.histogram_plain(codes, g_dy, h_dy, nid,
                                                      nn, NB)),
              f"{what} dyadic bit-equal")
        check(torch.equal(got, hist_k.histogram_cuda(codes, g_dy, h_dy, nid,
                                                     n_nodes=nn, n_bins=NB)),
              f"{what} bit-equal to the grouped kernel")
        got = hist_k.histogram_naive_cuda(codes, g, h, nid, n_nodes=nn,
                                          n_bins=NB)
        if K == 1:
            want = hist_k.histogram_plain(codes, g, h, nid, nn, NB)
            mag = hist_k.histogram_plain(codes, g.abs(), h, nid, nn,
                                         NB).sum(dim=-2, keepdim=True)
            check(hist_within_tolerance(got, want, mag),
                  f"{what} within rtol 1e-5 + 1e-5 node sum|stat|")
            err = max(err, float((got - want).abs().max()))
        else:
            want, mag = histogram_f64(codes, g, h, nid, nn, NB)
            e = (got.double() - want).abs()
            check(bool(torch.all(e <= 1e-5 * mag)),
                  f"{what} within rtol 1e-5 of the bin's sum|stat| of a "
                  "float64 sum")
            err = max(err, float(e.max()))
            del e
        del got, want, mag
        naive = lambda: hist_k.histogram_naive_cuda(codes, g, h, nid,
                                                    n_nodes=nn, n_bins=NB)
        grouped = lambda: hist_k.histogram_cuda(codes, g, h, nid, n_nodes=nn,
                                                n_bins=NB)
        t = [time_ms(f) for f in (naive, grouped, grouped, naive)]
        ms[nn] = ((t[0] + t[3]) / 2, (t[1] + t[2]) / 2)
        log(f"{what} n={n} F={F}: parity ok  naive {t[0]:.3f}, {t[3]:.3f} ms"
            f"  grouped {t[1]:.3f}, {t[2]:.3f} ms  naive/grouped "
            f"{ms[nn][0] / ms[nn][1]:.2f} (Fig. 9 on this card)")
    return ms, err, (g, h, nid)


def naive_histogram(n: int, seed: int, dev) -> dict:
    """The naive-packing histogram against its plain version and the
    grouped kernel at the Higgs shape (NN = 1 and 32, ``naive_levels``),
    with the plain version's time, a bincount time and the bound."""
    from repro_torch.kernels import histogram as hist_k

    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    F, NB, nn = N_FIELDS, N_BINS, 2 ** (DEPTH - 1)
    codes = torch.randint(0, NB, (n, F), generator=gen, device=dev,
                          dtype=torch.uint8)
    ms, err, (g, h, nid) = naive_levels(codes, 1, gen, dev, "random codes")
    plain_ms = time_ms(lambda: hist_k.histogram_plain(codes, g, h, nid, nn,
                                                      NB), reps=3)
    # bincount over a precomputed index, as the histogram row times it
    idx = histogram_index(codes, nid, nn, NB)
    lib_ms = time_ms(lambda: bincount_histogram(idx, g, h, nn * F * NB),
                     reps=3)
    del idx
    b_ms, b_by = bound(n * F + 12 * n + nn * F * NB * 8, 2 * n * F)
    log(f"naive histogram NN={nn}: plain {plain_ms:.3f} ms  bincount "
        f"{lib_ms:.3f} ms  bound {b_ms:.3f} ms ({b_by})")
    return dict(ms=ms[nn][0], ms_nn1=ms[1][0], grouped_ms=ms[nn][1],
                grouped_ms_nn1=ms[1][1], plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, max_abs_err=err,
                shape=f"n={n} F={F} NB={NB} NN={nn}, "
                f"{naive_label(n, 1, nn, F, NB)}")


def naive_label(n: int, K: int, NN: int, F: int, NB: int) -> str:
    """The naive kernel's launch at this shape, for a row's ``shape``."""
    from repro_torch.kernels import histogram as hist_k

    geo = hist_k.grouped_geometry(n, K, NN, F, NB,
                                  hist_k.grouped_limits("cuda:0"), naive=True)
    sort = "one slot, no sort" if K * NN == 1 else "counting sort"
    return (f"records sorted by slot ({sort}), {geo.blocks} blocks x "
            f"{geo.n_ftiles} field tile(s) of {geo.field_tile} fields, flat "
            f"[field][bin][2] bins of {geo.smem} B, a thread per record")


def packed_parity(n_higgs: int, seed: int, dev) -> dict:
    """Phase 2c: the kernels that read 4-bit codes, and the naive-packing
    twin.  Returns their kernel rows (without launch counts)."""
    gen = torch.Generator(device=dev).manual_seed(seed + 4)
    codes = torch.randint(0, IOT_BINS, (IOT_RECORDS, IOT_FIELDS),
                          generator=gen, device=dev, dtype=torch.uint8)
    rows = {"histogram_nibble": nibble_histogram(
        codes, 1, (1, 2 ** (DEPTH - 1)), gen, dev, "random codes")}
    del codes
    codes = torch.randint(0, IOT_BINS, (MC_RECORDS, MC_FIELDS), generator=gen,
                          device=dev, dtype=torch.uint8)
    k7 = nibble_histogram(codes, MC_CLASSES, (2 ** (DEPTH - 1),), gen, dev,
                          "random codes")
    del codes
    rows["histogram_nibble"].update(
        ms_k7=k7["ms"], uint8_ms_k7=k7["uint8_ms"], shape_k7=k7["shape"],
        max_abs_err=max(rows["histogram_nibble"]["max_abs_err"],
                        k7["max_abs_err"]))
    part = nibble_partition(IOT_RECORDS + 1, IOT_FIELDS, 1, gen, dev)
    k7 = nibble_partition(MC_RECORDS - 1, MC_FIELDS, MC_CLASSES, gen, dev)
    part.update(ms_k7=k7["ms"], uint8_ms_k7=k7["uint8_ms"],
                wrapper_ms_k7=k7["wrapper_ms"], shape_k7=k7["shape"])
    rows["partition_nibble"] = part
    rows["traversal_nibble"] = nibble_traversal(IOT_RECORDS, IOT_FIELDS, gen,
                                                dev)
    rows["histogram_naive"] = naive_histogram(n_higgs, seed, dev)
    return rows


def naive_fit(config, data, y) -> dict:
    """Phase 3a: a short fit under the naive-packing histogram.  Returns
    its launch counts."""
    import dataclasses

    from repro_torch.api.plan import ExecutionPlan
    from repro_torch.core.gbdt import train
    from repro_torch.kernels import _build

    short = dataclasses.replace(config, n_trees=NAIVE_TREES)
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = train(short, data, y,
                plan=ExecutionPlan(hist_strategy="cuda_packed"))
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    loss = res.history["train_loss"]
    log(f"cuda_packed fit ({NAIVE_TREES} trees): "
        f"{time.perf_counter() - t0:.3f} s  train_loss {loss}  launches "
        f"{json.dumps(counts)}")
    check(counts["histogram_naive"] == DEPTH * NAIVE_TREES
          and counts["histogram"] == 0,
          "cuda_packed: the naive-packing histogram launched once per level")
    check(all(b < a for a, b in zip(loss, loss[1:])),
          "cuda_packed: train loss strictly decreases")
    return counts


def iot_main_path(n: int, n_trees: int, seed: int, dev):
    """Phase 3c: fit and predict an IoT-shaped 16-bin GBDT on 4-bit packed
    codes through the entry points a user calls.  Returns the run's launch
    counts, the median wall time of its steady rounds (ms) and the fit's
    inputs."""
    from repro_torch.core.binning import Binner, PackedCodes
    from repro_torch.core.gbdt import GBDTConfig, train
    from repro_torch.data import paper_dataset
    from repro_torch.kernels import _build

    n_eval = n // 10
    t0 = time.perf_counter()
    X, y, _, spec = paper_dataset("iot", n_override=n + n_eval, seed=seed + 1)
    X = X.astype(np.float32)          # the raw matrix phase 7 streams
    t1 = time.perf_counter()
    binner = Binner(IOT_BINS).fit(X[:n])
    t2 = time.perf_counter()
    data = binner.transform(X[:n])
    ev_data = binner.transform(X[n:])
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    y_tr, y_ev = y[:n], y[n:]
    F = X.shape[1]
    log(f"data: {spec.name} n={n} held-out={n_eval} F={F}  make "
        f"{t1 - t0:.3f} s  Binner.fit {t2 - t1:.3f} s  transform "
        f"{t3 - t2:.3f} s  positives {float(y_tr.mean()):.4f}")
    check(isinstance(data.codes, PackedCodes)
          and tuple(data.codes.data.shape) == (n, (F + 1) // 2)
          and isinstance(data.codes_cm, PackedCodes)
          and tuple(data.codes_cm.data.shape) == (F, (n + 1) // 2)
          and isinstance(ev_data.codes, PackedCodes),
          f"Binner({IOT_BINS}).transform packs both copies")
    log(f"packed codes: row-major {tuple(data.codes.data.shape)} bytes, "
        f"column-major {tuple(data.codes_cm.data.shape)} bytes")
    config = GBDTConfig(n_trees=n_trees, max_depth=DEPTH, learning_rate=0.1,
                        objective="binary:logistic", seed=seed)

    _build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stamps = [t0]           # the loss read ends every round in a sync
    res = train(config, data, y_tr,
                callback=lambda t, m: stamps.append(time.perf_counter()))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ev_margin = res.model.predict_margin(ev_data.codes)
    tr_margin = res.model.predict_margin(data)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = _build.launch_counts()

    loss = res.history["train_loss"]
    log(f"packed train: {t1 - t0:.3f} s  {n * n_trees / (t1 - t0):.1f} "
        f"record-rounds/s  step_times {json.dumps(res.step_times)}")
    log(f"packed train_loss {loss}")
    rounds_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    log("packed round wall ms " + json.dumps([round(r, 3) for r in rounds_ms]))
    log(f"packed predict_margin (held-out + training rows): {t2 - t1:.3f} s")
    log(f"packed launches {json.dumps(counts)}")
    check(counts["histogram_nibble"] == DEPTH * n_trees
          and counts["histogram"] == 0,
          "nibble histogram launched once per level")
    check(counts["partition_nibble"] == DEPTH * n_trees
          and counts["partition"] == 0,
          "nibble partition launched once per level")
    check(counts["split_level"] == DEPTH * n_trees,
          "split search launched once per level")
    check(counts["traversal"] == n_trees, "traversal launched once per tree")
    check(counts["traversal_wide"] == 0 and counts["ensemble_wide"] == 0,
          "step ⑤ and prediction took the staged entry")
    check(counts["ensemble"] >= 1, "ensemble launched")
    check(all(b < a for a, b in zip(loss, loss[1:])),
          "packed train loss strictly decreases")
    acc = float(((ev_margin > 0).cpu().numpy() == (y_ev > 0.5)).mean())
    majority = float(max(y_ev.mean(), 1 - y_ev.mean()))
    log(f"packed held-out accuracy {acc:.6f} vs majority class "
        f"{majority:.6f}")
    check(acc > majority, "packed held-out accuracy beats the majority class")
    check(bool(torch.isfinite(tr_margin).all())
          and tr_margin.shape == (n,), "finite margins of shape (n,)")
    torch.testing.assert_close(tr_margin, res.margins, rtol=1e-5, atol=1e-6)
    log("packed predict_margin on the training rows replays the fit's "
        "margins (rtol 1e-5)")
    step5_ms = step5_device_ms(res.model, data)
    log(f"packed step ⑤ of one round (training rows): {step5_ms:.4f} ms of "
        "device time (torch.profiler, every kernel)")
    steady_ms = statistics.median(rounds_ms[1:] or rounds_ms)
    return counts, steady_ms, step5_ms, (config, data, y_tr), \
        dict(X=X[:n], binner=binner, res=res)


def step5_device_ms(model, data) -> float:
    """Device time of step ⑤ of one round (the first tree's leaves added
    into a copy of the margins), every kernel it runs, from
    ``torch.profiler`` (mean of 3 calls after a warm-up)."""
    from repro_torch.core import gbdt
    from repro_torch.kernels.ref import TreeArrays

    tree = TreeArrays(*[a[0] for a in model.trees])
    margins = torch.zeros((data.n_records,), device=tree.feature.device)
    return device_ms(lambda: gbdt._predict_one_tree(tree, data, None,
                                                    margins), "")


def main_path(n: int, n_trees: int, seed: int, dev):
    """Phase 3: fit and predict a Higgs-shaped GBDT through the entry
    points a user calls.  Returns the run's launch counts, the median
    wall time of its steady rounds (ms) and the fit's inputs."""
    from repro_torch.core.binning import Binner
    from repro_torch.core.gbdt import GBDTConfig, train
    from repro_torch.data import paper_dataset
    from repro_torch.kernels import _build

    n_eval = max(1, n // 10)
    t0 = time.perf_counter()
    X, y, _, spec = paper_dataset("higgs", n_override=n + n_eval, seed=seed)
    X = X.astype(np.float32)          # the raw matrix phase 7 streams
    t1 = time.perf_counter()
    binner = Binner(N_BINS).fit(X[:n])
    t2 = time.perf_counter()
    data = binner.transform(X[:n])
    ev_data = binner.transform(X[n:])
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    y_tr, y_ev = y[:n], y[n:]
    log(f"data: {spec.name} n={n} held-out={n_eval} F={X.shape[1]}  "
        f"make {t1 - t0:.3f} s  Binner.fit {t2 - t1:.3f} s  "
        f"transform {t3 - t2:.3f} s")
    config = GBDTConfig(n_trees=n_trees, max_depth=DEPTH, learning_rate=0.1,
                        objective="binary:logistic", seed=seed)

    _build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stamps = [t0]           # the loss read ends every round in a sync
    res = train(config, data, y_tr,
                callback=lambda t, m: stamps.append(time.perf_counter()))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ev_margin = res.model.predict_margin(ev_data)
    tr_margin = res.model.predict_margin(data)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = _build.launch_counts()

    loss = res.history["train_loss"]
    log(f"train: {t1 - t0:.3f} s  {n * n_trees / (t1 - t0):.1f} "
        f"record-rounds/s  step_times {json.dumps(res.step_times)}")
    log(f"train_loss {loss}")
    rounds_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    log("round wall ms " + json.dumps([round(r, 3) for r in rounds_ms]))
    log(f"predict_margin (held-out + training rows): {t2 - t1:.3f} s")
    log(f"launches {json.dumps(counts)}")
    check(counts["histogram"] == DEPTH * n_trees,
          "histogram launched once per level")
    check(counts["partition"] == DEPTH * n_trees,
          "partition launched once per level")
    check(counts["split_level"] == DEPTH * n_trees,
          "split search launched once per level")
    check(counts["traversal"] == n_trees, "traversal launched once per tree")
    check(counts["traversal_wide"] == 0 and counts["ensemble_wide"] == 0,
          "step ⑤ and prediction took the staged entry")
    check(counts["ensemble"] >= 1, "ensemble launched")
    check(all(b < a for a, b in zip(loss, loss[1:])),
          "train loss strictly decreases")
    acc = float(((ev_margin > 0).cpu().numpy() == (y_ev > 0.5)).mean())
    majority = float(max(y_ev.mean(), 1 - y_ev.mean()))
    log(f"held-out accuracy {acc:.6f} vs majority class {majority:.6f}")
    check(acc > majority, "held-out accuracy beats the majority class")
    check(bool(torch.isfinite(tr_margin).all())
          and tr_margin.shape == (n,), "finite margins of shape (n,)")
    torch.testing.assert_close(tr_margin, res.margins, rtol=1e-5, atol=1e-6)
    log("predict_margin on the training rows replays the fit's margins "
        "(rtol 1e-5)")
    # round 0 carries one-off costs (first use of PyTorch's CUDA modules)
    steady_ms = statistics.median(rounds_ms[1:] or rounds_ms)
    return counts, steady_ms, (config, data, y_tr), \
        dict(X=X[:n], binner=binner, res=res)


def class_histogram(codes, gen, dev, label: str, real_stats: bool) -> dict:
    """The class-batched histogram (K = 7) on ``codes`` (n, F): parity with
    its plain version at NN = 1 and 32, its time at both, and at NN = 32 the
    plain version's time, a ``torch.bincount`` time and the bound.

    Dyadic g, h: bit-equal.  Real g, h: within rtol 1e-5 of each bin's
    sum of |stat| of a float64 sum of the plain version's scatter-add (the
    kernel sums in float32 within a block, then across blocks), with the
    kernel's and the float32 plain version's largest error beside each
    other; with ``real_stats`` also within rtol 1e-5 + 1e-5 node sum|stat|
    of the float32 plain version.  That second check is made on random
    codes only: where the codes put ~290,000 records on one bin, as
    two-category fields do at NN = 1, the plain version's own float32 sum
    in one order differs from float64 by about that tolerance itself."""
    from repro_torch.kernels import histogram as hist_k

    (n, F), NB, K, NN = codes.shape, N_BINS, MC_CLASSES, 2 ** (DEPTH - 1)
    g_dy = torch.randint(-64, 64, (K, n), generator=gen, device=dev) / 64.0
    h_dy = torch.randint(1, 64, (K, n), generator=gen, device=dev) / 64.0
    g = torch.randn((K, n), generator=gen, device=dev)
    h = torch.rand((K, n), generator=gen, device=dev) * 0.9 + 0.1
    err, err64, plain_err64, ms = 0.0, 0.0, 0.0, {}
    for nn in (1, NN):
        nid = torch.randint(0, nn, (K, n), generator=gen, device=dev,
                            dtype=torch.int32)
        got = hist_k.histogram_cuda(codes, g_dy, h_dy, nid, n_nodes=nn,
                                    n_bins=NB)
        check(torch.equal(got, hist_k.histogram_plain(codes, g_dy, h_dy, nid,
                                                      nn, NB)),
              f"class-batched histogram K={K} NN={nn} ({label}) dyadic "
              "bit-equal")
        got = hist_k.histogram_cuda(codes, g, h, nid, n_nodes=nn, n_bins=NB)
        want = hist_k.histogram_plain(codes, g, h, nid, nn, NB)
        want64, mag64 = histogram_f64(codes, g, h, nid, nn, NB)
        e_kernel = (got.double() - want64).abs()
        e_plain = (want.double() - want64).abs()
        check(bool(torch.all(e_kernel <= 1e-5 * mag64)),
              f"class-batched histogram K={K} NN={nn} ({label}) within rtol "
              "1e-5 of the bin's sum|stat| of a float64 sum")
        err64 = max(err64, float(e_kernel.max()))
        plain_err64 = max(plain_err64, float(e_plain.max()))
        log(f"class-batched histogram K={K} NN={nn} ({label}) real stats "
            f"against float64: kernel max abs err {float(e_kernel.max()):.3e}"
            f" (max err / bin sum|stat| "
            f"{float((e_kernel / mag64.clamp(min=1e-30)).max()):.3e}), "
            f"float32 plain version {float(e_plain.max()):.3e} "
            f"({float((e_plain / mag64.clamp(min=1e-30)).max()):.3e})")
        del want64, mag64, e_kernel, e_plain
        if real_stats:
            mag = hist_k.histogram_plain(codes, g.abs(), h, nid, nn,
                                         NB).sum(dim=3, keepdim=True)
            check(hist_within_tolerance(got, want, mag),
                  f"class-batched histogram K={K} NN={nn} ({label}) within "
                  "rtol 1e-5 + 1e-5 node sum|stat|")
            err = max(err, float((got - want).abs().max()))
            del mag
        del got, want
        ms[nn] = time_ms(lambda: hist_k.histogram_cuda(
            codes, g, h, nid, n_nodes=nn, n_bins=NB))
    plain_ms = time_ms(lambda: hist_k.histogram_plain(codes, g, h, nid, NN,
                                                      NB), reps=3)
    # the same function as one bincount per statistic over a precomputed
    # class-aware (slot, field, bin) index
    slot = nid.long() + torch.arange(K, device=dev)[:, None] * NN   # (K, n)
    idx = ((slot[:, :, None] * F + torch.arange(F, device=dev)) * NB
           + codes.long()[None]).reshape(-1)
    wg = g[:, :, None].expand(K, n, F).reshape(-1)
    wh = h[:, :, None].expand(K, n, F).reshape(-1)
    lib_ms = time_ms(lambda: (
        torch.bincount(idx, weights=wg, minlength=K * NN * F * NB),
        torch.bincount(idx, weights=wh, minlength=K * NN * F * NB)), reps=3)
    del slot, idx, wg, wh
    b_ms, b_by = bound(n * F + 12 * K * n + K * NN * F * NB * 8,
                       2 * K * n * F)
    log(f"class-batched histogram K={K} n={n} ({label}): parity ok  kernel "
        f"NN={NN} {ms[NN]:.3f} ms  (NN=1 {ms[1]:.3f} ms)  plain "
        f"{plain_ms:.3f} ms  bincount {lib_ms:.3f} ms  bound {b_ms:.3f} ms "
        f"({b_by})")
    return dict(ms=ms[NN], ms_nn1=ms[1], plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, max_abs_err=err,
                max_abs_err_f64=err64, plain_max_abs_err_f64=plain_err64,
                shape=f"n={n} F={F} NB={NB} K={K} NN={NN}, "
                f"{grouped_label(n, K, NN, F, NB)}, {label}")


def class_parity(n: int, seed: int, dev) -> dict:
    """Phase 2b: each class-batched kernel against its plain version at the
    multi-class path's shapes.  Returns the kernel rows (without launch
    counts), named ``<kernel>_classes``."""
    from repro_torch.kernels import partition as part_k
    from repro_torch.kernels import traversal as trav_k

    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    F, NB, K, NN = MC_FIELDS, N_BINS, MC_CLASSES, 2 ** (DEPTH - 1)
    codes = torch.randint(0, NB, (n, F), generator=gen, device=dev,
                          dtype=torch.uint8)
    codes_cm = codes.T.contiguous()
    rows = {}
    shape = f"n={n} F={F} NB={NB} K={K}"

    # -- histogram on random codes; its row is timed on the multi-class
    # path's own codes (phase 3b)
    rand = class_histogram(codes, gen, dev, "random codes", True)
    rows["histogram_classes"] = dict(
        max_abs_err=rand["max_abs_err"], ms_random_codes=rand["ms"],
        ms_random_codes_nn1=rand["ms_nn1"],
        max_abs_err_f64_random_codes=rand["max_abs_err_f64"])
    nid = torch.randint(0, NN, (K, n), generator=gen, device=dev,
                        dtype=torch.int32)

    # -- partition: the column-major entry, one launch for all classes ----
    split = [torch.randint(lo, hi, (K, NN), generator=gen, device=dev,
                           dtype=torch.int32)
             for lo, hi in ((-1, F), (0, NB), (0, 2), (0, 2))]
    got = part_k.partition_cm_cuda(nid, codes_cm, *split,
                                   missing_bin=NB - 1)
    want = part_k.partition_cm_plain(nid, codes_cm, *split, NB - 1)
    check(torch.equal(got, want), "class-batched partition bit-equal")
    plain_ms = time_ms(lambda: part_k.partition_cm_plain(
        nid, codes_cm, *split, NB - 1), reps=3)
    rows["partition_classes"] = dict(
        **partition_times(lambda: part_k.partition_cm_cuda(
            nid, codes_cm, *split, missing_bin=NB - 1), nid, split[0], n,
            False),
        plain_ms=plain_ms, library_ms=None,
        max_abs_err=float((got - want).abs().max()),
        shape=f"{shape} NN={NN}")
    log(f"class-batched partition K={K} NN={NN} n={n}: parity ok  "
        f"{row_summary(rows['partition_classes'])}  plain {plain_ms:.3f} ms")
    del got, want

    # -- traversal: one round's K trees over the shared codes --------------
    forest = random_trees(K, F, gen, dev)
    got = trav_k.traverse_forest_cuda(forest, codes, missing_bin=NB - 1)
    want = trav_k.traverse_forest_plain(forest, codes, NB - 1)
    check(got.shape == (n, K) and torch.equal(got, want),
          "class-batched traversal bit-equal")
    margins = torch.randn((n, K), generator=gen, device=dev)
    expect = margins + want
    check(torch.equal(trav_k.traverse_forest_cuda(
        forest, codes, missing_bin=NB - 1, margins=margins), expect),
          "class-batched traversal into the margins bit-equal to "
          "margins + leaf")
    plain_ms = time_ms(lambda: trav_k.traverse_forest_plain(forest, codes,
                                                            NB - 1), reps=3)
    rows["traversal_classes"] = dict(
        **traversal_times(forest, codes, F, NB - 1, gen),
        plain_ms=plain_ms, library_ms=None,
        max_abs_err=float((got - want).abs().max()),
        shape=f"{shape} depth={DEPTH}, {ensemble_label(n, F, K, dev)}")
    log(f"class-batched traversal K={K} n={n}: parity ok  "
        f"{row_summary(rows['traversal_classes'])}  plain {plain_ms:.3f} ms")

    # -- ensemble: 72 rounds x 7 classes, tree t feeds column t % 7 --------
    T, n_words = MC_ROUNDS_TIMED * K, 2 ** (DEPTH + 1) - 1
    trees = random_trees(T, F, gen, dev)
    got = trav_k.predict_ensemble_cuda(trees, codes, missing_bin=NB - 1,
                                       n_classes=K)
    want = trav_k.predict_ensemble_plain(trees, codes, NB - 1, n_classes=K)
    err = (got - want).abs()
    check(got.shape == (n, K) and bool(torch.all(err <= 1e-5 * want.abs())),
          "multi-class ensemble within rtol 1e-5 (dyadic leaves: exact)")
    ms = time_ms(lambda: trav_k.predict_ensemble_cuda(
        trees, codes, missing_bin=NB - 1, n_classes=K))
    plain_ms = time_ms(lambda: trav_k.predict_ensemble_plain(
        trees, codes, NB - 1, n_classes=K), reps=1)
    hops = n * T * DEPTH
    b_ms, b_by = bound(n * F + 4 * n * K + 4 * T * n_words,
                       hops * OPS_PER_HOP)
    real = ensemble_real_leaves(trees, codes, K, gen, dev,
                                "multi-class ensemble")
    rows["ensemble_classes"] = dict(
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, max_abs_err=float(err.max()),
        shape=f"{shape} T={T} depth={DEPTH}, {ensemble_label(n, F, T, dev)}",
        bytes_bound_ms=(n * F + 4 * n * K + 4 * T * n_words)
        / HBM_BYTES_PER_S * 1e3, **real)
    log(f"multi-class ensemble K={K} n={n} T={T}: parity ok  kernel "
        f"{ms:.3f} ms  plain {plain_ms:.3f} ms  bound {b_ms:.3f} ms "
        f"({b_by}; {hops:.3g} hops)")
    return rows


SPLIT_OPS_PER_BIN = 20           # prefix sums of G and H; the gain both ways


def _host_us(fn, reps: int) -> float:
    """Mean host-clock time of ``fn`` in microseconds over ``reps`` calls
    issued back to back, no sync between them (what a level costs the
    host's loop); a warm-up and a sync first."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def split_parity(seed: int, dev) -> dict:
    """Phase 2d: the split-search kernel against its plain version at the
    deepest level of the Higgs- and Covertype-shaped paths.  Returns its
    kernel row (without launch counts); ``*_k7`` keys hold Covertype's."""
    from repro_torch.core import splits as splits_mod
    from repro_torch.core import tree as tree_mod

    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    nn, row = 2 ** (DEPTH - 1), {}
    for sfx, K, F, n_cat in (("", 1, N_FIELDS, 0),
                             ("_k7", MC_CLASSES, MC_FIELDS, MC_BINARY)):
        lead, NB = (K, nn), N_BINS
        is_cat = torch.arange(F, device=dev) >= F - n_cat
        mask = torch.ones(F, dtype=torch.bool, device=dev)
        dy = torch.stack([
            torch.randint(-64, 64, lead + (F, NB), generator=gen,
                          device=dev) / 64.0,
            torch.randint(0, 64, lead + (F, NB), generator=gen,
                          device=dev) / 64.0], -1).float()
        real = torch.stack([
            torch.randn(lead + (F, NB), generator=gen, device=dev),
            torch.rand(lead + (F, NB), generator=gen, device=dev)], -1)
        err = 0.0
        for hist, exact in ((dy, True), (real, False)):
            args = (hist.reshape(K * nn, F, NB, 2), is_cat, mask, 1.0, 0.0,
                    1.0)
            got = splits_mod.find_best_splits(*args)
            want = splits_mod.find_best_splits_plain(*args)
            if exact:
                for name, a, b in zip(want._fields, got, want):
                    check(torch.equal(a, b),
                          f"split_level{sfx} {name} dyadic bit-equal")
            else:
                err = float((got.gain - want.gain).abs().max())
        states = [(torch.full((K, 2 ** DEPTH - 1), -1, dtype=torch.int32,
                              device=dev),
                   *[torch.zeros((K, 2 ** DEPTH - 1), dtype=torch.int32,
                                 device=dev) for _ in range(3)],
                   torch.zeros((K, 2 ** DEPTH), device=dev),
                   torch.zeros((K, 2 ** DEPTH), dtype=torch.bool,
                               device=dev)) for _ in range(2)]
        fold = dict(is_cat_field=is_cat, field_mask=mask, lambda_=1.0,
                    gamma=0.0, min_child_weight=1.0)
        fused, _, _ = tree_mod._decide_level(dy, DEPTH - 1, DEPTH, states[0],
                                             *fold.values())
        plain, _, _ = tree_mod._decide_level(
            dy, DEPTH - 1, DEPTH, states[1], *fold.values(),
            find=splits_mod.find_best_splits_plain)
        check(all(torch.equal(a, b) for a, b in zip(fused, plain)),
              f"split_level{sfx} fold: the six tables bit-equal")
        args = (real.reshape(K * nn, F, NB, 2), is_cat, mask, 1.0, 0.0, 1.0)
        level = lambda: tree_mod._decide_level(real, DEPTH - 1, DEPTH,
                                               fused, *fold.values())
        plain_level = lambda: tree_mod._decide_level(
            real, DEPTH - 1, DEPTH, plain, *fold.values(),
            find=splits_mod.find_best_splits_plain)
        KNN = K * nn
        b_ms, b_by = bound(8 * KNN * F * NB + 32 * KNN,
                           SPLIT_OPS_PER_BIN * KNN * F * NB)
        part = {"ms": device_ms(lambda: splits_mod.find_best_splits(*args),
                                "split_level_kernel"),
                "fold_ms": device_ms(level, "split_level_kernel"),
                "plain_ms": time_ms(lambda: splits_mod.find_best_splits_plain(
                    *args)),
                "plain_level_ms": time_ms(plain_level),
                "bound_ms": b_ms, "bound_by": b_by,
                "host_us": _host_us(level, 200),
                "plain_host_us": _host_us(plain_level, 20),
                "max_abs_err": err,
                "shape": f"K={K} NN={nn} F={F} NB={NB} categorical={n_cat}"}
        row.update({k + sfx: v for k, v in part.items()})
        log(f"split_level{sfx} {part['shape']}: parity ok (search, fold)  "
            f"kernel {part['ms']:.4f} ms (with fold {part['fold_ms']:.4f})  "
            f"plain {part['plain_ms']:.3f} ms (level "
            f"{part['plain_level_ms']:.3f})  bound {b_ms:.4f} ms ({b_by})  "
            f"host a level {part['host_us']:.1f} us against "
            f"{part['plain_host_us']:.1f} us; real-stat gain diff {err:.3g}")
    row["library_ms"] = None
    return row


def mc_main_path(n: int, n_rounds: int, seed: int, dev):
    """Phase 3b: fit and predict a Covertype-shaped multi-class GBDT
    through the entry points a user calls.  Returns the run's launch
    counts, the median wall time of its steady rounds (ms) and the fit's
    inputs."""
    from repro_torch.core.binning import Binner
    from repro_torch.core.gbdt import GBDTConfig, train
    from repro_torch.data import make_tabular
    from repro_torch.kernels import _build

    K = MC_CLASSES
    n_eval = max(1, n // 10)
    t0 = time.perf_counter()
    X, y, cats = make_tabular(n + n_eval, MC_NUMERIC, MC_BINARY, n_cats=2,
                              task="multiclass", n_classes=K, seed=seed)
    X = X.astype(np.float32)          # the raw matrix phase 7 streams
    t1 = time.perf_counter()
    binner = Binner(N_BINS, categorical_fields=cats).fit(X[:n])
    t2 = time.perf_counter()
    data = binner.transform(X[:n], device=dev)
    ev_data = binner.transform(X[n:], device=dev)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    y_tr, y_ev = y[:n], y[n:]
    counts_ev = [int((y_ev == k).sum()) for k in range(K)]
    log(f"data: Covertype-shaped n={n} held-out={n_eval} F={X.shape[1]} "
        f"({len(cats)} categorical) K={K}  make {t1 - t0:.3f} s  "
        f"Binner.fit {t2 - t1:.3f} s  transform {t3 - t2:.3f} s  "
        f"held-out class counts {counts_ev}")
    config = GBDTConfig(n_trees=n_rounds, max_depth=DEPTH, learning_rate=0.1,
                        objective="multi:softmax", n_classes=K, seed=seed)

    _build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stamps = [t0]           # the loss read ends every round in a sync
    res = train(config, data, y_tr, device=dev,
                callback=lambda t, m: stamps.append(time.perf_counter()))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ev_margin = res.model.predict_margin(ev_data)
    tr_margin = res.model.predict_margin(data)
    ev_prob = res.model.predict(ev_data)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = _build.launch_counts()

    loss = res.history["train_loss"]
    log(f"multi-class train: {t1 - t0:.3f} s  {n * n_rounds / (t1 - t0):.1f}"
        f" record-rounds/s  ({K} trees a round)  step_times "
        f"{json.dumps(res.step_times)}")
    log(f"multi-class train_loss {loss}")
    rounds_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    log("multi-class round wall ms "
        + json.dumps([round(r, 3) for r in rounds_ms]))
    log(f"multi-class predict_margin x2 + predict: {t2 - t1:.3f} s")
    log(f"multi-class launches {json.dumps(counts)}")
    check(res.model.n_trees == K * n_rounds and res.model.n_rounds == n_rounds,
          f"{K} trees a round")
    check(counts["histogram"] == DEPTH * n_rounds,
          "class-batched histogram launched once per level")
    check(counts["partition"] == DEPTH * n_rounds,
          "class-batched partition launched once per level")
    check(counts["split_level"] == DEPTH * n_rounds,
          "split search launched once per level (all classes)")
    check(counts["traversal"] == n_rounds,
          "class-batched traversal launched once per round")
    check(counts["traversal_wide"] == 0 and counts["ensemble_wide"] == 0,
          "step ⑤ and prediction took the staged entry")
    check(counts["ensemble"] >= 1, "multi-class ensemble launched")
    check(all(b < a for a, b in zip(loss, loss[1:])),
          "multi-class train loss strictly decreases")
    y_ev_t = torch.as_tensor(y_ev, device=dev).long()
    acc = float((ev_margin.argmax(dim=1) == y_ev_t).float().mean())
    majority = max(counts_ev) / len(y_ev)
    log(f"multi-class held-out accuracy {acc:.6f} vs majority class "
        f"{majority:.6f}")
    check(acc > majority, "held-out argmax accuracy beats the majority class")
    check(bool(torch.isfinite(tr_margin).all())
          and tr_margin.shape == (n, K), f"finite margins of shape (n, {K})")
    torch.testing.assert_close(tr_margin, res.margins, rtol=1e-5, atol=1e-6)
    log("predict_margin on the training rows replays the fit's (n, 7) "
        "margins (rtol 1e-5)")
    torch.testing.assert_close(ev_prob.sum(dim=1),
                               torch.ones(n_eval, device=dev), rtol=1e-5,
                               atol=1e-5)
    log("predict rows sum to 1")
    steady_ms = statistics.median(rounds_ms[1:] or rounds_ms)
    return counts, steady_ms, (config, data, y_tr), \
        dict(X=X[:n], binner=binner, res=res)


def _host_ms(fn, reps: int = 20) -> float:
    """Median host-clock time of ``fn`` with a sync on each side (after a
    warm-up): what a caller waits for one call."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def serving_path(seed: int, dev, smi: str) -> dict:
    """Phase 5: the serving path through the entry points a user calls.
    Returns the ``serve_*`` keys of the ensemble row."""
    import shutil
    import threading

    from repro_torch.api import (BoosterClassifier, ExecutionPlan,
                                 ModelRegistry, Server, warmup_buckets)
    from repro_torch.core import gbdt as gbdt_mod
    from repro_torch.core import inference
    from repro_torch.data import paper_dataset
    from repro_torch.kernels import _build

    n, n_req = SERVE_RECORDS, SERVE_HELD_OUT
    t_phase = t0 = time.perf_counter()
    X, y, _, spec = paper_dataset("higgs", n_override=n + n_req, seed=seed)
    X_tr, y_tr, X_req = X[:n], y[:n], X[n:].astype(np.float32)
    log(f"serve data: {spec.name} n={n} requests drawn from {n_req} "
        f"held-out records  make {time.perf_counter() - t0:.3f} s")
    kw = dict(max_depth=DEPTH, max_bins=N_BINS, learning_rate=0.1,
              seed=seed)
    bundles = ROOT / "build" / "smoke_bundles"
    shutil.rmtree(bundles, ignore_errors=True)
    _build.reset_launch_counts()
    try:
        # 1-2: fit, save, load
        t0 = time.perf_counter()
        v1 = BoosterClassifier(n_trees=SERVE_TREES, **kw).fit(X_tr, y_tr)
        t1 = time.perf_counter()
        path = str(bundles / "v1")
        v1.save(path)
        v1 = BoosterClassifier.load(path)
        t2 = time.perf_counter()
        log(f"serve fit {SERVE_TREES} trees {t1 - t0:.3f} s (Binner.fit "
            f"included)  save + load {t2 - t1:.3f} s")
        # 3: warm start of 8 more trees from the bundle; the margins it
        # replays are recorded as train() computes them
        replayed = []
        replay = gbdt_mod._replay_margins

        def recording(*args):
            margins = replay(*args)
            replayed.append(margins.clone())    # train adds into margins
            return margins

        gbdt_mod._replay_margins = recording
        try:
            t0 = time.perf_counter()
            v2 = BoosterClassifier(n_trees=SERVE_TREES, **kw).fit(
                X_tr, y_tr, xgb_model=path)
            warm_s = time.perf_counter() - t0
        finally:
            gbdt_mod._replay_margins = replay
        data = v1.binner_.transform(X_tr)
        direct = v1.model_.predict_margin(data)
        check(len(replayed) == 1 and torch.equal(replayed[0], direct),
              "the warm start's replayed margins are bit-equal to v1's "
              "direct predict_margin")
        check(all(torch.equal(getattr(v2.model_.trees, f)[:SERVE_TREES],
                              getattr(v1.model_.trees, f))
                  for f in ("feature", "threshold", "is_cat",
                            "default_left", "leaf_value")),
              "the warm-started model's first 8 trees are v1's")
        loss = v2.history_["train_loss"]
        check(len(loss) == SERVE_TREES
              and all(b < a for a, b in zip(loss, loss[1:])),
              "the warm start's train loss falls every round")
        # the same 16 rounds in one go, on the same codes (the binner is
        # v1's), for information
        one = gbdt_mod.train(gbdt_mod.GBDTConfig(
            n_trees=2 * SERVE_TREES, max_depth=DEPTH, learning_rate=0.1,
            objective="binary:logistic", seed=seed), data, y_tr).model
        same = all(torch.equal(getattr(one.trees, f),
                               getattr(v2.model_.trees, f))
                   for f in ("feature", "leaf_value"))
        log(f"serve warm start {SERVE_TREES} more trees {warm_s:.3f} s  "
            f"train_loss {loss}  (for information, not a gate: a "
            f"{2 * SERVE_TREES}-tree fit in one go on the same codes "
            f"{'is' if same else 'is not'} bit-equal to it; the card's "
            "histogram and leaf settling add with atomics in no fixed "
            "order)")
        del data, direct, replayed, one
        counts = _build.launch_counts()
        fit_trees = 4 * SERVE_TREES     # v1, the warm start, the one-go fit
        others = ("histogram_nibble", "histogram_naive", "partition_nibble",
                  "traversal_wide", "ensemble_wide")
        check(counts["histogram"] == counts["partition"] == DEPTH * fit_trees
              and counts["traversal"] == fit_trees + SERVE_TREES
              and all(counts[k] == 0 for k in others),
              f"the fits launched the histogram and the partition {DEPTH} x "
              f"{fit_trees} times, the traversal {fit_trees} + "
              f"{SERVE_TREES} replayed rounds, no other entry "
              f"({json.dumps(counts)})")
        path2 = str(bundles / "v2")
        v2.save(path2)

        # 4-5: publish v1, warm a server over every bucket a flush reaches
        registry = ModelRegistry()
        registry.publish("higgs", path)
        p1 = registry.pipeline("higgs")
        cache = registry.entry("higgs").cache
        buckets = warmup_buckets(SERVE_BATCH)
        check(buckets == [128, 256, 512, 1024, 2048, 4096],
              "warmup_buckets(4096) is 128 ... 4096")
        rng = np.random.default_rng(seed)
        sizes = np.clip(np.exp(rng.uniform(0, np.log(SERVE_BATCH),
                                           SERVE_REQUESTS)).astype(int),
                        1, SERVE_BATCH)
        starts = rng.integers(0, n_req - SERVE_BATCH, SERVE_REQUESTS)
        slack = rng.uniform(0, 5, SERVE_REQUESTS)
        answers = [None] * SERVE_REQUESTS
        times = [None] * SERVE_REQUESTS           # (submitted, completed)
        half = threading.Event()

        def clients(srv, slack, answers, times):
            """SERVE_CLIENTS threads send the requests, each waiting for its
            answer before it sends the next; ``half`` is set halfway."""
            done = [0]
            lock = threading.Lock()

            def client(c):
                for i in range(c, SERVE_REQUESTS, SERVE_CLIENTS):
                    rows = X_req[starts[i]:starts[i] + sizes[i]]
                    sent = time.perf_counter()
                    req = srv.submit("higgs", rows, slack_ms=slack[i])
                    answers[i] = req.result(timeout=300)
                    times[i] = (sent, time.perf_counter())
                    with lock:
                        done[0] += 1
                        if done[0] == SERVE_REQUESTS // 2:
                            half.set()

            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(SERVE_CLIENTS)]
            for t in threads:
                t.start()
            return threads

        with Server(registry, max_batch=SERVE_BATCH) as srv:
            launches0 = _build.launch_counts()
            t0 = time.perf_counter()
            warm = srv.warmup("higgs")
            warm_s = time.perf_counter() - t0
            launches1 = _build.launch_counts()
            check(warm == len(buckets) == cache.stats()["traces"],
                  "warm-up captured one graph per bucket")
            before = cache.stats()

            # 6: 256 requests from 4 client threads; v2 hot-swapped
            # meanwhile
            t0 = time.perf_counter()
            threads = clients(srv, slack, answers, times)
            half.wait(timeout=300)
            swap_start = time.perf_counter()
            traces0 = cache.stats()["traces"]
            version = registry.publish("higgs", path2)
            swap_end = time.perf_counter()
            publish_captures = cache.stats()["traces"] - traces0
            for t in threads:
                t.join()
            serve_s = time.perf_counter() - t0
            launches2 = _build.launch_counts()
            stats = srv.stats()["higgs"]
            health = srv.health()
            after = cache.stats()
        p2 = registry.pipeline("higgs")
        check(version == 2 and p2.model.n_trees == 2 * SERVE_TREES,
              "publish hot-swapped v2")

        # gates: each answer is the direct predict of its own rows by the
        # version that served it, and its plain version's on the card;
        # captures only in warm-up and publish
        plain_plan = ExecutionPlan(traversal_strategy="reference")
        served, worst = {1: 0, 2: 0}, 0.0
        for i in range(SERVE_REQUESTS):
            rows = X_req[starts[i]:starts[i] + sizes[i]]
            got = torch.as_tensor(answers[i])
            want = {v: p.predict(rows, mode="direct").cpu()
                    for v, p in ((1, p1), (2, p2))}
            match = [v for v in (1, 2) if torch.equal(got, want[v])]
            check(bool(match), f"request {i} ({sizes[i]} rows) equals a "
                  "version's direct predict bit for bit")
            plain = (p1, p2)[match[0] - 1].predict(rows, mode="direct",
                                                   plan=plain_plan).cpu()
            check(torch.equal(got, plain), f"request {i} equals its "
                  "version's plain predict on the card bit for bit")
            if times[i][1] < swap_start:
                check(1 in match, f"request {i}, done before publish, was "
                      "served by v1")
            if times[i][0] > swap_end:
                check(2 in match, f"request {i}, sent after publish, was "
                      "served by v2")
            served[match[0]] += 1
            worst = max(worst, min(float((got - want[v]).abs().max())
                                   for v in match))
        flushes = stats["flushes"]
        replays = after["replays"] - before["replays"]
        check(publish_captures == len(buckets)
              and after["traces"] == before["traces"] + publish_captures,
              "no capture while serving: only the warm-up's and publish's")
        check(replays == flushes + len(buckets),
              "one replay a flush (and one a bucket publish warmed)")
        # a capture counts two launches (its eager first run and the
        # captured one); a replay launches nothing through a wrapper
        moved = [{k: b[k] - a[k] for k in a if b[k] != a[k]}
                 for a, b in ((launches0, launches1),
                              (launches1, launches2))]
        check(moved == [{"ensemble": 2 * warm},
                        {"ensemble": 2 * publish_captures}],
              f"no launch while serving but the captures' ({moved})")
        check(stats["requests"] == SERVE_REQUESTS and stats["dropped"] == 0
              and stats["shed"] == 0 and stats["deadline_failures"] == 0
              and health.failed_requests == 0,
              "no request dropped or failed")
        log(f"serve: {SERVE_REQUESTS} requests ({int(sizes.sum())} rows, "
            f"{SERVE_CLIENTS} clients) in {serve_s:.3f} s; {flushes} "
            f"flushes, {replays} graph replays, captures: warm-up {warm} "
            f"({warm_s:.3f} s), publish {publish_captures} "
            f"({swap_end - swap_start:.3f} s), serving 0; served by v1 "
            f"{served[1]}, v2 {served[2]}; largest difference from the "
            f"direct predict {worst}; fit launches {json.dumps(counts)}")
        log(f"serve latency (slack 0-5 ms, hot swap) p50 "
            f"{stats['p50_ms']:.3f} ms  p99 {stats['p99_ms']:.3f} ms  batch "
            f"fill {stats['batch_fill']:.3f}  [{smi}]")

        # the system's own share of the latency: the same requests at
        # slack 0 (each flushed as soon as the server takes it), v2 live
        answers0 = [None] * SERVE_REQUESTS
        before0 = cache.stats()
        with Server(registry, max_batch=SERVE_BATCH) as srv:
            for t in clients(srv, np.zeros(SERVE_REQUESTS), answers0,
                             [None] * SERVE_REQUESTS):
                t.join()
            stats0 = srv.stats()["higgs"]
        after0 = cache.stats()
        check(after0["traces"] == before0["traces"]
              and after0["replays"] - before0["replays"]
              == stats0["flushes"],
              "slack 0: no capture, one replay a flush")
        for i in range(SERVE_REQUESTS):
            rows = X_req[starts[i]:starts[i] + sizes[i]]
            check(torch.equal(torch.as_tensor(answers0[i]),
                              p2.predict(rows, mode="direct").cpu()),
                  f"slack 0: request {i} equals v2's direct predict")
        log(f"serve latency (slack 0) p50 {stats0['p50_ms']:.3f} ms  p99 "
            f"{stats0['p99_ms']:.3f} ms  {stats0['flushes']} flushes  "
            f"batch fill {stats0['batch_fill']:.3f}  [{smi}]")

        # each bucket's graph, for both versions, against the plain version
        # on the card; then replay (copy-in, replay, copy-out) against the
        # direct eager call
        step = next(iter(cache._steps.values()))
        replay_ms, direct_ms = {}, {}
        for b in buckets:
            codes = p2.binner.transform_codes_device(
                X_req[:b], device=p2.device)
            for model in (p1.model, p2.model):
                tables = inference._model_tables(model, model.n_trees)
                graph = step._graphs[(b, model.n_trees, N_FIELDS)]
                check(torch.equal(graph.run(tables, codes, b)[:, 0],
                                  model.predict_margin(codes,
                                                       plan=plain_plan)),
                      f"the graph of {b} rows and {model.n_trees} trees "
                      "equals the plain version on the card bit for bit")
            replay_ms[b] = _host_ms(lambda: graph.run(tables, codes, b))
            direct_ms[b] = _host_ms(lambda: p2.model.predict_margin(codes))
            log(f"serve bucket {b:5d}: graph replay {replay_ms[b]:.4f} ms  "
                f"direct eager call {direct_ms[b]:.4f} ms  [{smi}]")
        registry.unpublish("higgs")
        log(f"serve phase: {time.perf_counter() - t_phase:.1f} s")
    finally:
        shutil.rmtree(bundles, ignore_errors=True)
    return dict(serve_p50_ms=stats["p50_ms"], serve_p99_ms=stats["p99_ms"],
                serve_slack0_p50_ms=stats0["p50_ms"],
                serve_slack0_p99_ms=stats0["p99_ms"],
                serve_replay_ms=replay_ms, serve_direct_ms=direct_ms,
                serve_requests=SERVE_REQUESTS, serve_flushes=flushes,
                serve_replays=replays, serve_captures=warm
                + publish_captures, serve_max_abs_diff=worst,
                serve_card=smi)


def round_breakdown(label: str, config, data, y, steady_ms: float):
    """Phase 4: device time by kernel over a one-round fit, set against the
    wall time of a steady round of a main path (``steady_ms``, profiler
    off), and the host operations that take the most time.  Returns the
    round's device ms (host-to-device copies left out), None where the
    profiler saw no device time."""
    import dataclasses

    from repro_torch.core.gbdt import train

    one = dataclasses.replace(config, n_trees=1)
    train(one, data, y)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        train(one, data, y)
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = sorted(((_device_us(e), e.key, e.count) for e in events
                      if "CUDA" in str(getattr(e, "device_type", ""))
                      and _device_us(e) > 0), reverse=True)
    if not kernels:
        log(f"{label} round breakdown: torch.profiler reported no device "
            "time")
        return None
    total = sum(t for t, _, _ in kernels)
    # host-to-device copies are the fit's one-off label upload
    per_round = sum(t for t, key, _ in kernels if "Memcpy HtoD" not in key)
    log(f"{label} round breakdown (one-round fit, torch.profiler): "
        f"device total "
        f"{total / 1e3:.3f} ms, {per_round / 1e3:.3f} ms without "
        f"host-to-device copies; steady round wall {steady_ms:.3f} ms -> "
        f"device idle share {1 - per_round / 1e3 / steady_ms:.3f}")
    for t, key, cnt in kernels[:12]:
        log(f"  {t / 1e3:10.3f} ms  x{cnt:<4d} {key[:90]}")
    host = sorted(((e.self_cpu_time_total, e.key, e.count) for e in events
                   if "CPU" in str(getattr(e, "device_type", ""))),
                  reverse=True)
    log(f"{label} host operations by self time:")
    for t, key, cnt in host[:10]:
        log(f"  {t / 1e3:10.3f} ms  x{cnt:<4d} {key[:90]}")
    return per_round / 1e3


# phase 6, the training variants
LOSSGUIDE_LEAVES, LOSSGUIDE_TREES = 32, 4
GOSS_TOP, GOSS_OTHER = 0.2, 0.1
MC_FUSED_ROUNDS = 4


def stamped_fit(config, data, y, plan=None):
    """``train`` with a synced stamp at every round's end.  Returns the
    result, the fit's wall time (s) and its round wall times (ms)."""
    from repro_torch.core.gbdt import train

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stamps = [t0]

    def stamp(t, m):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    res = train(config, data, y, plan=plan, callback=stamp)
    torch.cuda.synchronize()
    return (res, time.perf_counter() - t0,
            [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])])


def device_by_kernel(fn, reps: int = 3) -> dict:
    """Device ms a call of ``fn`` spends in each kernel (``torch.profiler``,
    mean of ``reps`` calls after a warm-up); empty where the profiler saw
    no device time."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if "CUDA" in str(getattr(e, "device_type", "")) and _device_us(e) > 0:
            out[e.key] = out.get(e.key, 0.0) + _device_us(e) / reps / 1e3
    return out


def idle_share(device_ms, wall_ms):
    return None if device_ms is None else 1 - device_ms / wall_ms


HOLD_CYCLES = 20_000_000          # ~10 ms of the card's clock


def busy_ms(fn, reps: int = 5) -> float:
    """Device ms of a call of ``fn`` (median of ``reps`` after a warm-up):
    CUDA events around it, enqueued behind a ~10 ms sleep kernel, so the
    host has queued all of ``fn``'s launches before the card reaches them
    and the span holds no host time."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def hist_event_ms(fn, reps: int = 5) -> float:
    """Device ms that a call of ``fn`` spends in the grouped histogram's
    launches (its counting sort and zeroed output included): CUDA events
    around each ``histogram_cuda`` call, summed over the call, behind a
    sleep kernel as in :func:`busy_ms`; median of ``reps`` calls after a
    warm-up."""
    from repro_torch.kernels import histogram as hist_k

    real, spans = hist_k.histogram_cuda, []

    def timed(*a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*a, **kw)
        end.record()
        spans.append((start, end))
        return out

    fn()
    hist_k.histogram_cuda = timed
    try:
        totals = []
        for _ in range(reps):
            spans.clear()
            torch.cuda._sleep(HOLD_CYCLES)
            fn()
            torch.cuda.synchronize()
            totals.append(sum(a.elapsed_time(b) for a, b in spans))
    finally:
        hist_k.histogram_cuda = real
    return statistics.median(totals)


def tree_parity(a, b, what: str, rtol: float = 1e-4,
                atol: float = 1e-5) -> None:
    """``repro``'s subtraction contract: feature, threshold and is_cat
    exact, leaves within rtol plus atol."""
    for field in ("feature", "threshold", "is_cat"):
        check(torch.equal(getattr(a, field), getattr(b, field)),
              f"{what}: {field} equal")
    check(bool(torch.all((a.leaf_value - b.leaf_value).abs()
                         <= atol + rtol * b.leaf_value.abs())),
          f"{what}: leaves within rtol {rtol}, atol {atol}")


def grower_args(data, dev) -> dict:
    """The growers' keywords for a depth-6 tree over ``data``'s fields."""
    return dict(depth=DEPTH, n_bins=data.n_bins, missing_bin=data.missing_bin,
                is_cat_field=data.is_categorical.to(dev),
                field_mask=torch.ones(data.n_fields, dtype=torch.bool,
                                      device=dev),
                lambda_=1.0, gamma=0.0, min_child_weight=1.0)


def level_ids(codes, codes_cm, g, h, data, plan):
    """One tree grown from (K, n) statistics and each level's node ids:
    ``ids[l]`` routes the records of level l + 1, ``ids[-1]`` holds the
    final leaf slots."""
    from repro_torch.core import tree as tree_mod
    from repro_torch.kernels import ops

    ids, real = [], ops.partition_level_cm

    def spy(*a, **kw):
        ids.append(real(*a, **kw))
        return ids[-1]

    ops.partition_level_cm = spy
    try:
        tree = tree_mod.fit_forest(codes, codes_cm, g, h, plan=plan,
                                   **grower_args(data, g.device))
    finally:
        ops.partition_level_cm = real
    return tree, ids


def exact_grid(shape, gen, dev):
    """g in [-1, 1] and h in (0, 1] on a 1/m grid, m the largest power of
    two with n·m <= 2^24 (n = shape[-1]): every partial sum of any subset
    of the records is exact in float32, in any order."""
    m = 1 << max(0, ((1 << 24) // shape[-1]).bit_length() - 1)
    return (torch.randint(-m, m + 1, shape, generator=gen, device=dev) / m,
            torch.randint(1, m + 1, shape, generator=gen, device=dev) / m)


def subtraction_levels(data, K: int, gen, dev, label: str) -> dict:
    """The subtraction's step ① at each level >= 1 of a tree grown on the
    path's own codes, against the direct pass (CUDA events behind a sleep
    kernel, :func:`busy_ms`): the histogram's device time (grouped kernel
    and its sort) in each, the
    whole step's (counts, compaction or masking, combine), and parity
    (6f): on exact-grid statistics the subtraction's level histogram
    equals the direct pass and its plain version bit for bit."""
    from repro_torch.api.plan import ExecutionPlan
    from repro_torch.core import tree as tree_mod
    from repro_torch.kernels import ops

    plan = ExecutionPlan().resolved()
    plain = ExecutionPlan(hist_strategy="reference").resolved()
    n = data.n_records
    g, h = exact_grid((K, n), gen, dev)
    _, ids = level_ids(data.codes, data.codes_cm, g, h, data, plan)
    levels = []
    parent = ops.build_histogram(data.codes, g, h,
                                 torch.zeros((K, n), dtype=torch.int32,
                                             device=dev),
                                 n_nodes=1, n_bins=data.n_bins, plan=plan)
    for level in range(1, DEPTH):
        nid, nn = ids[level - 1], 2 ** level
        direct_fn = lambda: ops.build_histogram(
            data.codes, g, h, nid, n_nodes=nn, n_bins=data.n_bins, plan=plan)
        sub_fn = lambda: tree_mod._subtract_level_hist(
            data.codes, g, h, nid, parent, n_nodes=nn, n_bins=data.n_bins,
            plan=plan)
        direct, sub = direct_fn(), sub_fn()
        check(torch.equal(sub, direct),
              f"{label} level {level}: subtraction bit-equal to the direct "
              "pass (exact-grid stats)")
        if level == 3:
            want = tree_mod._subtract_level_hist(
                data.codes, g, h, nid, parent, n_nodes=nn,
                n_bins=data.n_bins, plan=plain)
            check(torch.equal(sub, want), f"{label} level 3: subtraction "
                  "bit-equal to its plain version")
            del want
        if level == 1:
            top = sorted(device_by_kernel(sub_fn).items(),
                         key=lambda kv: -kv[1])[:8]
            log(f"{label} level 1 subtraction's kernels (device ms, "
                "torch.profiler): "
                + "; ".join(f"{ms:.4f} {k[:60]}" for k, ms in top))
        levels.append(dict(level=level, direct_hist_ms=hist_event_ms(
            direct_fn), sub_hist_ms=hist_event_ms(sub_fn),
            direct_total_ms=busy_ms(direct_fn),
            sub_total_ms=busy_ms(sub_fn)))
        parent = direct
        del sub
    log(f"{label} subtraction by level (device ms): " + json.dumps(levels))
    return levels


def variants_path(config, data, y, dev, host_device_ms, smi: str) -> dict:
    """Phase 6 (a)-(d) and (f) on the Higgs-shaped path's data.  Returns the
    phase's numbers for the histogram row."""
    import dataclasses

    from repro_torch.api.plan import ExecutionPlan
    from repro_torch.core import gbdt
    from repro_torch.core import splits as splits_mod
    from repro_torch.core import tree as tree_mod
    from repro_torch.kernels import _build
    from repro_torch.kernels import histogram as hist_k
    from repro_torch.kernels.ref import TreeArrays

    t_phase = time.perf_counter()
    n = data.n_records
    fused_cfg = dataclasses.replace(config, fused_rounds=True)
    gbdt.round_step_cache_clear()

    # (a) fused rounds against the host loop
    host, host_s, host_rounds = stamped_fit(config, data, y)
    _build.reset_launch_counts()
    fused, fused_s, fused_rounds = stamped_fit(fused_cfg, data, y)
    counted = _build.launch_counts()
    st = fused.stats
    log(f"variants (a): host loop {host_s:.3f} s, fused {fused_s:.3f} s; "
        f"round wall ms host {json.dumps([round(r, 3) for r in host_rounds])}"
        f" fused {json.dumps([round(r, 3) for r in fused_rounds])}; stats "
        f"{json.dumps({k: v for k, v in st.items() if k != 'n_rows'})}; "
        f"wrapper counts {json.dumps(counted)}")
    T = config.n_trees
    check(st["fused_graph"] and st["graph_captures"] == 1
          and st["graph_replays"] == T - 1,
          "fused: one capture, the other rounds replayed")
    check(st["launches"]["histogram"] == DEPTH * T
          and st["launches"]["partition"] == DEPTH * T
          and st["launches"]["traversal"] == T,
          f"fused: histogram = partition = {DEPTH} x {T}, traversal = {T}")
    check(counted["histogram"] == 2 * DEPTH,
          "fused: the wrappers counted the eager round and the capture only")
    for field in ("feature", "threshold", "is_cat"):
        check(torch.equal(getattr(fused.model.trees, field)[0],
                          getattr(host.model.trees, field)[0]),
              f"fused: round 0's {field} equals the host loop's")
    check(bool(torch.allclose(torch.tensor(fused.history["train_loss"]),
                              torch.tensor(host.history["train_loss"]),
                              rtol=1e-4, atol=0)),
          "fused: losses within rtol 1e-4 of the host loop's")
    step = gbdt._round_step(fused_cfg, ExecutionPlan().resolved(), data,
                            None)
    # a replay's span on the card (not torch.profiler: tracing a graph's
    # kernels has left later profiles empty)
    replay_ms = busy_ms(step.graph.replay)
    host_steady, fused_steady = (statistics.median(host_rounds[1:]),
                                 statistics.median(fused_rounds[1:]))
    out = dict(fused_round_ms=fused_steady, host_round_ms=host_steady,
               fused_device_ms=replay_ms, host_device_ms=host_device_ms,
               fused_idle=idle_share(replay_ms, fused_steady),
               host_idle=idle_share(host_device_ms, host_steady),
               variants_card=smi)
    log(f"variants (a) Higgs steady round: fused {fused_steady:.3f} ms "
        f"(graph replay {replay_ms:.3f} ms on the card, idle "
        f"{out['fused_idle']:.3f}) vs host loop {host_steady:.3f} ms "
        f"(device {host_device_ms} ms, idle {out['host_idle']})  [{smi}]")

    # (b) histogram subtraction, host loop and fused
    sub_plan = ExecutionPlan(hist_subtraction=True)
    seen, real = [], hist_k.histogram_cuda

    def spy(codes, g, *a, **kw):
        seen.append(codes.shape[0])
        return real(codes, g, *a, **kw)

    hist_k.histogram_cuda = spy
    try:
        sub_host, _, sub_rounds = stamped_fit(config, data, y, sub_plan)
        host_sizes, seen[:] = list(seen), []
        sub_fused, _, sub_fused_rounds = stamped_fit(fused_cfg, data, y,
                                                     sub_plan)
        fused_sizes = list(seen)
    finally:
        hist_k.histogram_cuda = real
    check(host_sizes == ([n] + [n // 2] * (DEPTH - 1)) * T,
          "subtraction: levels >= 1 bin n // 2 records (host loop)")
    check(fused_sizes == ([n] + [n // 2] * (DEPTH - 1)) * 2,
          "subtraction: the eager round and the capture bin n // 2 records "
          "at levels >= 1")
    # round 0 grows from the same statistics in every fit and holds the
    # subtraction contract; later rounds start from margins that differ by
    # the derived sums' rounding, so near-tied candidates may flip between
    # any two fits on the card: counted, and the losses gated
    want0 = TreeArrays(*[a[0] for a in host.model.trees])
    differ = {}
    for what, fit in (("host loop", sub_host), ("fused", sub_fused)):
        tree_parity(TreeArrays(*[a[0] for a in fit.model.trees]), want0,
                    f"subtraction ({what}) round 0")
        check(bool(torch.allclose(torch.tensor(fit.history["train_loss"]),
                                  torch.tensor(host.history["train_loss"]),
                                  rtol=1e-4, atol=0)),
              f"subtraction ({what}): losses within rtol 1e-4 of the direct "
              "fit's")
        differ[what] = int((fit.model.trees.feature
                            != host.model.trees.feature).sum())
    # on exact-grid statistics the subtraction tree is the direct one
    gen = torch.Generator(device=dev).manual_seed(7)
    g, h = exact_grid((n,), gen, dev)
    grow = dict(depth=DEPTH, n_bins=data.n_bins, missing_bin=data.missing_bin,
                is_cat_field=data.is_categorical,
                field_mask=torch.ones(data.n_fields, dtype=torch.bool,
                                      device=dev),
                lambda_=1.0, gamma=0.0, min_child_weight=1.0)
    exact = [tree_mod.fit_tree(data.codes, data.codes_cm, g, h, plan=plan,
                               **grow) for plan in (sub_plan, ExecutionPlan())]
    check(all(torch.equal(u, v) for u, v in zip(*exact)),
          "subtraction: on exact-grid statistics its tree equals the direct "
          "tree bit for bit")
    out.update(sub_host_round_ms=statistics.median(sub_rounds[1:]),
               sub_fused_round_ms=statistics.median(sub_fused_rounds[1:]))
    log(f"variants (b): subtraction steady round host loop "
        f"{out['sub_host_round_ms']:.3f} ms, fused "
        f"{out['sub_fused_round_ms']:.3f} ms; round 0 within the "
        f"subtraction contract, losses within rtol 1e-4, node fields that "
        f"differ from the direct fit's over {T} trees {json.dumps(differ)}; "
        f"exact-grid tree bit-equal; histogram records a round "
        f"{host_sizes[:DEPTH]}")
    out["sub_levels"] = subtraction_levels(data, 1, gen, dev, "Higgs")

    # (c) the lossguide grower
    lg_cfg = dataclasses.replace(config, grow_policy="lossguide",
                                 max_leaves=LOSSGUIDE_LEAVES,
                                 n_trees=LOSSGUIDE_TREES)
    _build.reset_launch_counts()
    lg, lg_s, lg_rounds = stamped_fit(lg_cfg, data, y)
    counts = _build.launch_counts()
    splits = (lg.model.trees.feature >= 0).sum(dim=1)
    loss = lg.history["train_loss"]
    log(f"variants (c): lossguide {LOSSGUIDE_TREES} trees {lg_s:.3f} s, "
        f"splits {splits.tolist()}, loss {loss}, launches "
        f"{json.dumps(counts)}")
    check(all(b < a for a, b in zip(loss, loss[1:])),
          "lossguide: train loss strictly decreases")
    check(int(splits.max()) + 1 <= LOSSGUIDE_LEAVES,
          f"lossguide: at most {LOSSGUIDE_LEAVES} leaves")
    check(counts["histogram"] == int((1 + splits).sum()),
          "lossguide: one histogram launch for the root and one a split")
    out["lossguide_round_ms"] = statistics.median(lg_rounds[1:])
    # (f) the lossguide node histogram: one node, masked statistics
    g, h = exact_grid((n,), gen, dev)
    mask = (torch.rand((n,), generator=gen, device=dev) < 0.3).float()
    zeros = torch.zeros((n,), dtype=torch.int32, device=dev)
    got = hist_k.histogram_cuda(data.codes, g * mask, h * mask, zeros,
                                n_nodes=1, n_bins=data.n_bins)
    check(torch.equal(got, hist_k.histogram_plain(
        data.codes, g * mask, h * mask, zeros, 1, data.n_bins)),
        "lossguide node histogram bit-equal to its plain version")
    # (f) the host split offload on this level histogram
    args = (got, data.is_categorical,
            torch.ones(data.n_fields, dtype=torch.bool, device=dev), 1.0,
            0.0, 1.0)
    for name, a, b in zip(splits_mod.SplitDecision._fields,
                          splits_mod.find_best_splits_host(*args),
                          splits_mod.find_best_splits(*args)):
        check(torch.equal(a, b), f"host split offload: {name} equal")
    del got

    # (d) GOSS, host loop and fused: the same draws by construction
    goss_cfg = dataclasses.replace(config, goss_top_rate=GOSS_TOP,
                                   goss_other_rate=GOSS_OTHER)
    goss_host, _, _ = stamped_fit(goss_cfg, data, y)
    goss_fused, _, goss_rounds = stamped_fit(
        dataclasses.replace(goss_cfg, fused_rounds=True), data, y)
    log(f"variants (d): GOSS {GOSS_TOP}/{GOSS_OTHER} loss host "
        f"{goss_host.history['train_loss']} fused "
        f"{goss_fused.history['train_loss']}")
    check(bool(torch.allclose(torch.tensor(goss_fused.history["train_loss"]),
                              torch.tensor(goss_host.history["train_loss"]),
                              rtol=1e-4, atol=0)),
          "GOSS: fused losses within rtol 1e-4 of the host loop's")
    check(goss_fused.stats["graph_captures"] == 1
          and goss_fused.stats["fused_graph"], "GOSS: fused as one graph")
    # (f) GOSS weights on the card against the CPU, the same draw
    g_round = torch.randn((n,), generator=gen, device=dev)
    pick = gbdt.goss_pick(n, GOSS_TOP, GOSS_OTHER, gen)
    check(torch.equal(gbdt.goss_weights(g_round, None, GOSS_TOP, GOSS_OTHER,
                                        pick=pick).cpu(),
                      gbdt.goss_weights(g_round.cpu(), None, GOSS_TOP,
                                        GOSS_OTHER, pick=pick.cpu())),
          "GOSS weights on the card equal the CPU's")
    out["goss_fused_round_ms"] = statistics.median(goss_rounds[1:])
    gbdt.round_step_cache_clear()
    torch.cuda.empty_cache()
    log(f"variants phase (Higgs): {time.perf_counter() - t_phase:.1f} s")
    return out


def variants_multiclass(config, data, y, dev, host_steady_ms,
                        host_device_ms, smi: str) -> dict:
    """Phase 6 (e) and the Covertype cell's fused round: 8 fused rounds
    against the path's host loop, then 4 fused rounds with subtraction
    (the masked class-batched route inside the graph) against the host
    loop with subtraction.  Returns the numbers for the class row."""
    import dataclasses

    from repro_torch.api.plan import ExecutionPlan
    from repro_torch.core import gbdt
    from repro_torch.kernels import histogram as hist_k

    t_phase = time.perf_counter()
    K, n = config.n_classes, data.n_records
    gbdt.round_step_cache_clear()
    fused_cfg = dataclasses.replace(config, fused_rounds=True)
    fused, _, rounds = stamped_fit(fused_cfg, data, y)
    check(fused.stats["graph_captures"] == 1 and fused.stats["fused_graph"],
          "multi-class fused: one capture")
    step = gbdt._round_step(fused_cfg, ExecutionPlan().resolved(), data,
                            None)
    replay_ms = busy_ms(step.graph.replay)
    steady = statistics.median(rounds[1:])
    out = dict(fused_round_ms_k7=steady, host_round_ms_k7=host_steady_ms,
               fused_device_ms_k7=replay_ms,
               host_device_ms_k7=host_device_ms,
               fused_idle_k7=idle_share(replay_ms, steady),
               host_idle_k7=idle_share(host_device_ms, host_steady_ms))
    log(f"variants (e) Covertype steady round: fused {steady:.3f} ms "
        f"(graph replay {replay_ms:.3f} ms on the card, idle "
        f"{out['fused_idle_k7']:.3f}) vs "
        f"host loop {host_steady_ms:.3f} ms (device {host_device_ms} ms, "
        f"idle {out['host_idle_k7']})  [{smi}]")

    sub_plan = ExecutionPlan(hist_subtraction=True)
    short = dataclasses.replace(config, n_trees=MC_FUSED_ROUNDS)
    host, _, _ = stamped_fit(short, data, y, sub_plan)
    seen, real = [], hist_k.histogram_cuda

    def spy(codes, g, *a, **kw):
        seen.append((codes.shape[0], tuple(g.shape)))
        return real(codes, g, *a, **kw)

    hist_k.histogram_cuda = spy
    try:
        sub, _, sub_rounds = stamped_fit(
            dataclasses.replace(short, fused_rounds=True), data, y, sub_plan)
    finally:
        hist_k.histogram_cuda = real
    st = sub.stats
    loss = sub.history["train_loss"]
    log(f"variants (e): {MC_FUSED_ROUNDS} fused rounds with subtraction, "
        f"K = {K}: loss {loss} (host loop {host.history['train_loss']}), "
        f"stats {json.dumps({k: v for k, v in st.items() if k != 'n_rows'})}"
        f", histogram calls {seen[:DEPTH]}")
    check(st["fused_graph"] and st["graph_captures"] == 1
          and st["graph_replays"] == MC_FUSED_ROUNDS - 1,
          "multi-class subtraction: one capture, the rest replayed")
    check(st["launches"]["histogram"] == DEPTH * MC_FUSED_ROUNDS
          and st["launches"]["partition"] == DEPTH * MC_FUSED_ROUNDS
          and st["launches"]["traversal"] == MC_FUSED_ROUNDS,
          "multi-class subtraction: one class-batched launch a level")
    check(seen == [(n, (K, n))] * DEPTH * 2,
          "multi-class subtraction: masked statistics over all n records")
    check(all(b < a for a, b in zip(loss, loss[1:])),
          "multi-class subtraction: train loss strictly decreases")
    # a derived sibling reassociates its parent's sum, and the atomics add
    # in no fixed order, so near-tied candidates of K x 63 nodes may flip
    # between two fits: counted, not gated
    differ = int((sub.model.trees.feature[:K]
                  != host.model.trees.feature[:K]).sum())
    log(f"variants (e): round 0 nodes whose field differs from the host "
        f"loop's: {differ} of {K * (2 ** DEPTH - 1)}")
    check(bool(torch.allclose(torch.tensor(loss),
                              torch.tensor(host.history["train_loss"]),
                              rtol=1e-4, atol=0)),
          "multi-class subtraction: losses within rtol 1e-4 of the host "
          "loop's")
    out["sub_fused_round_ms_k7"] = statistics.median(sub_rounds[1:])
    gen = torch.Generator(device=dev).manual_seed(8)
    out["sub_levels_k7"] = subtraction_levels(data, K, gen, dev,
                                              "Covertype K = 7")
    gbdt.round_step_cache_clear()
    torch.cuda.empty_cache()
    log(f"variants phase (Covertype): {time.perf_counter() - t_phase:.1f} s")
    return out


# phase 7, out-of-core training
STREAM_WARM_TREES = 2             # (c): trees of the warm start
STREAM_STORM_READS = 200          # (d): chunk reads the seeded storm covers


def stream_chunks(src, binner, rows: int, packed: bool, dev, codes=None):
    """A pass as ``train_streaming`` makes it (``gbdt.binned_pass``): raw
    chunks staged in the pinned ring, uploaded on the copy stream and
    binned on the card, 4-bit packed where ``packed``.  Returns the
    zero-argument callable the chunked grower takes.  Given the in-memory
    row-major ``codes`` (the host's binning), each chunk's codes are held
    against them bit for bit."""
    from repro_torch.core.gbdt import binned_pass

    def chunks():
        for lo, hi, c in binned_pass(src, binner, rows, packed, dev):
            if codes is not None:
                check(torch.equal(c.data, codes.data[lo:hi]) if packed
                      else torch.equal(c, codes[lo:hi]),
                      f"rows {lo}:{hi} binned on the card equal the "
                      "host's codes")
            yield lo, hi, c
    return chunks


def chunked_gate(label: str, chunks, data, K: int, gen, dev,
                 twin=None) -> None:
    """(a): the chunked grower on the card-binned stream against
    ``fit_forest`` on the in-memory codes, on exact-grid statistics: the
    same trees and final node ids, bit for bit; ``twin`` (a second chunk
    stream, the uint8 one of a packed stream) is held to the same."""
    from repro_torch.core import tree as tree_mod

    n = data.n_records
    g, h = exact_grid((K, n), gen, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    whole, ids = level_ids(data.codes, data.codes_cm, g, h, data, None)
    ids = ids[-1]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    streams = [("stream", chunks)] + ([("uint8 stream", twin)] if twin
                                       else [])
    for what, stream in streams:
        t2 = time.perf_counter()
        tree, sids = tree_mod.fit_forest_chunked(stream, g.cpu(), h.cpu(),
                                                 **grower_args(data, dev))
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for field, a, b in zip(tree._fields, tree, whole):
            check(torch.equal(a, b), f"{label} (a): the chunked {what}'s "
                  f"{field} equals fit_forest's")
        check(torch.equal(sids, ids), f"{label} (a): the chunked {what}'s "
              "final node ids equal fit_forest's")
        log(f"stream (a) {label}: fit_forest_chunked on the {what} "
            f"{t3 - t2:.3f} s against fit_forest {t1 - t0:.3f} s, trees "
            "and node ids bit-equal on exact-grid statistics")


def stream_ties(config, data, y, rows: int, dev):
    """What :func:`tie_witness` reads for a stream of ``rows``-row chunks
    over ``data``: round 0's statistics and the uint8 codes."""
    from repro_torch.kernels import ops

    def make():
        g, h = round0_stats(config, y, data.n_fields, dev)
        return dict(codes=ops.unpack_codes(data.codes), g=g, h=h, rows=rows,
                    n_bins=data.n_bins, config=config)
    return make


def stream_fit(label: str, config, src, binner, y, mem, mem_steady_ms: float,
               smi: str, data):
    """(b): ``train_streaming`` over the raw matrix against the in-memory
    fit ``mem`` of phase 3 on ``data``: round 0 under
    :func:`round0_contract`, every loss within rtol 1e-4, the loss falling
    every round; later rounds' differing nodes counted.
    Returns the fit, its launch counts and its steady round (ms)."""
    from repro_torch.core.gbdt import train_streaming
    from repro_torch.kernels import _build

    K = config.n_classes or 1
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    stamps = [t0]
    res = train_streaming(config, src, binner, y,
                          callback=lambda t, m: stamps.append(
                              time.perf_counter()))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    st = res.stats
    loss, mem_loss = res.history["train_loss"], mem.history["train_loss"]
    rounds = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    steady = statistics.median(rounds[1:] or rounds)
    log(f"stream (b) {label}: {config.n_trees} rounds {wall:.3f} s, "
        f"stats {json.dumps(st)}; steady round {steady:.3f} ms against the "
        f"in-memory host loop's {mem_steady_ms:.3f} ms "
        f"({steady / mem_steady_ms:.2f}x)  [{smi}]")
    log(f"stream (b) {label}: round wall ms "
        + json.dumps([round(r, 3) for r in rounds]))
    log(f"stream (b) {label}: loss {loss}; in-memory {mem_loss}")
    log(f"stream (b) {label}: launches {json.dumps(counts)}; device memory "
        f"above the fit's inputs at its peak {peak / 2 ** 20:.1f} MiB")
    hist = "histogram_nibble" if src_packed(binner) else "histogram"
    part = "partition_nibble" if src_packed(binner) else "partition"
    per_tree = DEPTH * st["n_chunks"]
    check(counts[hist] == per_tree * config.n_trees
          and counts[part] == per_tree * config.n_trees,
          f"{label} (b): histogram and partition launched once a chunk a "
          "level")
    check(all(b < a for a, b in zip(loss, loss[1:])),
          f"{label} (b): the streamed loss falls every round")
    round0_contract(f"{label} (b)", res.model, mem.model, binner,
                    stream_ties(config, data, y, st["chunk_rows"],
                                data.codes_cm.device))
    check(bool(np.allclose(loss, mem_loss, rtol=1e-4, atol=0)),
          f"{label} (b): losses within rtol 1e-4 of the in-memory fit's")
    a, b = res.model.trees, mem.model.trees
    differ = int((a.feature[K:] != b.feature[K:]).sum())
    log(f"stream (b) {label}: nodes of rounds >= 1 whose field differs from "
        f"the in-memory fit's: {differ} of {a.feature[K:].numel()}")
    return res, counts, steady, peak


def round0_stats(config, y, n_fields: int, dev):
    """Round 0's (K, n) gradient statistics as the trainers draw them."""
    from repro_torch.core import gbdt
    from repro_torch.core.losses import get_loss

    loss = get_loss(config.objective, config.n_classes)
    yt = torch.as_tensor(np.asarray(y), dtype=torch.float32, device=dev)
    base = gbdt.base_margin_tensor(
        loss.base_margin(yt).cpu().numpy().astype(np.float32)
        if config.n_classes else float(loss.base_margin(yt)), dev)
    n = yt.shape[0]
    g, h = loss.grad_hess(base.expand((n,) + base.shape).clone(), yt)
    g, h, _ = gbdt._round_stats(config, gbdt._round_generator(config, 0, dev),
                                g, h, n, n_fields, config.n_classes)
    return ((g.T, h.T) if config.n_classes else (g[None], h[None]))


def split_gain(hist, f: int, t: int, cat: bool, dl: bool, config):
    """The gain of one split on a node's (F, NB, 2) histogram, in the
    histogram's dtype, by ``find_best_splits``' formula (the parent's sums
    from field 0), and the hessian of its lighter child; a gain of 0 for
    no split (a node splits where its gain is > 0), -inf where a child
    holds less hessian than ``min_child_weight``."""
    if f < 0:
        return 0.0, float("inf")
    NB = hist.shape[1]
    Gp, Hp = hist[0, :, 0].sum(), hist[0, :, 1].sum()
    v = hist[f, :NB - 1]
    GL, HL = v[t] if cat else torch.cumsum(v, 0)[t]
    if dl:
        GL, HL = GL + hist[f, NB - 1, 0], HL + hist[f, NB - 1, 1]
    GR, HR = Gp - GL, Hp - HL
    light = min(float(HL), float(HR))
    if light < config.min_child_weight:
        return float("-inf"), light
    lam = config.lambda_
    return float(0.5 * (GL ** 2 / (HL + lam) + GR ** 2 / (HR + lam)
                        - Gp ** 2 / (Hp + lam)) - config.gamma), light


def tie_witness(k: int, node: int, sel, splits: dict, ties) -> dict:
    """Why a held node splits differently in two fits: both choices
    (``splits``: side -> (field, bin, is_cat, default_left)) evaluated on
    the node's records in float64, and in float32 as a whole pass and as
    the stream's chunked pass (per-chunk histograms summed in order) sum
    them on the card.  ``rounding`` is the largest float32 error of either
    gain, summed over the two choices.  A choice is a phantom where in
    float64 a child holds less than ``min_child_weight`` of hessian (it
    sends no record that way: the node lies below a split on the same
    field) by less than float32 sums can err: the lighter child's hessian
    is a difference of two sums over the node's m records, each off by at
    most (m - 1)·2^-24 of the parent's hessian."""
    from repro_torch.kernels import ops

    codes, g, h, rows, config = (ties["codes"], ties["g"][k], ties["h"][k],
                                 ties["rows"], ties["config"])
    n, F = codes.shape
    NB = ties["n_bins"]
    idx = sel.nonzero()[:, 0]
    c, gs, hs = codes[idx], g[idx], h[idx]
    flat = (torch.arange(F, device=c.device) * NB + c.long()).reshape(-1)
    h64 = torch.zeros((F * NB, 2), dtype=torch.float64, device=c.device)
    h64.index_add_(0, flat, torch.stack(
        [gs.double(), hs.double()], -1).repeat_interleave(F, 0))
    h64 = h64.reshape(F, NB, 2)

    def f32(bounds):
        acc = None
        for lo, hi in bounds:
            part = idx[(idx >= lo) & (idx < hi)]
            if part.numel() == 0:
                continue
            one = ops.build_histogram(
                codes[part].contiguous(), g[part][None].contiguous(),
                h[part][None].contiguous(),
                torch.zeros((1, part.numel()), dtype=torch.int32,
                            device=c.device), n_nodes=1, n_bins=NB)[0, 0]
            acc = one if acc is None else acc.add_(one)
        return acc

    sums = (f32([(0, n)]),
            f32([(lo, min(lo + rows, n)) for lo in range(0, n, rows)]))
    m = int(idx.numel())
    h_bound = 2 * m * 2.0 ** -24 * float(h64[0, :, 1].sum())
    out = {"tree": k, "node": node, "records": m, "hessian_bound": h_bound}
    err, phantom = 0.0, False
    for side, d in splits.items():
        g64, light64 = split_gain(h64, *d, config)
        g32 = [split_gain(x, *d, config)[0] for x in sums]
        out[side] = {"split": list(d[:2]) if d[0] >= 0 else None,
                     "gain64": g64, "gain32": g32}
        if g64 == float("-inf"):
            out[side]["light_child_hessian64"] = light64
            phantom |= config.min_child_weight - light64 <= h_bound
        err += max((abs(x - g64) for x in g32 if np.isfinite(x - g64)),
                   default=0.0)
    gains = [out[side]["gain64"] for side in splits]
    out["gap64"] = abs(gains[0] - gains[1]) if all(
        np.isfinite(gains)) else float("inf")
    out["rounding"] = err
    out["phantom"] = phantom
    return out


def canonical_round0(model, binary, has_missing) -> list:
    """Round 0's (K, ...) tables on the host, with every split on a
    two-category field written as ``code == 0``: ``code == 1`` with the
    missing values sent one way is the same partition as ``code == 0``
    with them sent the other way and the children swapped, and the two
    tie exactly in exact arithmetic, so float32 rounding picks one.  The
    missing direction of a field with no missing value is written as 0.
    The last two tables are the bins and directions the fit chose, moved
    with the swapped subtrees."""
    K = model.n_classes
    f, t, c, d, leaf = (x[:K].cpu().clone() for x in model.trees)
    t0, d0 = t.clone(), d.clone()
    NN = f.shape[1]
    for k in range(K):
        for i in range(NN):
            if not (f[k, i] >= 0 and c[k, i] and binary[int(f[k, i])]
                    and t[k, i] == 1):
                continue
            t[k, i], d[k, i] = 0, 1 - d[k, i]
            lo, hi, width = 2 * i + 1, 2 * i + 2, 1
            while True:
                for arr, off in ((f, 0), (t, 0), (c, 0), (d, 0), (t0, 0),
                                 (d0, 0), (leaf, NN)):
                    if (lo < NN) == (off == 0):
                        a, b = lo - off, hi - off
                        tmp = arr[k, a:a + width].clone()
                        arr[k, a:a + width] = arr[k, b:b + width]
                        arr[k, b:b + width] = tmp
                if lo >= NN:
                    break
                lo, hi, width = 2 * lo + 1, 2 * hi + 1, 2 * width
    d = torch.where(torch.as_tensor(has_missing)[f.clamp(min=0).long()], d,
                    0)
    return [f, t, c, d, leaf, t0, d0]


def round0_contract(what: str, model, ref, binner, ties) -> None:
    """Round 0 of ``model`` against ``ref`` under the stream's contract,
    on :func:`canonical_round0` tables.  A node is held when every split
    above it is the same in both (field, bin, categorical flag and missing
    direction; two nodes that do not split agree).  A held node splits as
    the reference's does, or :func:`tie_witness` (on what ``ties()``
    returns, :func:`stream_ties`) shows why it may not: its two choices'
    float64 gains lie within float32 rounding of each other, or one choice
    is a phantom.  Every leaf slot under held, agreeing nodes lies within
    rtol 1e-4 + atol 1e-5 of the reference's.  Nodes that differ are
    counted, and the first one of each differing subtree is logged with
    its witness."""
    K = model.n_classes
    ties = ties()
    codes, missing = ties["codes"], ties["n_bins"] - 1
    dev = codes.device
    binary = binner._is_cat & (binner._n_value_bins == 2)
    has_missing = (codes == missing).any(0).cpu().numpy()
    fa, ta, ca, da, la, ta0, da0 = canonical_round0(model, binary,
                                                    has_missing)
    fb, tb, cb, db, lb, tb0, db0 = canonical_round0(ref, binary, has_missing)
    NN = fa.shape[1]
    eq = (fa == fb) & ((fb < 0) | ((ta == tb) & (ca == cb) & (da == db)))
    held = torch.ones_like(eq)
    for i in range(1, NN):
        held[:, i] = held[:, (i - 1) // 2] & eq[:, (i - 1) // 2]
    first = held & ~eq
    parent = (NN + torch.arange(la.shape[1]) - 1) // 2
    leaf_held = held[:, parent] & eq[:, parent]
    close = (la - lb).abs() <= 1e-5 + 1e-4 * lb.abs()
    witnesses = []
    for k in range(K):
        nodes = first[k].nonzero()[:, 0].tolist()
        if not nodes:
            continue
        tabs = [x[k].to(dev) for x in (fb, tb, cb, db)]
        ids = torch.zeros(codes.shape[0], dtype=torch.long, device=dev)
        for level in range(DEPTH):
            lo = 2 ** level - 1
            for i in (i for i in nodes if lo <= i < 2 * lo + 1):
                splits = {side: tuple(int(x[k, i]) for x in tabs_)
                          for side, tabs_ in (("reference",
                                               (fb, tb0, cb, db0)),
                                              ("fit", (fa, ta0, ca, da0)))}
                witnesses.append(tie_witness(k, i, ids == i, splits, ties))
            f = tabs[0][ids]
            col = codes.gather(1, f.clamp(min=0)[:, None])[:, 0].long()
            thr = tabs[1][ids]
            left = torch.where(tabs[2][ids].bool(), col == thr, col <= thr)
            left = torch.where(col == missing, tabs[3][ids].bool(), left)
            ids = 2 * ids + 1 + (~(left | (f < 0))).long()
    for w in witnesses:
        log(f"{what}: tie witness {json.dumps(w)}")
    log(f"{what}: round 0's nodes whose split differs (two-category splits "
        f"written as code == 0): {int((~eq).sum())} of {eq.numel()}, below "
        f"{int(first.sum())} held nodes that differ "
        f"({sum(w['phantom'] for w in witnesses)} of them phantoms); leaf "
        f"slots held {int(leaf_held.sum())} of {leaf_held.numel()}")
    check(bool(torch.all(close[leaf_held])),
          f"{what}: round 0's leaves under held, agreeing nodes within rtol "
          "1e-4, atol 1e-5")
    for w in witnesses:
        check(w["phantom"] or w["gap64"] <= w["rounding"],
              f"{what}: tree {w['tree']} node {w['node']} splits otherwise "
              "only at a phantom or where its choices' gains lie within "
              "float32 rounding")


def src_packed(binner) -> bool:
    from repro_torch.core.binning import PACK_MAX_BINS
    return binner.max_bins <= PACK_MAX_BINS


def pass_breakdown(label: str, src, binner, K: int, model, dev,
                   smi: str) -> dict:
    """One level pass at NN = 32, as the trainer makes it, with the default
    ``chunk_bytes``: first its stages serialized chunk by chunk and timed
    apart (host staging: the copy into pinned memory, host clock; upload,
    card binning with the pack, growth: the statistics' upload, the
    histogram and the partition, each by CUDA events), then the same pass
    overlapped (the prefetch worker uploads chunk i + 1 while chunk i bins
    and grows) for its wall time and its peak device memory above what was
    allocated before it: the second of two such passes, the first having
    allocated the pinned ring."""
    from repro_torch.api.plan import ExecutionPlan
    from repro_torch.core import tree as tree_mod
    from repro_torch.core.binning import PackedCodes
    from repro_torch.kernels import ops

    packed = src_packed(binner)
    plan = ExecutionPlan(packed_codes=packed)
    F, n = src.n_fields, src.n_rows
    rows = min(plan.chunk_rows(F, K), n)
    nn = 2 ** (DEPTH - 1)
    gen = torch.Generator().manual_seed(7)
    g = torch.rand((K, n), generator=gen).pin_memory()
    h = torch.rand((K, n), generator=gen).pin_memory()
    nid = torch.randint(0, nn, (K, n), generator=gen,
                        dtype=torch.int32).pin_memory()
    off = nn - 1
    tables = [t[:K, off:off + nn].contiguous() for t in model.trees[:4]]
    kplan = plan.without_chunking().resolved()

    def grow(codes, lo, hi, hist):
        up = [torch.empty((K, hi - lo), dtype=a.dtype, device=dev)
              for a in (g, h, nid)]
        for dst, a in zip(up, (g, h, nid)):
            for k in range(K):
                dst[k].copy_(a[k, lo:hi], non_blocking=True)
        hist = ops.accumulate_histogram(hist, codes, up[0], up[1], up[2],
                                        n_nodes=nn, n_bins=binner.max_bins,
                                        plan=kplan)
        tree_mod._partition_chunk(codes, up[2], *tables,
                                  missing_bin=binner.max_bins - 1,
                                  plan=kplan)
        return hist

    def new_hist():
        return torch.zeros((K, nn, F, binner.max_bins, 2), device=dev)

    # serialized, stage by stage
    pinned = torch.empty((rows * F,), dtype=torch.float32, pin_memory=True)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    stage = dict(host_staging_ms=0.0, upload_ms=0.0, binning_ms=0.0,
                 growth_ms=0.0)
    hist = new_hist()
    lo = 0
    for X, _ in src.chunks(rows):
        hi = lo + X.shape[0]
        t0 = time.perf_counter()
        host = pinned[:X.size].view(X.shape)
        host.copy_(torch.from_numpy(X))
        stage["host_staging_ms"] += (time.perf_counter() - t0) * 1e3
        ev[0].record()
        xd = host.to(dev, non_blocking=True)
        ev[1].record()
        codes = binner.transform_chunk(xd)
        codes = PackedCodes.pack(codes) if packed else codes
        ev[2].record()
        hist = grow(codes, lo, hi, hist)
        ev[3].record()
        ev[3].synchronize()
        for key, a, b in (("upload_ms", 0, 1), ("binning_ms", 1, 2),
                          ("growth_ms", 2, 3)):
            stage[key] += ev[a].elapsed_time(ev[b])
        lo = hi
    serial = sum(stage.values())
    # overlapped, as the trainer streams; twice, the second timed: the
    # first allocates the pinned ring, which later passes take from the
    # pinned memory cache
    del hist, xd, codes, pinned
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        hist = new_hist()
        for lo, hi, codes in stream_chunks(src, binner, rows, packed, dev)():
            hist = grow(codes, lo, hi, hist)
        del codes
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() - base
        del hist
    wall = walls[-1]
    raw = n * F * 4
    out = dict(stage, serial_ms=serial, overlapped_ms=wall,
               first_overlapped_ms=walls[0],
               chunk_rows=rows, n_chunks=-(-n // rows), peak_bytes=peak,
               chunk_bytes=plan.DEFAULT_CHUNK_BYTES,
               model_bytes=rows * ((1 if packed else 2) * F + 12 * K),
               raw_bytes=raw, upload_gb_per_s=raw / stage["upload_ms"] / 1e6)
    log(f"stream pass {label} (NN = {nn}, {out['n_chunks']} chunks of "
        f"{rows}): host staging {stage['host_staging_ms']:.3f} ms, upload "
        f"{stage['upload_ms']:.3f} ms ({out['upload_gb_per_s']:.2f} GB/s of "
        f"raw float32), card binning {stage['binning_ms']:.3f} ms, growth "
        f"{stage['growth_ms']:.3f} ms; serialized {serial:.3f} ms, "
        f"overlapped {wall:.3f} ms (the first pass, which allocates the "
        f"pinned ring: {walls[0]:.3f} ms)  [{smi}]")
    log(f"stream pass {label}: peak device memory above the pass's start "
        f"{peak / 2 ** 20:.1f} MiB against chunk_bytes "
        f"{plan.DEFAULT_CHUNK_BYTES / 2 ** 20:.0f} MiB (the reference "
        f"formula's chunk: {out['model_bytes'] / 2 ** 20:.1f} MiB; a chunk's "
        f"raw floats {rows * F * 4 / 2 ** 20:.1f} MiB)")
    return out


def streaming_path(paths: dict, dev, smi: str) -> dict:
    """Phase 7: out-of-core training on the card over the raw matrices of
    phases 3, 3b and 3c, each from an ``ArraySource`` in host memory, with
    those phases' binners and the default ``chunk_bytes`` (64 MiB).  Gates
    (a)-(d); returns the kernel rows' ``stream_*`` numbers."""
    import dataclasses

    from repro_torch.api.plan import ExecutionPlan
    from repro_torch.core import gbdt
    from repro_torch.data.pipeline import ArraySource
    from repro_torch.kernels import _build
    from repro_torch.resilience import (DeviceOOMError, FaultSchedule,
                                        FaultySource, RecoveryPolicy,
                                        RetryingSource, RetryPolicy,
                                        seeded_schedule)

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(21)
    out = {}
    for key, label in (("higgs", "Higgs"), ("cover", "Covertype"),
                       ("iot", "IoT")):
        p = paths[key]
        K = p["config"].n_classes or 1
        packed = src_packed(p["binner"])
        src = ArraySource(p["X"], p["y"])
        rows = ExecutionPlan(packed_codes=packed).chunk_rows(src.n_fields, K)
        log(f"stream {label}: {src.n_rows} x {src.n_fields} float32 "
            f"({src.X.nbytes / 1e9:.3f} GB a pass), K = {K}, "
            f"{'packed' if packed else 'uint8'} chunks of {rows} rows, "
            f"{-(-src.n_rows // rows)} a pass, {DEPTH + 1} passes a round")
        # (a)
        chunks = stream_chunks(src, p["binner"], rows, packed, dev,
                               p["data"].codes)
        twin = (stream_chunks(src, p["binner"], rows, False, dev)
                if packed else None)
        chunked_gate(label, chunks, p["data"], K, gen, dev, twin)
        # (b)
        res, counts, steady, peak = stream_fit(
            label, p["config"], src, p["binner"], p["y"], p["res"],
            p["steady_ms"], smi, p["data"])
        if key == "cover":
            # a second witness: one chunk a pass sums as the in-memory fit
            one = gbdt.train_streaming(
                dataclasses.replace(p["config"], n_trees=1), src,
                p["binner"], p["y"], chunk_rows=src.n_rows)
            log(f"stream (b) {label} in one chunk a pass: loss "
                f"{one.history['train_loss']}; in-memory "
                f"{p['res'].history['train_loss'][:1]}")
            round0_contract(f"{label} (b) in one chunk", one.model,
                            p["res"].model, p["binner"],
                            stream_ties(p["config"], p["data"], p["y"],
                                        src.n_rows, dev))
        out[key] = dict(res=res, counts=counts, steady_ms=steady,
                        fit_peak_bytes=peak,
                        breakdown=pass_breakdown(label, src, p["binner"], K,
                                                 res.model, dev, smi))
    # (c) a warm start of 2 more trees from the streamed Higgs model
    p, res = paths["higgs"], out["higgs"]["res"]
    src = ArraySource(p["X"], p["y"])
    rows = res.stats["chunk_rows"]
    direct = res.model.predict_margin(p["data"])
    streamed = gbdt._streamed_margins(
        res.model, stream_chunks(src, p["binner"], rows, False, dev),
        src.n_rows, ExecutionPlan().resolved(), dev)
    check(torch.equal(streamed, direct), "Higgs (c): _streamed_margins "
          "equals predict_margin on the same codes bit for bit")
    _build.reset_launch_counts()
    warm = gbdt.train_streaming(
        dataclasses.replace(p["config"], n_trees=STREAM_WARM_TREES), src,
        p["binner"], p["y"], init_model=res.model)
    warm_counts = _build.launch_counts()
    loss = res.history["train_loss"] + warm.history["train_loss"]
    log(f"stream (c) Higgs warm start: {STREAM_WARM_TREES} trees, loss "
        f"{warm.history['train_loss']}, launches {json.dumps(warm_counts)}")
    check(warm.model.n_trees == res.model.n_trees + STREAM_WARM_TREES,
          "Higgs (c): the warm start continues the ensemble")
    check(warm_counts["ensemble"] == res.stats["n_chunks"],
          "Higgs (c): the streamed margins launch the ensemble once a chunk")
    check(all(b < a for a, b in zip(loss, loss[1:])),
          "Higgs (c): the loss keeps falling")
    check(torch.equal(warm.model.predict_margin(p["data"]), warm.margins),
          "Higgs (c): the warm start's margins equal predict_margin")
    out["higgs"]["warm_counts"] = warm_counts
    # (d) a seeded error storm absorbed below the trainer, then one OOM
    p, ref = paths["cover"], out["cover"]["res"]
    rows = ref.stats["chunk_rows"]
    storm = seeded_schedule(5, "source", STREAM_STORM_READS, rate=0.1)
    oom = FaultSchedule().add("source", 2 * (DEPTH + 1) * ref.stats[
        "n_chunks"] + 3, exc=DeviceOOMError)         # in round 2 or so
    flaky = RetryingSource(
        FaultySource(FaultySource(ArraySource(p["X"], p["y"]), storm), oom),
        RetryPolicy(base_delay_s=0.0, max_delay_s=0.0, jitter=0.0))
    t0 = time.perf_counter()
    res = gbdt.train_streaming(
        p["config"], flaky, p["binner"], p["y"],
        recovery=RecoveryPolicy(min_chunk_rows=max(1, rows // 4)))
    st = res.stats
    log(f"stream (d) Covertype under a seeded storm and one OOM: "
        f"{time.perf_counter() - t0:.3f} s, stats {json.dumps(st)}, retry "
        f"stats {json.dumps(flaky.stats)}, storm faults fired "
        f"{len(storm.fired)}, OOM fired {oom.fired}")
    check(len(oom.fired) == 1, "Covertype (d): the OOM was injected")
    check(flaky.stats["retries"] > 0 and st["recoveries"] == 0,
          "Covertype (d): the storm is absorbed by RetryingSource")
    check(st["oom_halvings"] == 1 and st["chunk_rows"] == rows // 2
          and st["n_chunks"] == -(-len(p["y"]) // (rows // 2)),
          "Covertype (d): the OOM halves chunk_rows, counted in stats")
    check(flaky._closed, "Covertype (d): the retrying source is closed")
    K = p["config"].n_classes
    a, b = res.model.trees, ref.model.trees
    round0_contract("Covertype (d)", res.model, ref.model, p["binner"],
                    stream_ties(p["config"], p["data"], p["y"], rows, dev))
    check(bool(np.allclose(res.history["train_loss"],
                           ref.history["train_loss"], rtol=1e-4, atol=0)),
          "Covertype (d): losses within rtol 1e-4 of (b)'s")
    log(f"stream (d): nodes of rounds >= 1 whose field differs from (b)'s: "
        f"{int((a.feature[K:] != b.feature[K:]).sum())} of "
        f"{a.feature[K:].numel()}")
    torch.cuda.empty_cache()
    log(f"streaming phase: {time.perf_counter() - t_phase:.1f} s")
    return out


# phase 8, distributed training and the launch drivers
DIST_SHARDS = 4                   # data shards of the one-card mesh
DIST_FAULT_ROUND = 3              # (c): the round whose worker is lost
CLI_RECORDS, CLI_TREES = 1_000_000, 30
CLI_CKPT_EVERY = 2


def dist_mesh(D: int, dev):
    """A ``("data",)`` mesh of D shards, all on ``dev``."""
    from repro_torch.launch.mesh import make_mesh
    return make_mesh((D,), ("data",), devices=[dev] * D)


def dist_exact(data, gen, dev) -> dict:
    """(a): the explicit schedule on a D = 4 mesh on one card, on
    exact-grid statistics: the distributed histogram bit-equal to
    ``ops.build_histogram`` (one histogram launch a shard), the explicit
    and the owner-evaluates (``partition_bits``) trees and final node ids
    bit-equal to ``fit_forest``'s, ``pjit_fit_tree`` equal to the explicit
    schedule; then on real statistics the bf16 sum within bfloat16 rounding
    of the float32 one.  Returns its timings."""
    from repro_torch.distributed import sharding
    from repro_torch.kernels import _build, ops

    mesh = dist_mesh(DIST_SHARDS, dev)
    n, D, nn = data.n_records, DIST_SHARDS, 2 ** (DEPTH - 1)
    codes, cm = ops.unpack_codes(data.codes), ops.unpack_codes(data.codes_cm)
    g, h = exact_grid((1, n), gen, dev)
    nid = torch.randint(0, nn, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    _build.reset_launch_counts()
    hist = sharding.distributed_histogram(mesh, codes, g[0], h[0], nid,
                                          n_nodes=nn, n_bins=N_BINS)
    counts = _build.launch_counts()
    whole = ops.build_histogram(codes, g[0], h[0], nid, n_nodes=nn,
                                n_bins=N_BINS)
    check(torch.equal(hist, whole), "dist (a): the D = 4 histogram equals "
          "build_histogram bit for bit on exact-grid statistics")
    check(counts["histogram"] == D, "dist (a): one histogram launch a shard")
    ref, ids = level_ids(data.codes, data.codes_cm, g, h, data, None)
    kw = grower_args(data, dev)
    out = {}
    trees = {}
    for bits in (False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree, nids = sharding.distributed_fit_tree(
            mesh, codes, cm, g[0], h[0], partition_bits=bits,
            return_node_ids=True, **kw)
        torch.cuda.synchronize()
        name = "bits" if bits else "explicit"
        out[f"{name}_tree_s"] = time.perf_counter() - t0
        for field, a, b in zip(tree._fields, tree, ref):
            check(torch.equal(a, b[0]), f"dist (a): the {name} schedule's "
                  f"{field} equals fit_forest's")
        check(torch.equal(nids, ids[-1][0]), f"dist (a): the {name} "
              "schedule's final node ids equal fit_forest's")
        trees[name] = tree
    pj = sharding.pjit_fit_tree(
        mesh, **{k: v for k, v in kw.items()
                 if k not in ("is_cat_field", "field_mask")})(
        codes, cm, g[0], h[0], kw["is_cat_field"], kw["field_mask"])
    check(all(torch.equal(a, b) for a, b in zip(pj, trees["explicit"])),
          "dist (a): pjit_fit_tree equals the explicit schedule")
    gr = torch.randn((n,), generator=gen, device=dev)
    hr = torch.rand((n,), generator=gen, device=dev)

    def summed(gg, dtype=None):
        return sharding.distributed_histogram(mesh, codes, gg, hr, nid,
                                              n_nodes=nn, n_bins=N_BINS,
                                              hist_dtype=dtype)

    f32, bf, mag = summed(gr), summed(gr, torch.bfloat16), summed(gr.abs())
    err = (bf - f32).abs()
    # D parts rounded to bfloat16 (unit roundoff 2^-8), D - 1 sums rounded
    check(bool(torch.all(err <= 2 * D * 2.0 ** -8 * mag)),
          "dist (a): the bf16 sum lies within bfloat16 rounding of the "
          "float32 sum")
    rel = float((err / mag.clamp(min=1e-30)).max())
    out["bf16_max_rel_err"] = rel
    log(f"dist (a): D = {D} on {dev}: histogram (NN = {nn}) and the "
        f"explicit, bits and pjit trees bit-equal to the one-device grower "
        f"on exact-grid statistics (explicit tree {out['explicit_tree_s']:.3f}"
        f" s, bits {out['bits_tree_s']:.3f} s); bf16 sum: largest error "
        f"{rel:.3e} of the cell's sum of |parts| (bound {2 * D * 2 ** -8:.3e})")
    return out


def dist_fit(label: str, config, data, y, mesh, **kw):
    """``train_distributed`` with a synced stamp a round.  Returns the
    result, its launch counts, its collectives and round wall times."""
    from repro_torch.distributed import sharding
    from repro_torch.distributed.trainer import train_distributed
    from repro_torch.kernels import _build

    _build.reset_launch_counts()
    sharding.reset_collective_stats()
    torch.cuda.synchronize()
    stamps = [time.perf_counter()]

    def stamp(t, m):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    res = train_distributed(config, data, y, mesh=mesh, callback=stamp, **kw)
    torch.cuda.synchronize()
    counts, coll = _build.launch_counts(), sharding.collective_stats()
    rounds = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    log(f"dist {label}: {len(rounds)} rounds on {res.stats['devices']}, "
        f"stats {json.dumps(res.stats)}")
    log(f"dist {label}: round wall ms "
        + json.dumps([round(r, 3) for r in rounds]))
    log(f"dist {label}: launches {json.dumps(counts)}; collectives "
        f"{json.dumps(coll)}")
    return res, counts, coll, rounds


def dist_contract(what: str, res, ref, binner, config, data, y,
                  rows: int) -> None:
    """(b)'s contract: round 0 under :func:`round0_contract`, the loss
    falling every round, every loss within rtol 1e-4 of ``ref``'s."""
    loss, ref_loss = res.history["train_loss"], ref.history["train_loss"]
    log(f"{what}: loss {loss}; reference {ref_loss}")
    K = res.model.n_classes
    a, b = res.model.trees, ref.model.trees
    if torch.equal(a.feature[:K], b.feature[:K]):
        d = (a.leaf_value[:K] - b.leaf_value[:K]).abs()
        log(f"{what}: round 0's fields equal; largest leaf difference "
            f"{float(d.max()):.3e}, relative "
            f"{float((d / b.leaf_value[:K].abs().clamp(min=1e-30)).max()):.3e}")
    check(all(b < a for a, b in zip(loss, loss[1:])),
          f"{what}: the loss falls every round")
    round0_contract(what, res.model, ref.model, binner,
                    stream_ties(config, data, y, rows,
                                data.codes_cm.device))
    check(bool(np.allclose(loss, ref_loss, rtol=1e-4, atol=0)),
          f"{what}: losses within rtol 1e-4 of the reference's")


def dist_level(data, D: int, dev, smi: str) -> dict:
    """(f): one level at NN = 32 of the sharded grower on real statistics,
    its parts timed apart by CUDA events behind a sleep kernel (device
    time): the shards' histograms, the sum on the first device, the split
    search and the shards' partitions; the level's host wall time; and the
    collective bytes ``collective_stats()`` counts for it."""
    from repro_torch.core import tree as tree_mod
    from repro_torch.distributed import sharding
    from repro_torch.kernels import ops

    mesh = dist_mesh(D, dev)
    placed = sharding.shard_dataset(data, mesh)
    nn, level = 2 ** (DEPTH - 1), DEPTH - 1
    gen = torch.Generator(device=dev).manual_seed(8)
    n_l = placed.n_pad // D
    g = [torch.randn((1, n_l), generator=gen, device=dev) for _ in range(D)]
    h = [torch.rand((1, n_l), generator=gen, device=dev) for _ in range(D)]
    nid = [torch.randint(0, nn, (1, n_l), generator=gen, device=dev,
                         dtype=torch.int32) for _ in range(D)]
    kw = grower_args(data, dev)
    n_int, n_leaf = 2 ** DEPTH - 1, 2 ** DEPTH

    def state():
        i32 = dict(dtype=torch.int32, device=dev)
        return (torch.full((1, n_int), -1, **i32),
                torch.zeros((1, n_int), **i32),
                torch.zeros((1, n_int), **i32),
                torch.zeros((1, n_int), **i32),
                torch.zeros((1, n_leaf), device=dev),
                torch.zeros((1, n_leaf), dtype=torch.bool, device=dev))

    def one_level(ev=None):
        mark = (lambda i: ev[i].record()) if ev else (lambda i: None)
        mark(0)
        parts = [ops.build_histogram(s.codes, gg, hh, ii, n_nodes=nn,
                                     n_bins=N_BINS)
                 for s, gg, hh, ii in zip(placed.shards, g, h, nid)]
        mark(1)
        hist = sharding.psum_parts(parts, dev)
        mark(2)
        st, _, _ = tree_mod._decide_level(
            hist, level, DEPTH, state(), kw["is_cat_field"],
            kw["field_mask"], 1.0, 0.0, 1.0)
        mark(3)
        tables = [t[:, nn - 1:2 * nn - 1] for t in st[:4]]
        for s, ii in zip(placed.shards, nid):
            ops.partition_level_cm(ii, s.codes_cm, *tables,
                                   missing_bin=data.missing_bin)
        mark(4)

    one_level()
    torch.cuda.synchronize()
    spans = {k: [] for k in ("hist_ms", "reduce_ms", "split_ms",
                             "partition_ms", "level_device_ms",
                             "level_wall_ms")}
    for _ in range(5):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        torch.cuda._sleep(HOLD_CYCLES)
        one_level(ev)
        ev[4].synchronize()
        for k, (a, b) in zip(("hist_ms", "reduce_ms", "split_ms",
                              "partition_ms", "level_device_ms"),
                             ((0, 1), (1, 2), (2, 3), (3, 4), (0, 4))):
            spans[k].append(ev[a].elapsed_time(ev[b]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_level()
        torch.cuda.synchronize()
        spans["level_wall_ms"].append((time.perf_counter() - t0) * 1e3)
    out = {k: statistics.median(v) for k, v in spans.items()}
    sharding.reset_collective_stats()
    one_level()
    out["collectives"] = sharding.collective_stats()
    out["hist_bytes_a_shard"] = nn * data.n_fields * N_BINS * 2 * 4
    log(f"dist (f) level NN = {nn} at D = {D} on {dev}: shards' histograms "
        f"{out['hist_ms']:.3f} ms, sum {out['reduce_ms']:.3f} ms, split "
        f"search {out['split_ms']:.3f} ms, partitions "
        f"{out['partition_ms']:.3f} ms (device {out['level_device_ms']:.3f} "
        f"ms, host wall {out['level_wall_ms']:.3f} ms); collectives "
        f"{json.dumps(out['collectives']['all-reduce'])} (a shard's "
        f"histogram {out['hist_bytes_a_shard']} B)  [{smi}]")
    return out


def dist_cli(seed: int, dev, smi: str) -> dict:
    """(e): the CLIs as subprocesses on the card.  ``launch.train`` on
    1,000,000 Higgs-shaped records (28 fields, 256 bins): an uninterrupted
    run, and one given SIGTERM after its first checkpoint, which must exit
    with code 75 and then finish with ``--resume`` within (b)'s contract
    of the uninterrupted run; ``launch.serve --mode gbdt`` beside them,
    whose zero-retrace and zero-drop lines must read OK."""
    import os
    import shutil
    import signal
    import types

    from repro_torch.api import serialize
    from repro_torch.core.gbdt import GBDTConfig
    from repro_torch.data import paper_dataset
    from repro_torch.distributed.fault import StepJournal

    base = ROOT / "build" / "smoke_cli"
    shutil.rmtree(base, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    train_cmd = [sys.executable, "-m", "repro_torch.launch.train",
                 "--records", str(CLI_RECORDS), "--trees", str(CLI_TREES),
                 "--depth", str(DEPTH), "--max-bins", str(N_BINS),
                 "--ckpt-every", str(CLI_CKPT_EVERY), "--seed", str(seed)]

    def start(cmd):
        return subprocess.Popen(cmd, env=env, cwd=ROOT, text=True,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE)

    def history(text):
        line = [ln for ln in text.splitlines()
                if ln.startswith("[train] history")][-1]
        return json.loads(line.split(" ", 2)[2])["train_loss"]

    t0 = time.perf_counter()
    procs = {"full": start(train_cmd + ["--ckpt-dir", str(base / "full")]),
             "cut": start(train_cmd + ["--ckpt-dir", str(base / "cut")]),
             "serve": start([sys.executable, "-m",
                             "repro_torch.launch.serve", "--mode", "gbdt",
                             "--model-dir", str(base / "serve"),
                             "--requests", "16"])}
    outs = {}
    try:
        journal = StepJournal(str(base / "cut" / "journal.jsonl"))
        deadline = time.monotonic() + 300
        while (journal.last_step() is None
               and procs["cut"].poll() is None
               and time.monotonic() < deadline):
            time.sleep(0.002)
        procs["cut"].send_signal(signal.SIGTERM)
        for name, p in procs.items():
            outs[name] = p.communicate(timeout=300)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for name, p in procs.items():
        tail = "\n".join((outs[name][0] + outs[name][1]).splitlines()[-6:])
        log(f"dist (e) {name}: exit {p.returncode}; last lines:\n{tail}")
    check(procs["full"].returncode == 0, "dist (e): the uninterrupted CLI "
          "run exits 0")
    check(procs["cut"].returncode == 75, "dist (e): SIGTERM after the first "
          "checkpoint exits with code 75")
    check(procs["serve"].returncode == 0
          and "(zero silent drops: OK)" in outs["serve"][0]
          and "zero retraces across hot-swap: OK" in outs["serve"][0],
          "dist (e): launch.serve --mode gbdt prints zero retraces and zero "
          "silent drops as OK")
    resumed = subprocess.run(train_cmd + ["--ckpt-dir", str(base / "cut"),
                                          "--resume"], env=env, cwd=ROOT,
                             capture_output=True, text=True, timeout=300)
    log("dist (e) resume: exit "
        f"{resumed.returncode}; last lines:\n"
        + "\n".join((resumed.stdout + resumed.stderr).splitlines()[-4:]))
    check(resumed.returncode == 0, "dist (e): --resume finishes the fit")
    wall = time.perf_counter() - t0
    cut = history(outs["cut"][0])
    full = history(outs["full"][0])
    joined = cut + history(resumed.stdout)
    check(0 < len(cut) < CLI_TREES and len(joined) == CLI_TREES,
          "dist (e): the interrupted run committed part of the fit")
    est_cut, _ = serialize.load_checkpoint(str(base / "cut"), device=dev)
    est_full, _ = serialize.load_checkpoint(str(base / "full"), device=dev)
    X, y, _, _ = paper_dataset("higgs", n_override=CLI_RECORDS, seed=seed)
    binner = est_full.binner_
    data = binner.transform(X, device=dev)        # as the CLI bins it
    config = GBDTConfig(n_trees=CLI_TREES, max_depth=DEPTH,
                        learning_rate=0.1, objective="binary:logistic",
                        seed=seed)
    dist_contract("dist (e) CLI interrupted + resumed",
                  types.SimpleNamespace(model=est_cut.model_,
                                        history={"train_loss": joined}),
                  types.SimpleNamespace(model=est_full.model_,
                                        history={"train_loss": full}),
                  binner, config, data, y, CLI_RECORDS)
    log(f"dist (e): train CLI interrupted after {len(cut)} rounds, resumed "
        f"to {CLI_TREES}; serve CLI OK; {wall:.1f} s  [{smi}]")
    shutil.rmtree(base, ignore_errors=True)
    return {"cli_interrupted_after": len(cut), "cli_s": wall}


def distributed_path(paths: dict, dev, smi: str) -> dict:
    """Phase 8: the distributed trainer and the launch drivers on the card,
    on phase 3's Higgs-shaped and phase 3b's Covertype-shaped data.  Gates
    (a)-(e), timings (f); returns the kernel rows' ``dist_*`` numbers."""
    import dataclasses
    import shutil

    from repro_torch.core.inference import pad_trees, sharded_predict
    from repro_torch.distributed.trainer import DistributedConfig
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import cuda_devices, make_mesh
    from repro_torch.resilience import (DeviceOOMError, FaultInjector,
                                        RecoveryPolicy)

    t_phase = time.perf_counter()
    hg, cv = paths["higgs"], paths["cover"]
    config, data, y = hg["config"], hg["data"], hg["y"]
    n, D = data.n_records, DIST_SHARDS
    gen = torch.Generator(device=dev).manual_seed(31)
    out = {"exact": dist_exact(data, gen, dev)}

    # (b) 8 rounds at D = 1 and D = 4 against the host loop of phase 3
    fits = {}
    for d in (1, D):
        res, counts, coll, rounds = dist_fit(f"(b) Higgs D={d}", config,
                                             data, y, dist_mesh(d, dev))
        dist_contract(f"dist (b) Higgs D={d}", res, hg["res"], hg["binner"],
                      config, data, y, -(-n // d))
        check(counts["histogram"] == d * DEPTH * config.n_trees
              and counts["partition"] == d * DEPTH * config.n_trees
              and counts["traversal"] == 0,
              f"dist (b) D={d}: histogram and partition launched once a "
              "shard a level, step ⑤ a leaf lookup")
        fits[d] = dict(res=res, counts=counts, coll=coll,
                       steady_ms=statistics.median(rounds[1:]))
    log(f"dist (b): steady round D=1 {fits[1]['steady_ms']:.3f} ms, D={D} "
        f"{fits[D]['steady_ms']:.3f} ms, host loop {hg['steady_ms']:.3f} ms "
        f"({fits[D]['steady_ms'] / fits[1]['steady_ms']:.2f}x D=1)  [{smi}]")
    K = cv["config"].n_classes
    mres, mcounts, _, mrounds = dist_fit(
        f"(b) Covertype D={D}", cv["config"], cv["data"], cv["y"],
        dist_mesh(D, dev))
    dist_contract(f"dist (b) Covertype D={D}", mres, cv["res"],
                  cv["binner"], cv["config"], cv["data"], cv["y"],
                  -(-cv["data"].n_records // D))
    check(mcounts["histogram"] == D * DEPTH * cv["config"].n_trees,
          "dist (b) Covertype: histogram launched once a shard a level")
    out["cover_steady_ms"] = statistics.median(mrounds[1:])
    log(f"dist (b): Covertype K = {K} steady round D={D} "
        f"{out['cover_steady_ms']:.3f} ms, host loop {cv['steady_ms']:.3f} "
        f"ms  [{smi}]")
    cards = cuda_devices()
    if len(cards) > 1:
        cres, _, _, crounds = dist_fit(
            f"(b) Higgs on {len(cards)} cards", config, data, y,
            make_mesh((len(cards),), ("data",), devices=cards))
        dist_contract(f"dist (b) Higgs D={len(cards)} cards", cres,
                      hg["res"], hg["binner"], config, data, y,
                      -(-n // len(cards)))
        out["cards_steady_ms"] = statistics.median(crounds[1:])
    else:
        log("dist (b): one visible card: no fit on distinct cards")
    # a warm start of 2 rounds from the D = 4 model replays its margins
    warm, wcounts, _, _ = dist_fit(
        f"(b) Higgs D={D} warm start", dataclasses.replace(config,
                                                           n_trees=2),
        data, y, dist_mesh(D, dev), init_model=fits[D]["res"].model)
    loss = fits[D]["res"].history["train_loss"] + warm.history["train_loss"]
    check(warm.model.n_trees == config.n_trees + 2
          and wcounts["traversal"] == config.n_trees
          and all(b < a for a, b in zip(loss, loss[1:])),
          "dist (b): the warm start replays each round once (the ensemble "
          "at T = K) and the loss keeps falling")

    # (c) a worker lost at round 3 of the D = 4 fit, and one device OOM
    ck = ROOT / "build" / "smoke_dist"
    shutil.rmtree(ck, ignore_errors=True)
    t0 = time.perf_counter()
    lost, _, _, _ = dist_fit(
        f"(c) Higgs D={D}, a worker lost at round {DIST_FAULT_ROUND}",
        config, data, y, dist_mesh(D, dev),
        dist=DistributedConfig(checkpoint_dir=str(ck), checkpoint_every=2,
                               fault_injector=FaultInjector(
                                   (DIST_FAULT_ROUND,))))
    st = lost.stats
    check(st["remesh_events"] == [("shrink", DIST_FAULT_ROUND, D - 1)]
          and st["restarts"] == 1 and st["n_shards"] == D - 1
          and st["replayed_rounds"] == 1
          and lost.model.n_trees == config.n_trees,
          "dist (c): the mesh shrinks to 3 shards, restores the round-2 "
          "checkpoint and replays; the fit does not restart")
    ref3, _, _, _ = dist_fit("(c) Higgs D=3 uninterrupted", config, data, y,
                             dist_mesh(D - 1, dev))
    dist_contract("dist (c) after the shrink", lost, ref3, hg["binner"],
                  config, data, y, -(-n // (D - 1)))
    oom, _, _, _ = dist_fit(
        f"(c) Higgs D={D}, one device OOM", config, data, y,
        dist_mesh(D, dev),
        dist=DistributedConfig(fault_injector=FaultInjector(
            (2,), exc=DeviceOOMError)), recovery=RecoveryPolicy())
    check(oom.stats["oom_halvings"] == 1 and oom.stats["hist_slices"] == 2,
          "dist (c): the OOM doubles hist_slices, counted in stats")
    dist_contract("dist (c) after the OOM", oom, fits[D]["res"],
                  hg["binner"], config, data, y, -(-n // (2 * D)))
    shutil.rmtree(ck, ignore_errors=True)
    log(f"dist (c): {time.perf_counter() - t0:.3f} s")

    # (d) sharded_predict on a (1, 4) ("data", "model") mesh
    mesh14 = make_mesh((1, D), ("data", "model"), devices=[dev] * D)
    model = hg["res"].model
    padded = pad_trees(model, D)
    _build.reset_launch_counts()
    sp = sharded_predict(mesh14, padded, data.codes)
    sp_counts = _build.launch_counts()
    direct = model.predict_margin(data)
    torch.testing.assert_close(sp, direct, rtol=1e-6, atol=1e-6)
    check(sp_counts["ensemble"] == D, "dist (d): the ensemble launched once "
          "a shard")
    leaves = torch.randint(-64, 65, model.trees.leaf_value.shape,
                           generator=gen, device=dev) / 64
    dy = dataclasses.replace(model, base_margin=0.25, trees=(
        model.trees._replace(leaf_value=leaves)))
    check(torch.equal(sharded_predict(mesh14, pad_trees(dy, D), data.codes),
                      dy.predict_margin(data)),
          "dist (d): sharded_predict bit-equal to predict_margin on dyadic "
          "leaves")
    out["sharded_predict_ms"] = time_ms(
        lambda: sharded_predict(mesh14, padded, data.codes))
    out["predict_margin_ms"] = time_ms(lambda: model.predict_margin(data))
    log(f"dist (d): sharded_predict over (1, {D}) margins within rtol 1e-6 "
        f"(atol 1e-6) of predict_margin, bit-equal on dyadic leaves; "
        f"{out['sharded_predict_ms']:.3f} ms against "
        f"{out['predict_margin_ms']:.3f} ms  [{smi}]")

    # (e) the CLIs, (f) one level's parts
    out.update(dist_cli(1, dev, smi))
    out["level_d1"] = dist_level(data, 1, dev, smi)
    out["level_d4"] = dist_level(data, D, dev, smi)
    out["higgs_d1_steady_ms"] = fits[1]["steady_ms"]
    out["higgs_d4_steady_ms"] = fits[D]["steady_ms"]
    out["host_loop_steady_ms"] = hg["steady_ms"]
    out["round_collectives_d4"] = fits[D]["coll"]
    out["counts"] = dict(
        higgs=fits[D]["counts"], cover=mcounts, warm=wcounts,
        predict=sp_counts)
    torch.cuda.empty_cache()
    log(f"distributed phase: {time.perf_counter() - t_phase:.1f} s")
    return out


# --------------------------------------------------------------------------
# phase 9, the LM substrate's serving path
# --------------------------------------------------------------------------
BF16_FLOPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core rate
LM_SMOKE_STEPS = 8
# the bf16 decode's distance from the float32 forward over the bf16
# forward's: measured 0.88-1.13 (PERF.md); a wrong slot, position or
# mask reads 0.3 of the largest |logit|, several times the forward's
BF16_DRIFT = 1.5
# (arch, layers kept or None for all, batch, prompt, decode steps)
LM_FULL = (("minicpm-2b", None, 4, 512, 32),
           ("mamba2-370m", None, 4, 512, 32),
           ("mixtral-8x22b", 2, 2, 4160, 16))


def lm_extended(cfg, batch: dict, tokens) -> dict:
    """``batch`` with the decoded ``tokens`` (B, n) after its prompt."""
    full = dict(batch, tokens=torch.cat([batch["tokens"], tokens], dim=1))
    if cfg.mrope:
        b, s = full["tokens"].shape
        full["positions"] = torch.arange(s, device=tokens.device)[
            None, None].expand(3, b, s)
    return full


def lm_decode(cfg, model, batch: dict, steps: int, cache_dtype,
              tokens=None):
    """``prefill``, then ``steps`` decode steps fed the greedy tokens (or
    ``tokens`` (B, steps) where given).  Returns (prefill logits, each
    step's logits, the tokens fed, each step's time in ms on the card or
    None on the CPU)."""
    from repro_torch.models import lm

    s = batch["tokens"].shape[1]
    cuda = batch["tokens"].is_cuda
    logits, cache = lm.prefill(cfg, model, batch, cache_dtype=cache_dtype,
                               max_len=s + steps)
    pre, outs, fed, step_ms = logits, [], [], []
    for i in range(steps):
        tok = (logits.argmax(-1)[:, None] if tokens is None
               else tokens[:, i:i + 1])
        fed.append(tok)
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        logits, cache = lm.decode_step(cfg, model, cache, tok, s + i)
        if cuda:
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
        outs.append(logits)
    return pre, outs, torch.cat(fed, dim=1), (step_ms if cuda else None)


def lm_rel(got, want) -> float:
    """Largest |got - want| over the largest |want|."""
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max() / want.abs().max())


def lm_smoke_parity(seed: int, dev, smi: str) -> dict:
    """(a): the ten smoke configs on the card against the CPU."""
    from repro_torch.configs import ARCH_IDS, get_smoke
    from repro_torch.launch.serve import lm_batch
    from repro_torch.models import lm

    t0 = time.perf_counter()
    worst, least_gap = 0.0, float("inf")
    for arch in ARCH_IDS:
        cfg = get_smoke(arch)
        cpu = lm.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
        card = lm.init_params(cfg, torch.Generator().manual_seed(seed), dev)
        s = cfg.sliding_window + 8 if cfg.sliding_window else 16
        batch = lm_batch(cfg, 2, s, seed, "cpu")
        pre, outs, toks, _ = lm_decode(cfg, cpu, batch, LM_SMOKE_STEPS,
                                       torch.float32)
        gpre, gouts, _, _ = lm_decode(
            cfg, card, {k: v.to(dev) for k, v in batch.items()},
            LM_SMOKE_STEPS, torch.float32, tokens=toks.to(dev))
        errs = []
        for i, (want, got) in enumerate(zip([pre] + outs, [gpre] + gouts)):
            errs.append(lm_rel(got, want))
            top2 = want.topk(2, dim=-1).values
            least_gap = min(least_gap, float(
                (top2[:, 0] - top2[:, 1]).min() / want.abs().max()))
            check(torch.equal(got.argmax(-1).cpu(), want.argmax(-1)),
                  f"lm (a) {arch}: the card's greedy token equals the "
                  f"CPU's at step {i}")
        check(max(errs) <= 1e-4, f"lm (a) {arch}: card within 1e-4 of the "
              f"CPU's largest |logit| (got {max(errs):.3e})")
        worst = max(worst, max(errs))
        log(f"lm (a) {arch}: prefill + {LM_SMOKE_STEPS} steps, largest "
            f"error {max(errs):.3e} of the largest |logit|, tokens equal")
    wall = time.perf_counter() - t0
    log(f"lm (a): ten smoke configs, card against CPU within {worst:.3e} "
        f"(bound 1e-4), greedy tokens identical (least top-2 gap "
        f"{least_gap:.3e}); {wall:.1f} s  [{smi}]")
    return {"smoke_worst_rel_err": worst, "smoke_least_gap": least_gap}


def lm_weight_bytes(model, cdt, routed=None) -> int:
    """Bytes of the weights one decode step reads in ``cdt``: every
    block's (cast) weights, the final norm and the cast embedding table
    for the logits.  The capacity dispatch runs every expert; with
    ``routed`` (the distinct experts the step's tokens pick, one count a
    MoE layer in layer order) only those experts' weights count."""
    blocks, embed = model.casts(cdt)

    def leaves(d):
        for v in d.values():
            yield from (leaves(v) if isinstance(v, dict) else (v,))

    def size(t):
        return t.numel() * t.element_size()
    n = sum(size(t) for b in blocks for t in leaves(b))
    if routed is not None:
        moes = [b["ffn"] for b in blocks if "router" in b.get("ffn", {})]
        check(len(moes) == len(routed), "lm (d): one routing count a MoE "
              "layer")
        for f, used in zip(moes, routed):
            e = f["router"].shape[1]
            n -= (e - used) * sum(size(f[w]) for w in
                                  ("w_in", "w_gate", "w_out")) // e
    return n + size(embed) + size(model.final_norm)


def device_busy(fn) -> dict:
    """``fn`` once under ``torch.profiler``: the union of its device
    events (ms), their count, its kernels, and the four that take most
    device time (retaken up to PROFILE_ATTEMPTS times when a profile
    comes back without device events)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    for attempt in range(PROFILE_ATTEMPTS):
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if "CUDA" in str(getattr(e, "device_type", ""))]
        if events:
            break
        log(f"torch.profiler saw no device event (profile {attempt + 1} of "
            f"{PROFILE_ATTEMPTS})")
    check(bool(events), "torch.profiler saw device events")
    busy_us, reach = 0.0, -float("inf")
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in events):
        busy_us += max(0.0, b - max(a, reach))
        reach = max(reach, b)
    by_name: dict = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return {"device_ms": busy_us / 1e3, "device_events": len(events),
            "kernels": sum(1 for e in events
                           if "memcpy" not in e.name.lower()
                           and "memset" not in e.name.lower()),
            "top_kernels_ms": [(n[:60], t / 1e3) for n, t in top]}


def lm_step_profile(cfg, model, batch: dict, step_ms: float) -> dict:
    """One decode step of ``cfg`` under ``torch.profiler``, after a warm
    step that records the distinct experts its tokens route to in each
    MoE layer.  Returns the step's device time (the union of its device
    events), its kernel launches, the four kernels that take most device
    time, and the host's share of ``step_ms`` (the unprofiled median
    step, CUDA events): 1 - device time / ``step_ms``."""
    from repro_torch.models import lm

    s = batch["tokens"].shape[1]
    logits, cache = lm.prefill(cfg, model, batch, max_len=s + 2)
    tok = logits.argmax(-1)[:, None]
    routed, real = [], lm.moe_ffn

    def spy(p, x, *, top_k, **kw):
        probs = torch.softmax(x.reshape(-1, x.shape[-1]).float()
                              @ p["router"].float(), dim=-1)
        routed.append(torch.topk(probs, top_k, dim=-1).indices.unique()
                      .numel())
        return real(p, x, top_k=top_k, **kw)
    lm.moe_ffn = spy
    try:
        lm.decode_step(cfg, model, cache, tok, s)
    finally:
        lm.moe_ffn = real
    prof = device_busy(lambda: lm.decode_step(cfg, model, cache, tok, s + 1))
    return dict(prof, routed_experts=routed,
                host_share=1.0 - prof["device_ms"] / step_ms)


def lm_full_width(arch: str, n_layers, B: int, S: int, steps: int,
                  seed: int, dev, smi: str) -> dict:
    """(b) and (d) for one configuration at full width."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import lm_batch
    from repro_torch.models import lm

    cfg = get_arch(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    label = f"{arch}" + (f" cut to {n_layers} layers" if n_layers else "")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = lm.init_params(cfg, torch.Generator(dev).manual_seed(seed), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = lm_batch(cfg, B, S, seed, dev)
    out = {"config": label, "params": lm.param_count(cfg),
           "active_params": lm.active_param_count(cfg), "batch": B,
           "prompt": S, "steps": steps, "init_s": init_s}

    # bfloat16 compute, as configured: the warm-up prefill casts the weights
    check(cfg.compute_dtype == "bfloat16", f"lm (b) {label} computes in "
          "bfloat16 as configured")
    cdt = torch.bfloat16
    prefill_ms = time_ms(lambda: lm.prefill(cfg, model, batch,
                                            max_len=S + steps), reps=3)
    _, outs, toks, step_ms = lm_decode(cfg, model, batch, steps, cdt)
    fwd = lm.forward_train(cfg, model, lm_extended(cfg, batch, toks))
    dec_bf16 = [outs[0].float(), outs[-1].float()]
    fwd_bf16 = [fwd[:, S].float(), fwd[:, -1].float()]
    del fwd, outs
    out["peak_bytes_bf16"] = torch.cuda.max_memory_allocated()
    weight_bytes = lm_weight_bytes(model, cdt)
    flops = 2 * out["active_params"] * B * S
    out.update(
        prefill_ms=prefill_ms, prefill_tok_s=B * S / prefill_ms * 1e3,
        decode_step_ms=statistics.median(step_ms[1:]),
        decode_first_step_ms=step_ms[0], decode_weight_bytes=weight_bytes,
        decode_bound_ms=weight_bytes / HBM_BYTES_PER_S * 1e3,
        prefill_flops=flops,
        prefill_bound_ms=flops / BF16_FLOPS_PER_S * 1e3)
    prof = lm_step_profile(cfg, model, batch, out["decode_step_ms"])
    out["decode_profile"] = prof
    if cfg.n_experts:
        routed_bytes = lm_weight_bytes(model, cdt, prof["routed_experts"])
        out.update(decode_routed_weight_bytes=routed_bytes,
                   decode_routed_bound_ms=routed_bytes / HBM_BYTES_PER_S
                   * 1e3)

    # the float32-compute witness of the same weights, fed the same tokens
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    torch.cuda.reset_peak_memory_stats()
    _, outs, _, _ = lm_decode(cfg32, model, batch, steps, torch.float32,
                              tokens=toks)
    model.drop_casts()            # the forward pass casts a layer at a time
    fwd = lm.forward_train(cfg32, model, lm_extended(cfg32, batch, toks))
    ref = [fwd[:, S], fwd[:, -1]]
    ratios32 = [lm_rel(outs[0], ref[0]), lm_rel(outs[-1], ref[1])]
    out["peak_bytes_f32_witness"] = torch.cuda.max_memory_allocated()
    # bf16: decode against the bf16 forward pass, and both against the
    # float32 forward pass (the bf16 forward's distance is bf16's own
    # rounding at this depth)
    ratios = [lm_rel(d, f) for d, f in zip(dec_bf16, fwd_bf16)]
    fwd_err = [lm_rel(f, r) for f, r in zip(fwd_bf16, ref)]
    dec_err = [lm_rel(d, r) for d, r in zip(dec_bf16, ref)]
    del fwd, outs, ref
    model.drop_casts()
    out.update(decode_f32_ratios=ratios32, decode_bf16_ratios=ratios,
               bf16_forward_vs_f32=fwd_err, bf16_decode_vs_f32=dec_err)
    check(max(ratios32) < 5e-3, f"lm (b) {label}: float32 decode within "
          f"5e-3 of the forward pass at steps 0 and last (got {ratios32})")
    check(all(d <= BF16_DRIFT * f for d, f in zip(dec_err, fwd_err)),
          f"lm (b) {label}: bf16 decode within {BF16_DRIFT} x the bf16 "
          f"forward pass's distance from the float32 forward (decode "
          f"{dec_err}, forward {fwd_err})")
    out["wall_s"] = time.perf_counter() - t0
    log(f"lm (b) {label}: {out['params']:,} params ({out['active_params']:,}"
        f" active), {cfg.param_dtype} weights; decode vs forward at steps "
        f"0 and {steps - 1}: float32 {ratios32[0]:.3e}, {ratios32[1]:.3e} "
        f"(bound 5e-3); bf16 {ratios[0]:.3e}, {ratios[1]:.3e} (not gated); "
        f"against the float32 forward: bf16 decode "
        f"{dec_err[0]:.3e}, {dec_err[1]:.3e}, bf16 forward {fwd_err[0]:.3e}"
        f", {fwd_err[1]:.3e} (bound: decode <= {BF16_DRIFT} x forward)  "
        f"[{smi}]")
    log(f"lm (d) {label}: prefill {B}x{S} {prefill_ms:.3f} ms "
        f"({out['prefill_tok_s']:.0f} tok/s; FLOP bound "
        f"{out['prefill_bound_ms']:.3f} ms = 2 x active params x tokens / "
        f"989 TFLOP/s); decode step median {out['decode_step_ms']:.3f} ms "
        f"(first {step_ms[0]:.3f}; byte bound {out['decode_bound_ms']:.3f} "
        f"ms = {weight_bytes:,} weight bytes / 3.35 TB/s); peak memory "
        f"{out['peak_bytes_bf16'] / 2**30:.2f} GiB bf16, "
        f"{out['peak_bytes_f32_witness'] / 2**30:.2f} GiB float32 witness; "
        f"{out['wall_s']:.1f} s  [{smi}]")
    if cfg.n_experts:
        log(f"lm (d) {label}: the step's tokens route to "
            f"{prof['routed_experts']} distinct experts a layer: byte bound "
            f"{out['decode_routed_bound_ms']:.3f} ms = "
            f"{out['decode_routed_weight_bytes']:,} bytes of the routed "
            f"experts' and the other weights / 3.35 TB/s  [{smi}]")
    log(f"lm (d) {label}: one decode step profiled: {prof['kernels']} "
        f"kernels, {prof['device_events']} device events, device time "
        f"{prof['device_ms']:.3f} ms of the {out['decode_step_ms']:.3f} ms "
        f"median step, host share {prof['host_share']:.3f}; most device "
        f"time: {prof['top_kernels_ms']}  [{smi}]")
    del model
    torch.cuda.empty_cache()
    return out


def lm_cli(smi: str) -> dict:
    """(c): ``launch.serve --mode lm`` as a subprocess on the card."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          "--mode", "lm", "--arch", "qwen3-14b",
                          "--prompt-len", "16", "--gen", "8"],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    wall = time.perf_counter() - t0
    log(f"lm (c) serve --mode lm: exit {res.returncode}; last lines:\n"
        + "\n".join((res.stdout + res.stderr).splitlines()[-4:]))
    check(res.returncode == 0 and "[serve] prefill 4x16" in res.stdout
          and "[serve] decoded 7 steps x 4 seqs (greedy)" in res.stdout
          and "on cuda" in res.stdout,
          "lm (c): launch.serve --mode lm exits 0 with its prefill and "
          "decode lines, on the card")
    log(f"lm (c): {wall:.1f} s  [{smi}]")
    return {"cli_s": wall}


def lm_path(seed: int, dev, smi: str) -> dict:
    """Phase 9, with TF32 off for the parity gates."""
    t_phase = time.perf_counter()
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    flags = (mm.allow_tf32, cudnn.allow_tf32)
    mm.allow_tf32 = cudnn.allow_tf32 = False
    try:
        out = lm_smoke_parity(seed, dev, smi)
        out["full"] = [lm_full_width(arch, n, B, S, steps, seed, dev, smi)
                       for arch, n, B, S, steps in LM_FULL]
        out.update(lm_cli(smi))
    finally:
        mm.allow_tf32, cudnn.allow_tf32 = flags
    out["card"] = smi
    log("lm summary " + json.dumps(out))
    log(f"lm phase: {time.perf_counter() - t_phase:.1f} s")
    return out


# --------------------------------------------------------------------------
# phase 10, LM training
# --------------------------------------------------------------------------
LM_TRAIN_STEPS = 10               # (b), (d): steps on one fixed batch
LM_TRAIN_LR = 3e-4                # their AdamW base rate (warmup 2)
LM_SMOKE_TRAIN_STEPS = 3          # (a): steps held card against CPU
LM_BLOCKS = 8                     # (c): vocab chunks of the blocked loss
# (arch, layers kept or None for all, batch, sequence, f32 witness and
# the remat and blocked-loss study of (c))
LM_TRAIN_FULL = (("minicpm-2b", None, 4, 512, True),
                 ("mamba2-370m", None, 4, 512, False),
                 ("mixtral-8x22b", 1, 1, 4160, False))


def lm_zero_leaf(cfg, name: str) -> bool:
    """A leaf whose gradient is zero in exact arithmetic (rounding noise
    of no scale of its own in both runs): a key bias that no RoPE
    rotates (the softmax cancels a shift of a query's logits), or the
    router at top_k 1 without the aux loss (the renormalized weight is
    1).  Held below 1e-7 of the model's largest |g| instead."""
    leaf = name.rsplit(".", 1)[-1]
    unrotated = (not cfg.rope or ".xattn." in name
                 or name.startswith("enc_blocks"))
    return (leaf == "bk" and unrotated) or (
        leaf == "router" and cfg.top_k == 1 and not cfg.moe_aux_weight)


def lm_grads(cfg, model, batch, loss=None):
    """The loss ``loss`` (default ``lm.loss_fn``) and its gradients at the
    module's weights, timed (CUDA events) with its memory read: (the loss
    as a 0-d tensor, {name: gradient}, {ms, the memory the forward pass
    holds for the backward pass, the peak, the peak over what was
    allocated before}).  Leaves no ``.grad`` behind."""
    from repro_torch.models import lm

    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = (loss or lm.loss_fn)(cfg, model, batch)
    held = torch.cuda.memory_allocated() - base
    out.backward()
    end.record()
    end.synchronize()
    grads = {n: p.grad for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    peak = torch.cuda.max_memory_allocated()
    return out.detach(), grads, {
        "ms": start.elapsed_time(end), "forward_held_bytes": held,
        "peak_bytes": peak, "peak_over_base_bytes": peak - base}


def lm_grad_err(cfg, got: dict, want: dict) -> float:
    """The largest leaf error over the leaf's largest |g| (leaves of
    ``lm_zero_leaf`` checked below 1e-7 of the model's largest |g|)."""
    top = max(float(w.abs().max()) for w in want.values())
    worst = 0.0
    for name, w in want.items():
        g = got[name].to(w.device).float()
        w = w.float()
        if lm_zero_leaf(cfg, name):
            check(float(g.abs().max()) < 1e-7 * top
                  and float(w.abs().max()) < 1e-7 * top,
                  f"lm train: {name} is rounding noise in both runs")
            continue
        worst = max(worst, float((g - w).abs().max() / w.abs().max()))
    return worst


def lm_train_smoke(seed: int, dev, smi: str) -> dict:
    """(a): the ten smoke configs on the card against the CPU, and the
    three remat policies on the card."""
    import dataclasses

    from repro_torch.configs import ARCH_IDS, get_smoke
    from repro_torch.data.pipeline import token_batches
    from repro_torch.launch.train import lm_train_batch
    from repro_torch.models import lm, optim

    t0 = time.perf_counter()
    worst = {"loss": 0.0, "grad": 0.0, "steps": 0.0, "remat": 0.0}
    for arch in ARCH_IDS:
        cfg = get_smoke(arch)
        runs = [(d, lm.init_params(cfg, torch.Generator().manual_seed(seed),
                                   d)) for d in ("cpu", dev)]
        arrays = next(token_batches(np.random.default_rng(seed), cfg.vocab,
                                    2, 16, 1))
        batches = [lm_train_batch(cfg, arrays, d) for d, _ in runs]
        (l_cpu, g_cpu, _), (l_dev, g_dev, _) = (
            lm_grads(cfg, model, b) for (_, model), b in zip(runs, batches))
        loss_err = abs(float(l_dev) - float(l_cpu)) / abs(float(l_cpu))
        grad_err = lm_grad_err(cfg, g_dev, g_cpu)
        check(loss_err <= 1e-5, f"lm train (a) {arch}: card loss within "
              f"rtol 1e-5 of the CPU's (got {loss_err:.3e})")
        check(grad_err <= 1e-4, f"lm train (a) {arch}: card gradients "
              f"within 1e-4 of each leaf's largest |g| (got {grad_err:.3e})")
        remat_err = 0.0
        for over in ({"remat": False}, {"remat_policy": "dots"}):
            l_p, g_p, _ = lm_grads(dataclasses.replace(cfg, **over),
                                   runs[1][1], batches[1])
            remat_err = max(remat_err,
                            abs(float(l_p) - float(l_dev))
                            / abs(float(l_dev)),
                            lm_grad_err(cfg, g_p, g_dev))
        check(remat_err <= 1e-6, f"lm train (a) {arch}: remat off and "
              f"\"dots\" within 1e-6 of \"full\" (got {remat_err:.3e})")
        losses = []
        for d, model in runs:
            step = lm.make_train_step(cfg, base_lr=1e-3, warmup=2,
                                      total_steps=LM_SMOKE_TRAIN_STEPS)
            opt = optim.adamw_init(model)
            out = []
            for arr in token_batches(np.random.default_rng(seed + 1),
                                     cfg.vocab, 2, 16, LM_SMOKE_TRAIN_STEPS):
                model, opt, m = step(model, opt, lm_train_batch(cfg, arr, d))
                out.append(float(m["loss"]))
            losses.append(out)
        step_err = max(abs(a - b) / abs(b) for a, b in zip(*losses[::-1]))
        check(step_err <= 1e-4, f"lm train (a) {arch}: "
              f"{LM_SMOKE_TRAIN_STEPS} train-step losses on the card within "
              f"rtol 1e-4 of the CPU's (got {step_err:.3e})")
        for key, v in (("loss", loss_err), ("grad", grad_err),
                       ("steps", step_err), ("remat", remat_err)):
            worst[key] = max(worst[key], v)
        log(f"lm train (a) {arch}: loss {float(l_dev):.6f} (card vs CPU "
            f"{loss_err:.2e}), gradients {grad_err:.2e}, remat "
            f"{remat_err:.2e}, {LM_SMOKE_TRAIN_STEPS} steps {step_err:.2e}")
    wall = time.perf_counter() - t0
    log(f"lm train (a): ten smoke configs, card against CPU: loss "
        f"{worst['loss']:.3e} (bound 1e-5), gradients {worst['grad']:.3e} "
        f"(1e-4), train steps {worst['steps']:.3e} (1e-4); remat policies "
        f"{worst['remat']:.3e} (1e-6); {wall:.1f} s  [{smi}]")
    return {f"smoke_{k}_err": v for k, v in worst.items()}


def lm_remat_study(cfg, model, batch, smi: str) -> dict:
    """(c), first half: loss and gradients at B 1 under remat off, "full"
    and "dots" (each run twice, the second measured): time, the memory
    the forward pass holds, the peak, and the gradients against remat
    off's."""
    import dataclasses

    out, ref = {}, None
    for policy, over in (("off", {"remat": False}), ("full", {}),
                         ("dots", {"remat_policy": "dots"})):
        c = dataclasses.replace(cfg, **over)
        lm_grads(c, model, batch)
        loss, grads, row = lm_grads(c, model, batch)
        row["loss"] = float(loss)
        if ref is None:
            ref = grads
        else:
            row["grad_err"] = lm_grad_err(cfg, grads, ref)
            check(row["grad_err"] <= 1e-4, f"lm train (c) remat {policy}: "
                  f"gradients within 1e-4 of remat off's (got "
                  f"{row['grad_err']:.3e})")
        del grads
        out[policy] = row
        log(f"lm train (c) {cfg.name} B {batch['tokens'].shape[0]} x "
            f"{batch['tokens'].shape[1]} remat {policy}: loss and backward "
            f"{row['ms']:.3f} ms, the forward holds "
            f"{row['forward_held_bytes'] / 2**30:.3f} GiB, peak "
            f"{row['peak_bytes'] / 2**30:.2f} GiB "
            f"({row['peak_over_base_bytes'] / 2**30:.2f} over what was "
            f"allocated before), gradients against remat off "
            f"{row.get('grad_err', 0.0):.3e}  [{smi}]")
    return out


def lm_blocked_study(cfg, model, batch, smi: str) -> dict:
    """(c), second half: ``loss_fn_blocked`` against ``loss_fn`` in the
    float32 witness; loss and backward, measured as in the remat study."""
    import dataclasses
    import functools

    from repro_torch.models import lm

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    out = {}
    for name, fn in (("plain", lm.loss_fn),
                     ("blocked", functools.partial(lm.loss_fn_blocked,
                                                   n_blocks=LM_BLOCKS))):
        loss, grads, row = lm_grads(cfg32, model, batch, loss=fn)
        del grads
        out[name] = dict(row, loss=float(loss))
    plain, blocked = out["plain"], out["blocked"]
    rel = abs(blocked["loss"] - plain["loss"]) / abs(plain["loss"])
    out["loss_rel"] = rel
    b, s = batch["tokens"].shape
    log(f"lm train (c) {cfg.name} B {b} x {s}, float32 witness: blocked "
        f"loss ({LM_BLOCKS} chunks of {cfg.vocab_padded // LM_BLOCKS:,}) "
        f"{blocked['loss']:.6f} against {plain['loss']:.6f} (rel "
        f"{rel:.2e}, bound 1e-5); loss and backward {blocked['ms']:.3f} ms "
        f"against {plain['ms']:.3f}; the forward holds "
        f"{blocked['forward_held_bytes'] / 2**30:.3f} GiB against "
        f"{plain['forward_held_bytes'] / 2**30:.3f}; peak "
        f"{blocked['peak_bytes'] / 2**30:.2f} GiB against "
        f"{plain['peak_bytes'] / 2**30:.2f}  [{smi}]")
    check(rel <= 1e-5, "lm train (c): the blocked loss within 1e-5 of "
          "loss_fn's in the float32 witness")
    check(blocked["peak_bytes"] < plain["peak_bytes"],
          "lm train (c): the blocked loss's peak below loss_fn's")
    return out


def lm_train_full(arch: str, n_layers, B: int, S: int, study: bool,
                  seed: int, dev, smi: str) -> dict:
    """(b) (with the float32 witness and (c) where ``study``) and (d) for
    one configuration at full width."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import token_batches
    from repro_torch.launch.train import lm_train_batch
    from repro_torch.models import lm, optim

    cfg = get_arch(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    label = f"{arch}" + (f" cut to {n_layers} layer" if n_layers else "")
    t0 = time.perf_counter()
    model = lm.init_params(cfg, torch.Generator(dev).manual_seed(seed), dev)
    arrays = next(token_batches(np.random.default_rng(seed), cfg.vocab, B,
                                S, 1))
    batch = lm_train_batch(cfg, arrays, dev)
    params, active = lm.param_count(cfg), lm.active_param_count(cfg)
    out = {"config": label, "params": params, "active_params": active,
           "batch": B, "seq": S, "steps": LM_TRAIN_STEPS,
           "schedule": cfg.lr_schedule, "param_dtype": cfg.param_dtype,
           "compute_dtype": cfg.compute_dtype, "remat": cfg.remat,
           "remat_policy": cfg.remat_policy}
    check(cfg.compute_dtype == "bfloat16" and cfg.remat
          and cfg.remat_policy == "full", f"lm train {label}: bf16 compute "
          "and remat \"full\", as configured")
    if study:
        # step 0 against the float32-compute witness of the same weights
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        l32, g32, _ = lm_grads(cfg32, model, batch)
        l16, g16, _ = lm_grads(cfg, model, batch)
        dot = n32 = n16 = 0.0
        for name, a in g32.items():
            a, b = a.double(), g16[name].double()
            dot += float((a * b).sum())
            n32 += float((a * a).sum())
            n16 += float((b * b).sum())
        del g32, g16
        cos = dot / (n32 * n16) ** 0.5
        loss_rel = abs(float(l16) - float(l32)) / abs(float(l32))
        out.update(witness_loss_f32=float(l32), witness_loss_bf16=float(l16),
                   witness_loss_rel=loss_rel, witness_grad_cosine=cos)
        log(f"lm train (b) {label}: step 0 bf16 against the float32 "
            f"witness: loss {float(l16):.6f} vs {float(l32):.6f} (rel "
            f"{loss_rel:.3e}, bound 1e-2), gradient cosine {cos:.6f} "
            f"(bound 0.99)  [{smi}]")
        check(loss_rel <= 1e-2, f"lm train (b) {label}: bf16 loss within "
              "1e-2 of the float32 witness's")
        check(cos >= 0.99, f"lm train (b) {label}: gradient cosine >= 0.99 "
              "against the float32 witness")

    step = lm.make_train_step(cfg, base_lr=LM_TRAIN_LR, warmup=2,
                              total_steps=LM_TRAIN_STEPS)
    opt = optim.adamw_init(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events, metrics = [], []
    for _ in range(LM_TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        model, opt, m = step(model, opt, batch)
        end.record()
        events.append((start, end))
        metrics.append(m)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    step_ms = [a.elapsed_time(b) for a, b in events]
    losses = [float(m["loss"]) for m in metrics]
    gnorms = [float(m["gnorm"]) for m in metrics]
    lrs = [float(m["lr"]) for m in metrics]
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
          f"lm train {label}: every loss and gradient norm finite")
    check(losses[-1] < losses[0], f"lm train {label}: the loss falls "
          f"({losses[0]:.4f} -> {losses[-1]:.4f})")
    if study:
        check(abs(losses[0] - out["witness_loss_bf16"])
              <= 1e-6 * abs(losses[0]), f"lm train (b) {label}: the first "
              "step's loss is the bf16 loss of the same weights")
    # the step's parts, apart: loss and backward, then the update
    lm_grads(cfg, model, batch)
    fwd_bwd_ms = lm_grads(cfg, model, batch)[2]["ms"]
    model.zero_grad(set_to_none=True)
    lm.loss_fn(cfg, model, batch).backward()
    opt_ms = time_ms(lambda: optim.adamw_update(model, opt, lr=0.0), reps=3)
    prof = device_busy(lambda: step(model, opt, batch))
    median = statistics.median(step_ms[1:])
    tokens = B * S
    flops = 6 * active * tokens
    # AdamW reads p, g, m, v and writes p, m, v once (g in p's dtype)
    adamw_bytes = sum(p.numel() * (3 * p.element_size() + 16)
                      for p in model.parameters())
    out.update(
        losses=losses, gnorms=gnorms, lrs=lrs, step_ms=step_ms,
        step_median_ms=median, peak_bytes=peak, fwd_bwd_ms=fwd_bwd_ms,
        adamw_ms=opt_ms, tokens_per_s=tokens / median * 1e3,
        flop_bound_ms=flops / BF16_FLOPS_PER_S * 1e3,
        flop_bound_remat_ms=flops * 8 / 6 / BF16_FLOPS_PER_S * 1e3,
        adamw_bytes=adamw_bytes,
        adamw_bound_ms=adamw_bytes / HBM_BYTES_PER_S * 1e3,
        step_profile=dict(prof, host_share=1.0 - prof["device_ms"] / median))
    log(f"lm train {'(b)' if study else '(d)'} {label}: {params:,} params "
        f"({active:,} active), {cfg.param_dtype} weights, bf16 compute, "
        f"remat full, {cfg.lr_schedule}; B {B} x {S}, {LM_TRAIN_STEPS} steps "
        f"at base lr {LM_TRAIN_LR}: loss {losses[0]:.4f} -> {losses[-1]:.4f}"
        f", gnorm {gnorms[0]:.3f} -> {gnorms[-1]:.3f}; step median "
        f"{median:.3f} ms (first {step_ms[0]:.3f}; {out['tokens_per_s']:.0f} "
        f"tok/s), loss and backward {fwd_bwd_ms:.3f} ms, AdamW "
        f"{opt_ms:.3f} ms; peak {peak / 2**30:.2f} GiB; bounds: FLOP "
        f"{out['flop_bound_ms']:.3f} ms (6 x active params x tokens / 989 "
        f"TFLOP/s; {out['flop_bound_remat_ms']:.3f} with the forward that "
        f"remat repeats), AdamW bytes {out['adamw_bound_ms']:.3f} ms "
        f"({out['adamw_bytes']:,} B / 3.35 TB/s)  [{smi}]")
    log(f"lm train {label}: one step profiled: {prof['kernels']} kernels, "
        f"device time {prof['device_ms']:.3f} ms of the {median:.3f} ms "
        f"median step, host share {out['step_profile']['host_share']:.3f}; "
        f"most device time: {prof['top_kernels_ms']}  [{smi}]")
    if study:
        del opt
        model.zero_grad(set_to_none=True)
        torch.cuda.empty_cache()
        one = {k: v[:1] for k, v in batch.items()}
        out["remat_study"] = lm_remat_study(cfg, model, one, smi)
        torch.cuda.empty_cache()
        out["blocked_study"] = lm_blocked_study(cfg, model, batch, smi)
    out["wall_s"] = time.perf_counter() - t0
    log(f"lm train {label}: {out['wall_s']:.1f} s")
    del model, batch
    torch.cuda.empty_cache()
    return out


def lm_train_cli(smi: str) -> dict:
    """(e): ``launch.train --mode lm`` as a subprocess on the card."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          "--mode", "lm", "--arch", "qwen3-14b", "--trees",
                          "3"], env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    wall = time.perf_counter() - t0
    log(f"lm train (e) train --mode lm: exit {res.returncode}; last lines:\n"
        + "\n".join((res.stdout + res.stderr).splitlines()[-4:]))
    check(res.returncode == 0 and "[lm] step 0 loss " in res.stdout
          and "[lm] done: 3 steps on cuda" in res.stdout,
          "lm train (e): launch.train --mode lm exits 0 with its step-0 "
          "loss line, on the card")
    log(f"lm train (e): {wall:.1f} s  [{smi}]")
    return {"cli_s": wall}


def lm_train_path(seed: int, dev, smi: str) -> dict:
    """Phase 10, with TF32 off for the parity gates and the witness."""
    t_phase = time.perf_counter()
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    flags = (mm.allow_tf32, cudnn.allow_tf32)
    mm.allow_tf32 = cudnn.allow_tf32 = False
    try:
        out = lm_train_smoke(seed, dev, smi)
        out["full"] = [lm_train_full(arch, n, B, S, study, seed, dev, smi)
                       for arch, n, B, S, study in LM_TRAIN_FULL]
        out.update(lm_train_cli(smi))
    finally:
        mm.allow_tf32, cudnn.allow_tf32 = flags
    out["card"] = smi
    log("lm train summary " + json.dumps(out))
    log(f"lm train phase: {time.perf_counter() - t_phase:.1f} s")
    return out


# --------------------------------------------------------------------------
# phase 11, the dry runs held against the card
# --------------------------------------------------------------------------
DRYRUN_JOBS = 6                   # (c): cells traced at once
DRYRUN_RECORDS, DRYRUN_FIELDS = 200_000_000, 64   # the GBDT plan's dataset
DRYRUN_MESH_RECORDS, DRYRUN_MESH_FIELDS = 25_000_000, 8   # (b)'s (2, 2) mesh
DRYRUN_BYTES_BAND = (0.8, 1.25)   # (d): planned / measured peak memory


def dryrun_cli(module: str, *args, out=None, timeout: int = 300):
    """``python -m <module> args`` with the repository's ``src``; returns
    the finished process, or with ``out`` (a path) a running one writing
    there."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", module, *args]
    if out is not None:
        return subprocess.Popen(cmd, env=env, cwd=ROOT, text=True,
                                stdout=open(out, "w"),
                                stderr=subprocess.STDOUT)
    return subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                          text=True, timeout=timeout)


def dryrun_gbdt_plans(out_dir: Path, smi: str) -> dict:
    """(a): ``launch.dryrun_gbdt --mesh both`` for every variant."""
    from repro_torch.launch import dryrun_gbdt

    out = {}
    for variant in dryrun_gbdt.VARIANTS:
        res = dryrun_cli("repro_torch.launch.dryrun_gbdt", "--mesh", "both",
                         "--variant", variant, "--out", str(out_dir))
        check(res.returncode == 0, f"dryrun (a) dryrun_gbdt --variant "
              f"{variant} exits 0: {res.stdout[-500:]}{res.stderr[-2000:]}")
        for mesh in ("single", "multi"):
            rec = json.loads((out_dir / f"{mesh}_gbdt_{variant}.json")
                             .read_text())
            keep = ("records_per_card", "fields_per_card", "compute_s",
                    "memory_s", "collective_s", "dominant",
                    "collective_bytes_per_chip", "bytes_per_device")
            out[f"{mesh}_{variant}"] = {k: rec[k] for k in keep}
            links = sorted({c["link"] for c in rec["collective_links"]})
            log(f"dryrun (a) {mesh} {variant}: card "
                f"{rec['records_per_card']:,} x {rec['fields_per_card']}, "
                f"compute {rec['compute_s']:.3e} "
                f"s, memory {rec['memory_s']:.3e} s, collective "
                f"{rec['collective_s']:.3e} s over {','.join(links)} "
                f"({rec['collective_bytes_per_chip']:.4e} B), dominant "
                f"{rec['dominant']}, {rec['bytes_per_device']:,} B a card "
                "(plan: datasheet peaks)")
    return out


def timed_calls(names):
    """Patch ``ops.<name>`` for each name to record CUDA events around each
    call; returns (spans by name, restore)."""
    from repro_torch.kernels import ops

    spans = {n: [] for n in names}
    real = {n: getattr(ops, n) for n in names}

    def wrap(name):
        def timed(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            res = real[name](*a, **kw)
            end.record()
            spans[name].append((start, end))
            return res
        return timed

    for n in names:
        setattr(ops, n, wrap(n))
    return spans, lambda: [setattr(ops, n, f) for n, f in real.items()]


def dryrun_gbdt_witness(seed: int, dev, smi: str) -> dict:
    """(b): the single-pod plan's card shard grown on the card, level by
    level beside the plan; then the (2, 2) mesh's collectives against the
    plan's, exactly."""
    from repro_torch.core import tree as tree_mod
    from repro_torch.distributed import sharding
    from repro_torch.launch import dryrun_gbdt
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.mesh import make_mesh, meta_production_mesh

    plan = dryrun_gbdt.plan_levels(
        meta_production_mesh(False), n_records=DRYRUN_RECORDS,
        n_fields=DRYRUN_FIELDS, n_bins=N_BINS, depth=DEPTH,
        variant="explicit")
    n, F = plan["records_per_card"], plan["fields_per_card"]
    check((n, F) == (12_500_000, 4), "dryrun (b): the single-pod card holds "
          "12,500,000 records x 4 fields")
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    codes = torch.randint(0, N_BINS, (n, F), generator=gen, device=dev,
                          dtype=torch.uint8)
    g = torch.randn((1, n), generator=gen, device=dev)
    h = torch.rand((1, n), generator=gen, device=dev)
    kw = dict(depth=DEPTH, n_bins=N_BINS, missing_bin=N_BINS - 1,
              is_cat_field=torch.zeros(F, dtype=torch.bool, device=dev),
              field_mask=torch.ones(F, dtype=torch.bool, device=dev),
              lambda_=1.0, gamma=0.0, min_child_weight=1.0)

    codes_cm = codes.T.contiguous()

    def grow():
        return tree_mod.fit_forest(codes, codes_cm, g, h, **kw)

    grow()
    torch.cuda.synchronize()
    spans, restore = timed_calls(("build_histogram", "partition_level_cm"))
    try:
        tree = grow()
        torch.cuda.synchronize()
    finally:
        restore()
    check(bool(torch.isfinite(tree.leaf_value).all()), "dryrun (b): the "
          "card's tree has finite leaves")
    levels = []
    for lv, (hs, ps) in enumerate(zip(spans["build_histogram"],
                                      spans["partition_level_cm"])):
        want = plan["levels"][lv]
        row = {"level": lv, "hist_ms": hs[0].elapsed_time(hs[1]),
               "partition_ms": ps[0].elapsed_time(ps[1]),
               "plan_hist_ms": want["hist_memory_s"] * 1e3,
               "plan_partition_ms": want["partition_memory_s"] * 1e3}
        levels.append(row)
        log(f"dryrun (b) card shard {n:,} x {F}, level {lv} (NN = "
            f"{2 ** lv}): histogram {row['hist_ms']:.4f} ms, partition "
            f"{row['partition_ms']:.4f} ms (CUDA events, wrapper calls) "
            f"beside the plan's memory terms {row['plan_hist_ms']:.4f} and "
            f"{row['plan_partition_ms']:.4f} ms  [{smi}]")
    check(len(levels) == DEPTH, f"dryrun (b): {DEPTH} levels timed")
    del codes, codes_cm, g, h
    torch.cuda.empty_cache()

    # the (2, 2) mesh on the one card: collectives exactly as planned
    n, F = DRYRUN_MESH_RECORDS, DRYRUN_MESH_FIELDS
    mesh = make_mesh((2, 2), ("data", "model"), devices=[dev] * 4)
    codes = torch.randint(0, N_BINS, (n, F), generator=gen, device=dev,
                          dtype=torch.uint8)
    codes_cm = codes.T.contiguous()
    g = torch.randn((n,), generator=gen, device=dev)
    h = torch.rand((n,), generator=gen, device=dev)
    kw["is_cat_field"] = torch.zeros(F, dtype=torch.bool, device=dev)
    kw["field_mask"] = torch.ones(F, dtype=torch.bool, device=dev)
    mesh_out = {}
    for variant in dryrun_gbdt.VARIANTS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sharding.reset_collective_stats()
        if variant == "base":
            sharding.pjit_fit_tree(
                mesh, **{k: v for k, v in kw.items()
                         if k not in ("is_cat_field", "field_mask")})(
                codes, codes_cm, g, h, kw["is_cat_field"], kw["field_mask"])
        else:
            sharding.distributed_fit_tree(
                mesh, codes, codes_cm, g, h, partition_bits="bits" in variant,
                hist_dtype=torch.bfloat16 if "bf16" in variant else None,
                **kw)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        got = sharding.collective_stats()
        want = rl.by_kind(dryrun_gbdt.plan_collectives(
            dryrun_gbdt.plan_levels(mesh, n_records=n, n_fields=F,
                                    n_bins=N_BINS, depth=DEPTH,
                                    variant=variant)))
        mesh_out[variant] = {"collectives": got, "tree_wall_ms": wall}
        used = {k: v for k, v in got.items() if v["count"]}
        verdict = "equal" if got == want else "DIFFERENT: " + json.dumps(want)
        log(f"dryrun (b) (2, 2) mesh of {dev}, {n:,} x {F}, {variant}: "
            f"collectives {json.dumps(used)} (plan {verdict}); tree "
            f"{wall:.1f} ms host wall  [{smi}]")
        check(got == want, f"dryrun (b) {variant}: the (2, 2) mesh's "
              "collectives equal the plan's by kind, count and bytes")
    del codes, codes_cm, g, h
    torch.cuda.empty_cache()
    return {"levels": levels, "mesh": mesh_out}


def dryrun_lm_witness(seed: int, dev, smi: str) -> dict:
    """(d): minicpm-2b as phase 10 (b) trains it, planned on a (1, 1) meta
    mesh, then one real step on the card: FLOPs equal, the planned bytes a
    card within ``DRYRUN_BYTES_BAND`` of the measured peak."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_arch
    from repro_torch.configs.registry import ShapeConfig
    from repro_torch.data.pipeline import token_batches
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import meta_mesh
    from repro_torch.launch.train import lm_train_batch
    from repro_torch.models import lm, optim

    arch, _, B, S, _ = LM_TRAIN_FULL[0]
    cfg = get_arch(arch)
    shape = ShapeConfig(f"train_{S}", S, B, "train")
    t0 = time.perf_counter()
    trace = dryrun.trace_cell(cfg, shape, {})
    rec = dryrun.plan_cell(cfg, shape, meta_mesh((1, 1), ("data", "model")),
                           {}, trace)
    plan_s = time.perf_counter() - t0
    model = lm.init_params(cfg, torch.Generator(dev).manual_seed(seed), dev)
    arrays = next(token_batches(np.random.default_rng(seed), cfg.vocab, B,
                                S, 1))
    batch = lm_train_batch(cfg, arrays, dev)
    opt = optim.adamw_init(model)
    step = lm.make_train_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as fc:
        _, _, m = step(model, opt, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    flops = fc.get_total_flops()
    ratio = rec["bytes_per_device"] / peak
    out = {"config": arch, "batch": B, "seq": S, "plan_s": plan_s,
           "plan_flops": trace["flops"], "step_flops": flops,
           "plan_bytes_per_device": rec["bytes_per_device"],
           "plan_argument_bytes": rec["argument_size_in_bytes"],
           "plan_temp_bytes": rec["temp_size_in_bytes"],
           "peak_bytes": peak, "bytes_ratio": ratio,
           "loss": float(m["loss"])}
    log(f"dryrun (d) {arch} B {B} x {S}, remat {cfg.remat_policy}: plan on a "
        f"(1, 1) meta mesh in {plan_s:.1f} s; FLOPs plan {trace['flops']:,} "
        f"vs the card's step {flops:,} "
        f"({'equal' if flops == trace['flops'] else 'DIFFERENT'}); bytes a "
        f"card plan {rec['bytes_per_device']:,} (arguments "
        f"{rec['argument_size_in_bytes']:,}, saved "
        f"{rec['temp_size_in_bytes']:,}) "
        f"vs peak {peak:,} ({peak / 2**30:.2f} GiB): ratio {ratio:.4f} "
        f"(band {DRYRUN_BYTES_BAND})  [{smi}]")
    check(flops == trace["flops"], "dryrun (d): the card's step counts the "
          "meta plan's FLOPs exactly")
    check(DRYRUN_BYTES_BAND[0] <= ratio <= DRYRUN_BYTES_BAND[1],
          "dryrun (d): the planned bytes a card lie within "
          f"{DRYRUN_BYTES_BAND} of the step's peak memory")
    del model, opt, batch
    torch.cuda.empty_cache()
    return out


def dryrun_path(seed: int, dev, smi: str) -> dict:
    """Phase 11: the dry runs and the report, held against the card."""
    import shutil

    t_phase = time.perf_counter()
    out_dir = ROOT / "build" / "smoke_dryrun"
    shutil.rmtree(out_dir, ignore_errors=True)
    (out_dir / "lm").mkdir(parents=True)
    lm_log = out_dir / "lm.log"
    # (c) runs on the host's cores while (a), (b) and (d) go on
    t_lm = time.perf_counter()
    proc = dryrun_cli("repro_torch.launch.dryrun", "--arch", "all",
                      "--shape", "all", "--mesh", "both", "--jobs",
                      str(DRYRUN_JOBS), "--out", str(out_dir / "lm"),
                      out=lm_log)
    try:
        out = {"gbdt_plans": dryrun_gbdt_plans(out_dir, smi)}
        out["gbdt_witness"] = dryrun_gbdt_witness(seed, dev, smi)
        out["lm_witness"] = dryrun_lm_witness(seed, dev, smi)
        rc = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    lm_wall = time.perf_counter() - t_lm
    text = lm_log.read_text()
    lines = text.splitlines()
    n_ok = sum(1 for ln in lines if ln.startswith("[dryrun]   ok"))
    n_skip = sum(1 for ln in lines if ln.startswith("[dryrun] SKIP"))
    n_fail = sum(1 for ln in lines if ln.startswith("[dryrun] FAIL"))
    log(f"dryrun (c) dryrun --arch all --shape all --mesh both --jobs "
        f"{DRYRUN_JOBS}: exit {rc}, {n_ok} planned, {n_skip} skipped, "
        f"{n_fail} failed a mesh pair of 40 cells; wall {lm_wall:.1f} s "
        f"(from its start, beside (a), (b), (d)); "
        f"{lines[-1] if lines else ''}")
    from repro_torch.configs import all_cells
    runnable = sum(ok for _, _, ok, _ in all_cells())
    check(rc == 0 and n_fail == 0 and n_ok == 2 * runnable
          and n_skip == 2 * (40 - runnable), "dryrun (c): every runnable "
          "cell planned on both meshes, skips only where cell_is_runnable "
          f"says so, 0 FAIL:\n{text[-3000:]}")
    out["lm_dryrun"] = {"wall_s": lm_wall, "planned": n_ok,
                        "skipped": n_skip}
    for mesh in ("single", "multi"):
        res = dryrun_cli("repro_torch.launch.report", "--dir",
                         str(out_dir / "lm"), "--mesh", mesh)
        rows = [ln for ln in res.stdout.splitlines()
                if ln.count(" | ") >= 9 and not ln.startswith("arch ")]
        log(f"dryrun (e) report --mesh {mesh}: exit {res.returncode}, "
            f"{len(rows)} rows:\n" + res.stdout)
        check(res.returncode == 0 and len(rows) == 40,
              f"dryrun (e): report --mesh {mesh} exits 0 with 40 rows")
    shutil.rmtree(out_dir, ignore_errors=True)
    out["card"] = smi
    log("dryrun summary " + json.dumps(out))
    log(f"dryrun phase: {time.perf_counter() - t_phase:.1f} s")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--records", type=int, default=10_000_000)
    ap.add_argument("--trees", type=int, default=8)
    # seed 1: 67 % of the Higgs-shaped records are positive (real HIGGS has
    # 53 % signal).  Seed 0 makes 87 % negative, and 8 trees at learning
    # rate 0.1 then move no held-out margin across 0 from the base margin,
    # so its accuracy only ties the majority class.
    # The IoT-shaped path draws its data with seed S + 1: at seed 1 (85 %
    # positives) its 8-tree fit's held-out accuracy only ties the majority
    # class.
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    smi = environment(_build)
    rows = kernel_parity(args.records, args.seed, dev)
    torch.cuda.empty_cache()
    rows.update(class_parity(MC_RECORDS, args.seed, dev))
    torch.cuda.empty_cache()
    rows.update(packed_parity(args.records, args.seed, dev))
    torch.cuda.empty_cache()
    rows["split_level"] = split_parity(args.seed, dev)
    counts, steady_ms, (config, data, y), higgs_raw = main_path(
        args.records, args.trees, args.seed, dev)
    higgs_device_ms = round_breakdown("Higgs", config, data, y, steady_ms)
    naive_counts = naive_fit(config, data, y)
    mc_counts, mc_steady_ms, (mc_config, mc_data, mc_y), mc_raw = \
        mc_main_path(MC_RECORDS, MC_ROUNDS, args.seed, dev)
    # the histogram's time depends on the codes: its row is timed on the
    # multi-class path's own, after that path's launch counts were read
    gen = torch.Generator(device=dev).manual_seed(args.seed + 2)
    cover = class_histogram(mc_data.codes, gen, dev, "Covertype-shaped codes",
                            False)
    cover["max_abs_err"] = max(cover["max_abs_err"],
                               rows["histogram_classes"]["max_abs_err"])
    rows["histogram_classes"].update(cover)
    # the naive-packing kernel on the same codes, against the grouped one
    ms, err, _ = naive_levels(mc_data.codes, MC_CLASSES, gen, dev,
                              "Covertype-shaped codes")
    nn, n_mc = 2 ** (DEPTH - 1), mc_data.codes.shape[0]
    rows["histogram_naive"].update(
        ms_k7=ms[nn][0], grouped_ms_k7=ms[nn][1], ms_k7_nn1=ms[1][0],
        grouped_ms_k7_nn1=ms[1][1], max_abs_err_f64_k7=err,
        shape_k7=f"n={n_mc} F={MC_FIELDS} NB={N_BINS} K={MC_CLASSES} "
        f"NN={nn}, {naive_label(n_mc, MC_CLASSES, nn, MC_FIELDS, N_BINS)}, "
        "Covertype-shaped codes")
    mc_device_ms = round_breakdown("multi-class", mc_config, mc_data, mc_y,
                                   mc_steady_ms)
    iot_counts, iot_steady_ms, iot_step5_ms, (iot_config, iot_data,
                                              iot_y), iot_raw = iot_main_path(
        IOT_RECORDS, args.trees, args.seed, dev)
    rows["traversal_nibble"]["iot_step5_device_ms"] = iot_step5_ms
    # the nibble and uint8 kernels on the path's own codes, NN = 32
    nib = nibble_histogram(iot_data.codes.unpack(), 1, (2 ** (DEPTH - 1),),
                           torch.Generator(device=dev).manual_seed(
                               args.seed + 5), dev, "IoT-shaped codes")
    rows["histogram_nibble"].update(ms_path_codes=nib["ms"],
                                    uint8_ms_path_codes=nib["uint8_ms"])
    round_breakdown("IoT-shaped packed", iot_config, iot_data, iot_y,
                    iot_steady_ms)
    rows["ensemble"].update(serving_path(args.seed, dev, smi))
    # phase 6 on the Higgs- and Covertype-shaped paths' data: its graphs
    # and profiles run after every earlier phase's profile
    rows["histogram"].update(variants_path(config, data, y, dev,
                                           higgs_device_ms, smi))
    rows["histogram_classes"].update(variants_multiclass(
        mc_config, mc_data, mc_y, dev, mc_steady_ms, mc_device_ms, smi))
    # phase 7 last: the three paths' raw matrices streamed out-of-core, held
    # against their in-memory fits
    paths = {key: dict(raw, config=cfg, data=d, y=yy, steady_ms=ms)
             for key, raw, cfg, d, yy, ms in (
                 ("higgs", higgs_raw, config, data, y, steady_ms),
                 ("cover", mc_raw, mc_config, mc_data, mc_y, mc_steady_ms),
                 ("iot", iot_raw, iot_config, iot_data, iot_y,
                  iot_steady_ms))}
    stream = streaming_path(paths, dev, smi)
    # phase 8: the distributed trainer and the launch drivers
    dist = distributed_path(paths, dev, smi)
    del paths, data, mc_data, iot_data, higgs_raw, mc_raw, iot_raw
    torch.cuda.empty_cache()
    # phase 9: the LM substrate's serving path (no kernel of the table)
    lm_path(args.seed, dev, smi)
    # phase 10: LM training (no kernel of the table either)
    lm_train_path(args.seed, dev, smi)
    # phase 11: the dry runs and the report, held against the card
    dryrun_path(args.seed, dev, smi)
    for row, key, counter in (
            ("histogram", "higgs", "histogram"),
            ("partition", "higgs", "partition"),
            ("histogram_classes", "cover", "histogram"),
            ("partition_classes", "cover", "partition"),
            ("histogram_nibble", "iot", "histogram_nibble"),
            ("partition_nibble", "iot", "partition_nibble"),
            ("split_level", "higgs", "split_level")):
        rows[row]["stream_launches"] = stream[key]["counts"][counter]
    rows["ensemble"]["stream_launches"] = \
        stream["higgs"]["warm_counts"]["ensemble"]
    for row, key in (("histogram", "higgs"), ("histogram_classes", "cover"),
                     ("histogram_nibble", "iot")):
        rows[row].update(stream_round_ms=stream[key]["steady_ms"],
                         stream_fit_peak_bytes=stream[key]["fit_peak_bytes"],
                         stream_pass=stream[key]["breakdown"])

    dc = dist["counts"]
    dist_launches = {"histogram": dc["higgs"]["histogram"],
                     "partition": dc["higgs"]["partition"],
                     "traversal": dc["warm"]["traversal"],
                     "ensemble": dc["predict"]["ensemble"],
                     "histogram_classes": dc["cover"]["histogram"],
                     "partition_classes": dc["cover"]["partition"],
                     "split_level": dc["higgs"]["split_level"]}
    for name, row in rows.items():
        row["dist_launches"] = dist_launches.get(name, 0)
    rows["histogram"].update(
        dist_round_ms_d1=dist["higgs_d1_steady_ms"],
        dist_round_ms_d4=dist["higgs_d4_steady_ms"],
        dist_host_loop_round_ms=dist["host_loop_steady_ms"],
        dist_level_d1=dist["level_d1"], dist_level_d4=dist["level_d4"],
        dist_round_collectives_d4=dist["round_collectives_d4"],
        dist_card=smi)
    rows["histogram_classes"]["dist_round_ms_d4"] = dist["cover_steady_ms"]
    rows["ensemble"].update(
        dist_sharded_predict_ms=dist["sharded_predict_ms"],
        dist_predict_margin_ms=dist["predict_margin_ms"])
    # (row, kernel counter, source, TPU kernel, launches of which path)
    meta = [
        ("histogram", "histogram", "histogram.cu",
         "src/repro/kernels/histogram.py:77", counts),
        ("partition", "partition", "partition.cu",
         "src/repro/kernels/partition.py:38", counts),
        ("traversal", "traversal", "traversal.cu",
         "src/repro/kernels/traversal.py:84", counts),
        ("ensemble", "ensemble", "traversal.cu",
         "src/repro/kernels/traversal.py:125", counts),
        # the class axis of _stats_node, read by _hist_kernel_grouped (:77)
        ("histogram_classes", "histogram", "histogram.cu",
         "src/repro/kernels/histogram.py:58", mc_counts),
        ("partition_classes", "partition", "partition.cu",
         "src/repro/kernels/partition.py:38", mc_counts),
        ("traversal_classes", "traversal", "traversal.cu",
         "src/repro/kernels/traversal.py:84", mc_counts),
        ("ensemble_classes", "ensemble", "traversal.cu",
         "src/repro/kernels/traversal.py:125", mc_counts),
        # the wide entry (rows past the staged limit): on no path, 0 launches
        ("ensemble_wide", "ensemble_wide", "traversal.cu",
         "src/repro/kernels/traversal.py:125", counts),
        # the nibble_packed branch of _hist_kernel_grouped (:93-95)
        ("histogram_nibble", "histogram_nibble", "histogram.cu",
         "src/repro/kernels/histogram.py:93", iot_counts),
        ("partition_nibble", "partition_nibble", "partition.cu",
         "src/repro/kernels/partition.py:38", iot_counts),
        # step ⑤ on the packed rows: _traverse_kernel (:84) on unpacked
        # columns in the JAX build; here the nibble entry, counted as
        # traversal
        ("traversal_nibble", "traversal", "traversal.cu",
         "src/repro/kernels/traversal.py:84", iot_counts),
        ("histogram_naive", "histogram_naive", "histogram.cu",
         "src/repro/kernels/histogram.py:107", naive_counts),
        # step ②: no pallas_call; the jnp of src/repro/core/splits.py,
        # which jit fuses on the TPU
        ("split_level", "split_level", "splits.cu",
         "none (src/repro/core/splits.py:find_best_splits, jnp)", counts),
    ]
    table = []
    for name, counter, source, replaces, path_counts in meta:
        row = rows[name]
        table.append({"name": name, "route": "cuda",
                      "source": f"src/repro_torch/csrc/{source}",
                      "replaces": replaces,
                      "launches": path_counts[counter],
                      "max_abs_err": row.pop("max_abs_err"),
                      "ms": row.pop("ms"), "plain_ms": row.pop("plain_ms"),
                      "bound_ms": row.pop("bound_ms"),
                      "bound_by": row.pop("bound_by"),
                      "library_ms": row.pop("library_ms"), **row})
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

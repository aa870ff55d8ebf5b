"""Multi-pod dry run: plan every (arch x shape) cell of the LM substrate on
the production meshes, then dump per-cell roofline artifacts.

The counterpart of :mod:`repro.launch.dryrun`.  ``repro`` lowers and
compiles each cell on 512 placeholder XLA devices and reads XLA's cost and
memory analyses and the HLO's collectives; PyTorch has none of these.  The
port traces the cell's real program once on the ``meta`` device, at full
depth and the global batch, and reads the per-card shard shapes and the
collectives from the sharding rules of :mod:`repro_torch.models.lm`.
Nothing is allocated and nothing touches CUDA: the mesh is of ``meta``
devices (:func:`~repro_torch.launch.mesh.meta_mesh`), and a tensor that
holds data on any other device during a trace fails the cell (an empty
one, such as the marker ``torch.utils.checkpoint`` makes on the default
device, holds none).

The program a cell traces:

  * ``train``: ``make_train_step`` (the loss, autograd's backward pass
    with remat as configured, AdamW) on ``LM(cfg, device="meta")``;
  * ``prefill``: ``prefill`` into a fresh cache of ``seq_len`` rows;
  * ``decode``: one ``decode_step`` against a ``seq_len`` cache from
    ``cache_specs``.

``repro``'s two-point unrolled probe works around XLA counting a scan's
body once; the port runs one Python loop over its layers, so every layer
is traced and counted, and there is no probe.  One trace serves both
meshes: only the shard bytes and the collectives depend on the mesh.

What a record holds, per card (a card is ``repro``'s chip, and its keys
keep ``repro``'s names):

  * ``flops_per_chip``: ``torch.utils.flop_counter.FlopCounterMode``'s
    total over the trace, divided by the cards.
  * ``bytes_per_chip``: the bytes every aten op reads and writes, counted
    by :class:`OpBytes` and divided by the cards.  This is what the
    port's eager program moves, unfused, op by op, where XLA's count is
    of its fused program: a view moves nothing; an op reads each tensor
    argument once and writes each output once; an in-place op writes its
    mutated argument once more, a fill (``fill_``, ``zero_``) only
    writes it, and an indexed write (``copy_``, ``index_copy_``,
    ``index_put_``, ``index_add_``, ``scatter*``) writes only the bytes
    of its source, not the whole destination.
  * ``argument_size_in_bytes``: the card's parameters
    (``lm.param_shardings``), the batch's shards and, for ``train``, the
    gradients (the parameters' dtype) and the float32 AdamW moments; for
    ``decode`` the cache's shards (``lm.cache_specs``).
  * ``output_size_in_bytes``: what the program returns beside updating
    its arguments in place: the float32 logits' shard for the serving
    shapes, and for ``prefill`` the cache it fills.
  * ``temp_size_in_bytes``: for ``train`` the bytes autograd saves between
    the forward and the backward pass (``saved_tensors_hooks`` around the
    step, which sees the forward's saves only: a checkpoint region's
    recompute saves under its own hooks; each storage once, the
    parameters' own storage not), divided by the batch's data shards.  For
    the serving shapes the largest single op output, divided alike: a
    lower bound (``temp_kind`` says which).
  * ``bytes_per_device`` = arguments + outputs + temp.
  * ``collectives``: per kind ``{count, bytes}`` a card (an all-reduce's
    operand twice, as ``repro`` counts it), and ``collective_links`` the
    same by (kind, axes) with the link each uses (``roofline.link_of``).
    They follow from the specs by these rules (T = the card's tokens, its
    batch shard times the sequence, 1 a step for decode; d the width; c
    the compute dtype's bytes; a pass is the forward, the forward that
    remat "full" repeats, and the backward, or the forward alone when
    serving):

      - data axes, ``train`` only: each parameter's gradient once a step:
        an all-reduce of its shard; under ``fsdp`` a parameter whose spec
        names a data axis is instead reduce-scattered (its shard's bytes),
        and all-gathered (its shard times the data shards that split it)
        once a pass, the forward and the backward for the table and the
        final norm.
      - model axis: an all-reduce of T x d in c after each product whose
        contracted dimension is sharded on ``"model"``: once a pass for
        each attention (self and cross), MLP, Mamba-2 and shared-expert
        block (its out-projection forward, its in-projection's input
        gradient backward), and for the embedding (the lookup in a
        vocab-sharded table forward; the logits' input gradient
        backward); ``train``'s loss over the vocab-sharded logits, one
        all-reduce of 3 float32 a token (max, sum, gold logit).
      - MoE: under expert parallelism (``n_experts`` divides the model
        axis) two all-to-alls of the card's (E, C, d) dispatch buffer a
        pass; otherwise an all-reduce of that buffer a pass over
        ``"model"``, or over the data axes and ``"model"`` under
        ``moe_ff_fsdp``.  C is ``moe_ffn``'s capacity at the card's T.
      - ``decode``'s attention by ``kv_shard``: ``hd`` an all-reduce of
        the float32 (B, H, W) logits' partial sums a layer; ``seq`` one
        of the row max and sum and one of the float32 (B, H, D) output;
        ``kv`` and ``none`` nothing.
  * ``rl.roofline_terms``, ``model_flops``, ``model_flops_ratio``,
    ``params_total``, ``params_active``, and ``plan_s`` (the trace's wall
    time, with the mesh's share of planning).

Variants (``--variant``) apply ``repro``'s §Perf changes under the same 20
names and transforms.  ``act_pin`` and ``head_pin`` constrain GSPMD's
propagation and mean nothing to the port: a record lists them under
``"inert"``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both

writes ``artifacts/dryrun_torch/<mesh>_<arch>_<shape>[_<variant>].json``
(a skipped cell as ``{"skipped": true, "reason": ...}``, a failed one with
``error`` and ``traceback``, and then the run exits 1).  ``--jobs N``
traces N cells at once, each in a process of its own.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import multiprocessing
import os
import time
import traceback
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, SHAPES, cell_is_runnable, get_arch
from repro_torch.configs.registry import ArchConfig, ShapeConfig
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import (Mesh, axis_size, data_axes,
                                     meta_production_mesh, shard_shape,
                                     spec_data_axes)
from repro_torch.models import lm, optim

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun_torch")
META = torch.device("meta")


# --------------------------------------------------------------------------
# per-variant config/step transforms (repro's §Perf hillclimbing hooks)
# --------------------------------------------------------------------------
def _variant_base(cfg, shape):
    return cfg, {}


def _variant_no_remat(cfg, shape):
    return dataclasses.replace(cfg, remat=False), {}


def _variant_blocked_xent(cfg, shape):
    # vocab-blocked cross entropy: no (B,S,V) logits materialization
    return cfg, {"vocab_blocks": 8}


def _variant_ssd_chunk64(cfg, shape):
    return dataclasses.replace(cfg, ssm_chunk=64), {}


def _variant_ssd_chunk128(cfg, shape):
    return dataclasses.replace(cfg, ssm_chunk=128), {}


def _variant_kv_shard_seq(cfg, shape):
    # shard the decode cache on its sequence dim instead of head_dim
    return cfg, {"kv_shard": "seq"}


def _variant_kv_shard_kv(cfg, shape):
    return cfg, {"kv_shard": "kv"}


def _variant_blocked_xent_chunk64(cfg, shape):
    return dataclasses.replace(cfg, ssm_chunk=64), {"vocab_blocks": 8}


def _variant_remat_dots(cfg, shape):
    # save matmul outputs in remat: no recompute of the products
    return dataclasses.replace(cfg, remat_policy="dots"), {}


def _variant_remat_dots_blocked_xent(cfg, shape):
    return dataclasses.replace(cfg, remat_policy="dots"), {"vocab_blocks": 8}


def _variant_flash_attn(cfg, shape):
    # chunked online-softmax attention: O(Sq*Sk) logits never materialize
    return dataclasses.replace(cfg, attn_chunk=2048), {}


def _variant_flash_attn_blocked_xent(cfg, shape):
    return dataclasses.replace(cfg, attn_chunk=2048), {"vocab_blocks": 8}


def _variant_act_pin(cfg, shape):
    return cfg, {"act_pin": True}


def _variant_act_pin_flash(cfg, shape):
    return dataclasses.replace(cfg, attn_chunk=2048), {"act_pin": True}


def _variant_act_pin_remat_dots(cfg, shape):
    return dataclasses.replace(cfg, remat_policy="dots"), {"act_pin": True}


def _variant_act_pin_all(cfg, shape):
    return dataclasses.replace(cfg, attn_chunk=2048), \
        {"act_pin": True, "vocab_blocks": 8}


def _variant_head_pin_flash(cfg, shape):
    return dataclasses.replace(cfg, attn_chunk=2048), \
        {"act_pin": True, "head_pin": True}


def _variant_head_pin_all(cfg, shape):
    return dataclasses.replace(cfg, attn_chunk=2048), \
        {"act_pin": True, "head_pin": True, "vocab_blocks": 8}


def _variant_head_pin_flash4k(cfg, shape):
    return dataclasses.replace(cfg, attn_chunk=4096), \
        {"act_pin": True, "head_pin": True}


def _variant_moe_ff_fsdp_all(cfg, shape):
    # shard expert ff over data x model: expert products never contract a
    # sharded d
    return dataclasses.replace(cfg, attn_chunk=2048, moe_ff_fsdp=True), \
        {"act_pin": True, "head_pin": True, "vocab_blocks": 8}


VARIANTS = {
    "base": _variant_base,
    "no_remat": _variant_no_remat,
    "blocked_xent": _variant_blocked_xent,
    "ssd_chunk64": _variant_ssd_chunk64,
    "ssd_chunk128": _variant_ssd_chunk128,
    "kv_shard_seq": _variant_kv_shard_seq,
    "kv_shard_kv": _variant_kv_shard_kv,
    "blocked_xent_chunk64": _variant_blocked_xent_chunk64,
    "remat_dots": _variant_remat_dots,
    "remat_dots_blocked_xent": _variant_remat_dots_blocked_xent,
    "flash_attn": _variant_flash_attn,
    "flash_attn_blocked_xent": _variant_flash_attn_blocked_xent,
    "act_pin": _variant_act_pin,
    "act_pin_flash": _variant_act_pin_flash,
    "act_pin_remat_dots": _variant_act_pin_remat_dots,
    "act_pin_all": _variant_act_pin_all,
    "head_pin_flash": _variant_head_pin_flash,
    "head_pin_all": _variant_head_pin_all,
    "head_pin_flash4k": _variant_head_pin_flash4k,
    "moe_ff_fsdp_all": _variant_moe_ff_fsdp_all,
}
INERT_OPTS = ("act_pin", "head_pin")     # GSPMD constraints: no port twin


def _batch_specs(cfg: ArchConfig, shape: ShapeConfig, mesh: Mesh, opts):
    """The cell's inputs as ``meta`` tensors, and their specs."""
    da = spec_data_axes(mesh)
    B, S = shape.global_batch, shape.seq_len
    seq_spec = "model" if opts.get("seq_shard") else None
    f32 = torch.float32
    if shape.kind == "train":
        sizes = {"tokens": ((B, S), (da, None)),
                 "labels": ((B, S), (da, None))}
    elif shape.kind == "prefill":
        sizes = {"tokens": ((B, S), (da, seq_spec))}
    else:  # decode
        sizes = {"token": ((B, 1), (da if B > 1 else None, None))}
    if cfg.mrope and shape.kind != "decode":
        sizes["positions"] = ((3, B, S), (None, da, None))
    if cfg.family == "vlm" and shape.kind != "decode":
        sizes["patch_embeds"] = ((B, 256, cfg.d_model), (da, None, None),
                                 f32)
    if cfg.family == "encdec" and shape.kind != "decode":
        sizes["audio_embeds"] = ((B, cfg.frontend_len, cfg.d_model),
                                 (da, None, None), f32)
    batch = {k: torch.empty(v[0], dtype=v[2] if len(v) > 2 else torch.int32,
                            device=META) for k, v in sizes.items()}
    return batch, {k: v[1] for k, v in sizes.items()}


def input_specs(arch_id: str, shape_name: str, mesh: Mesh,
                variant: str = "base") -> Dict[str, torch.Tensor]:
    """The cell's abstract inputs (``meta`` tensors)."""
    cfg, opts = VARIANTS[variant](get_arch(arch_id), SHAPES[shape_name])
    return _batch_specs(cfg, SHAPES[shape_name], mesh, opts)[0]


# --------------------------------------------------------------------------
# the trace
# --------------------------------------------------------------------------
_NO_TRAFFIC = {torch.ops.aten._unsafe_view.default,
               torch.ops.aten.empty.memory_format,
               torch.ops.aten.empty_strided.default,
               torch.ops.aten.new_empty.default,
               torch.ops.aten.lift_fresh.default}
_INDEXED_WRITES = ("copy_", "index_copy_", "index_put_", "index_add_",
                   "scatter_", "scatter_add_", "scatter_reduce_")
_FILLS = ("fill_", "zero_")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpBytes(TorchDispatchMode):
    """Counts the bytes each aten op reads and writes (the rule in the
    module's docstring), the op count and the largest op output, and
    fails on any tensor off the ``meta`` device."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0
        self.largest_output = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = [a for a in pytree.tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)]
        outs = [o for o in pytree.tree_leaves(out)
                if isinstance(o, torch.Tensor)]
        for x in ins + outs:     # an empty tensor holds no data: the
            if x.device.type != "meta" and x.numel():  # checkpoint's marker
                raise RuntimeError(f"{func} saw a tensor on {x.device} "
                                   "during a meta trace")
        self.ops += 1
        if func.is_view or func in _NO_TRAFFIC:
            return out
        mutated = [a.name for a in func._schema.arguments
                   if a.alias_info is not None and a.alias_info.is_write]
        if not mutated:
            written = sum(_nbytes(o) for o in outs)
            self.bytes += sum(_nbytes(x) for x in ins) + written
            self.largest_output = max([self.largest_output]
                                      + [_nbytes(o) for o in outs])
            return out
        named = dict(zip((a.name for a in func._schema.arguments), args))
        named.update(kwargs)
        dst = [named[n] for n in mutated if isinstance(named.get(n),
                                                       torch.Tensor)]
        dst_ids = {id(t) for t in dst}
        srcs = [x for x in ins if id(x) not in dst_ids]
        read = sum(_nbytes(x) for x in srcs)
        name = func._schema.name.split("::")[-1]
        if name in _FILLS:
            self.bytes += read + sum(_nbytes(t) for t in dst)
        elif name in _INDEXED_WRITES:
            values = [x for x in srcs if x.dtype == dst[0].dtype] or srcs
            self.bytes += read + max([0] + [_nbytes(x) for x in values])
        else:
            self.bytes += read + 2 * sum(_nbytes(t) for t in dst)
        return out


def trace_cell(cfg: ArchConfig, shape: ShapeConfig, opts: Dict) -> Dict:
    """The cell's program once on ``meta``: total FLOPs and bytes, the
    bytes autograd saves (``train``) and the largest op output."""
    t0 = time.time()
    model = lm.LM(cfg, device=META)
    own = {p.untyped_storage()._cdata for p in model.parameters()}
    batch = _batch_specs(cfg, shape, meta_production_mesh(False), opts)[0]
    saved: Dict[int, int] = {}

    def pack(t):
        key = t.untyped_storage()._cdata
        if key not in own:
            saved.setdefault(key, t.untyped_storage().nbytes())
        return t

    counter, flops = OpBytes(), FlopCounterMode(display=False)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        with flops, counter:
            if shape.kind == "train":
                step = lm.make_train_step(
                    cfg, vocab_blocks=opts.get("vocab_blocks", 0))
                step(model, optim.adamw_init(model), batch)
            elif shape.kind == "prefill":
                lm.prefill(cfg, model, batch, cache_dtype=torch.bfloat16,
                           max_len=shape.seq_len)
            else:
                caches = lm.init_cache(cfg, shape.global_batch,
                                       shape.seq_len, torch.bfloat16,
                                       device=META)
                lm.decode_step(cfg, model, caches, batch["token"],
                               shape.seq_len - 1)
    return {"flops": float(flops.get_total_flops()),
            "bytes": float(counter.bytes), "ops": counter.ops,
            "saved_bytes": int(sum(saved.values())),
            "largest_output": int(counter.largest_output),
            "trace_s": time.time() - t0}


# --------------------------------------------------------------------------
# the plan on a mesh
# --------------------------------------------------------------------------
def _local_bytes(mesh: Mesh, t: torch.Tensor, spec) -> int:
    return int(np.prod(shard_shape(mesh, spec, t.shape))) * t.element_size()


def _batch_shards(mesh: Mesh, batch: int) -> int:
    n = axis_size(mesh, data_axes(mesh))
    return n if batch % n == 0 else 1


def _cache_bytes(cfg, shape, mesh, opts) -> int:
    caches, specs = lm.cache_specs(cfg, mesh, shape.global_batch,
                                   shape.seq_len, torch.bfloat16,
                                   kv_shard=opts.get("kv_shard", "hd"))
    flat = pytree.tree_leaves(caches)
    flat_specs = pytree.tree_leaves(specs, is_leaf=lambda x: isinstance(
        x, tuple))
    return sum(_local_bytes(mesh, t, s) for t, s in zip(flat, flat_specs))


def lm_collectives(cfg: ArchConfig, shape: ShapeConfig, mesh: Mesh,
                   opts: Dict) -> List[Dict]:
    """The cell's collectives a card, by the rules in the module's
    docstring, summed by (kind, axes)."""
    da = data_axes(mesh)
    m = mesh.shape["model"]
    train = shape.kind == "train"
    B = shape.global_batch
    B_l = B // _batch_shards(mesh, B)
    T = B_l * (1 if shape.kind == "decode" else shape.seq_len)
    c = lm._dtype(cfg.compute_dtype).itemsize
    act = T * cfg.d_model * c
    passes = 1
    if train:
        passes = 2 + (1 if cfg.remat and cfg.remat_policy == "full" else 0)
    acc: Dict[Tuple[str, tuple], List[int]] = defaultdict(lambda: [0, 0])

    def add(kind, axes, count, n_bytes):
        key = (kind, (axes,) if isinstance(axes, str) else tuple(axes))
        acc[key][0] += count
        acc[key][1] += n_bytes

    if m > 1:
        layers = list(cfg.layer_kinds())
        if cfg.family == "encdec" and shape.kind != "decode":
            enc_t = B_l * cfg.frontend_len
            add("all-reduce", "model", 2 * passes * cfg.encoder_layers,
                2 * passes * cfg.encoder_layers * 2 * enc_t * cfg.d_model
                * c)
        for mixer, ffn in layers:
            add("all-reduce", "model", passes, 2 * passes * act)
            if cfg.family == "encdec" and mixer == "attn":
                add("all-reduce", "model", passes, 2 * passes * act)
            if ffn == "mlp":
                add("all-reduce", "model", passes, 2 * passes * act)
            elif ffn == "moe":
                cap = max(int(T * cfg.top_k * cfg.moe_capacity_factor
                              / cfg.n_experts), 4)
                buf = cfg.n_experts * cap * cfg.d_model * c
                if cfg.n_experts >= m and cfg.n_experts % m == 0:
                    add("all-to-all", "model", 2 * passes, 2 * passes * buf)
                else:
                    axes = (tuple(da) + ("model",) if cfg.moe_ff_fsdp
                            and cfg.fsdp else ("model",))
                    add("all-reduce", axes, passes, 2 * passes * buf)
                if cfg.shared_expert:
                    add("all-reduce", "model", passes, 2 * passes * act)
            if shape.kind == "decode" and mixer == "attn":
                H, W = cfg.n_heads, lm.cache_len(cfg, shape.seq_len)
                kv = opts.get("kv_shard", "hd")
                if kv == "hd":
                    add("all-reduce", "model", 1, 2 * B_l * H * W * 4)
                elif kv == "seq":
                    add("all-reduce", "model", 1, 2 * 2 * B_l * H * 4)
                    add("all-reduce", "model", 1,
                        2 * B_l * H * cfg.head_dim * 4)
        emb = 2 if train else 1
        add("all-reduce", "model", emb, 2 * emb * act)
        if train:
            add("all-reduce", "model", 1, 2 * 3 * T * 4)
    if train:
        da_set = set(da)
        for key, (spec, local, n_bytes) in lm.param_shardings(
                cfg, mesh).items():
            stacked = key.startswith(("blocks.", "enc_blocks."))
            groups = local[0] if stacked else 1
            used = [a for s in spec if s is not None
                    for a in ((s,) if isinstance(s, str) else s)
                    if a in da_set]
            if not used:
                add("all-reduce", da, groups, 2 * n_bytes)
                continue
            uses = passes if stacked else 2
            add("reduce-scatter", da, groups, n_bytes)
            add("all-gather", da, groups * uses,
                uses * n_bytes * axis_size(mesh, tuple(used)))
    return [rl.collective_entry(mesh, kind, axes, n, b)
            for (kind, axes), (n, b) in sorted(acc.items())]


def _mesh_name(mesh: Mesh) -> str:
    return "x".join(str(s) for s in mesh.shape.values())


def plan_cell(cfg: ArchConfig, shape: ShapeConfig, mesh: Mesh, opts: Dict,
              trace: Dict) -> Dict:
    """One mesh's record from the cell's trace."""
    t0 = time.time()
    cards = mesh.size
    train = shape.kind == "train"
    rec = {"chips": cards, "mesh": _mesh_name(mesh),
           "layer_groups": cfg.n_layers // cfg.scan_period(),
           "inert": [k for k in INERT_OPTS if opts.get(k)],
           "trace_ops": trace["ops"], "trace_s": round(trace["trace_s"], 2)}
    shardings = lm.param_shardings(cfg, mesh)
    params = sum(v[2] for v in shardings.values())
    args = params
    if train:
        moments = sum(4 * int(np.prod(v[1])) for v in shardings.values())
        args += params + 2 * moments
        rec["moment_bytes"] = 2 * moments
    batch, specs = _batch_specs(cfg, shape, mesh, opts)
    args += sum(_local_bytes(mesh, t, specs[k]) for k, t in batch.items())
    shards = _batch_shards(mesh, shape.global_batch)
    out = 0
    if shape.kind != "train":
        logits = torch.empty((shape.global_batch, cfg.vocab_padded),
                             device=META)
        da = spec_data_axes(mesh) if shards > 1 else None
        out = _local_bytes(mesh, logits, (da, "model"))
    if shape.kind == "decode":
        args += _cache_bytes(cfg, shape, mesh, opts)
    elif shape.kind == "prefill":
        out += _cache_bytes(cfg, shape, mesh, opts)
    temp = (trace["saved_bytes"] if train else trace["largest_output"])
    rec.update(parameter_bytes=params, argument_size_in_bytes=int(args),
               output_size_in_bytes=int(out),
               temp_size_in_bytes=int(temp // shards),
               temp_kind=("saved for backward" if train
                          else "largest op output (lower bound)"))
    rec["bytes_per_device"] = (rec["argument_size_in_bytes"]
                               + rec["output_size_in_bytes"]
                               + rec["temp_size_in_bytes"])
    rec["flops_per_chip"] = trace["flops"] / cards
    rec["bytes_per_chip"] = trace["bytes"] / cards
    colls = lm_collectives(cfg, shape, mesh, opts)
    rec["collectives"] = rl.by_kind(colls)
    rec["collective_links"] = colls
    rec["collective_bytes_per_chip"] = float(sum(e["bytes"] for e in colls))
    rec.update(rl.roofline_terms(rec["flops_per_chip"], rec["bytes_per_chip"],
                                 rec["collective_bytes_per_chip"],
                                 collective_s=rl.collective_seconds(colls)))
    n_active = lm.active_param_count(cfg)
    tokens = shape.global_batch * (shape.seq_len
                                   if shape.kind != "decode" else 1)
    rec["model_flops"] = rl.model_flops(shape.kind, n_active, tokens)
    rec["model_flops_ratio"] = (rec["model_flops"] / trace["flops"]
                                if trace["flops"] else 0.0)
    rec["params_total"] = lm.param_count(cfg)
    rec["params_active"] = n_active
    rec["plan_s"] = round(trace["trace_s"] + time.time() - t0, 2)
    return rec


def run_cell(arch_id: str, shape_name: str, meshes: List[Mesh],
             variant: str = "base") -> List[Dict]:
    """The cell traced once and planned on each of ``meshes``."""
    shape = SHAPES[shape_name]
    cfg, opts = VARIANTS[variant](get_arch(arch_id), shape)
    trace = trace_cell(cfg, shape, opts)
    return [dict({"arch": arch_id, "shape": shape_name, "variant": variant},
                 **plan_cell(cfg, shape, mesh, opts, trace))
            for mesh in meshes]


def cell_records(arch_id: str, shape_name: str, multis: List[bool],
                 variant: str = "base") -> Tuple[List[Dict], str]:
    """Each mesh's record of one cell (``multis`` says which meshes), and
    the error's text when the cell failed (its records then carry it)."""
    meshes = [meta_production_mesh(multi) for multi in multis]
    ok, why = cell_is_runnable(get_arch(arch_id), SHAPES[shape_name])
    head = {"arch": arch_id, "shape": shape_name, "variant": variant}
    if not ok:
        return [dict(head, mesh=_mesh_name(m), skipped=True, reason=why)
                for m in meshes], ""
    try:
        return run_cell(arch_id, shape_name, meshes, variant), ""
    except Exception as e:  # noqa: BLE001 — recorded, then exit 1
        tb = traceback.format_exc()
        return [dict(head, mesh=_mesh_name(m), error=str(e), traceback=tb)
                for m in meshes], str(e) or type(e).__name__


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all",
                    help=f"one of {ARCH_IDS} or 'all'")
    ap.add_argument("--shape", default="all",
                    help=f"one of {list(SHAPES)} or 'all'")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--variant", default="base", choices=list(VARIANTS))
    ap.add_argument("--out", default=None, help="artifact directory")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, one process each")
    args = ap.parse_args(argv)

    out_dir = os.path.abspath(args.out or ARTIFACT_DIR)
    os.makedirs(out_dir, exist_ok=True)
    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    multis = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    cells = [(aid, sh) for aid in archs for sh in shapes]
    suffix = f"_{args.variant}" if args.variant != "base" else ""

    t0 = time.time()
    if args.jobs > 1:
        ctx = multiprocessing.get_context("spawn")
        pool = concurrent.futures.ProcessPoolExecutor(args.jobs,
                                                      mp_context=ctx)
        results = pool.map(cell_records, *zip(*cells),
                           [multis] * len(cells), [args.variant] * len(cells))
    else:
        pool = None
        results = (cell_records(aid, sh, multis, args.variant)
                   for aid, sh in cells)
    failures = 0
    try:
        for (aid, sh), (recs, err) in zip(cells, results):
            failures += bool(err)
            for multi, rec in zip(multis, recs):
                tag = f"{'multi' if multi else 'single'}_{aid}_{sh}{suffix}"
                with open(os.path.join(out_dir, tag + ".json"), "w") as f:
                    json.dump(rec, f, indent=1)
                if rec.get("skipped"):
                    print(f"[dryrun] SKIP  {tag}: {rec['reason']}")
                elif err:
                    print(f"[dryrun] FAIL  {tag}: {err}", flush=True)
                else:
                    print(f"[dryrun]   ok  {tag} plan={rec['plan_s']}s "
                          f"flops/chip={rec['flops_per_chip']:.3e} "
                          f"coll B/chip="
                          f"{rec['collective_bytes_per_chip']:.3e} "
                          f"hbm/dev={rec['bytes_per_device']:.3e} "
                          f"dominant={rec['dominant']}", flush=True)
    finally:
        if pool is not None:
            pool.shutdown()
    print(f"[dryrun] done in {time.time() - t0:.1f}s; {failures} failures")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()

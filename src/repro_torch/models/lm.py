"""Unified LM substrate covering all ten assigned architectures: the
serving half of :mod:`repro.models.lm` (parameters, the forward pass,
caches, prefill and decode), as plain PyTorch.

One parameter schema and one forward pass handle the dense, MoE, SSM,
hybrid, encoder-decoder and VLM families, driven by ``ArchConfig``.  The
weights live in an :class:`LM` module: one :class:`Block` per layer, in
layer order, over :class:`Attention`, :class:`MLP`, :class:`MoE` and
:class:`Mamba2Mixer` modules whose parameter names and layouts are
``repro``'s (a projection is ``(d_in, d_out)``).  ``repro`` stacks the
blocks of each position of the layer pattern on a group axis and scans
over the groups; here a Python loop walks the layers, and
:func:`params_from_jax` carries ``repro``'s stacked pytree across.
``repro``'s function names stay as thin functions over the module
(``init_params``, ``forward_train``, ``prefill``, ``decode_step``, ...),
which take the config first and the module as ``params``.

Three execution modes share the block code: train (the forward pass, no
cache), prefill (fills the KV/SSM caches) and decode (one token against
the caches, updated in place).  The train mode (``forward_hidden``,
``loss_fn``, ``loss_fn_blocked``, ``make_train_step`` with
:mod:`repro_torch.models.optim`, and ``forward_train``, which is
``forward_hidden`` under ``torch.no_grad``) casts each block's weights
inside its layer group at every call, as ``repro``'s ``_apply_block``
does, so a bf16 copy is never stale and under remat is recomputed in the
backward pass, not held.  ``repro`` scans over groups of
``cfg.scan_period()`` layers; here each group is one
``torch.utils.checkpoint`` region (``cfg.remat``; ``remat_policy``
"full" keeps the group's inputs only, "dots" also the outputs of
``aten.mm``/``aten.addmm``, as ``dots_with_no_batch_dims_saveable``).
``scan_unroll`` means nothing here: there is one loop.

Serving (``prefill``, ``decode_step``, under ``torch.no_grad``) instead
casts the decoder's block weights and the embedding table to the compute
dtype once, at their first use in that dtype, and keeps them (the same
bits); the SSM decay scalars and the router stay float32.  ``.to()``,
``load_state_dict``, a train step or :meth:`LM.drop_casts` drops the
copies.

The sharding rules are ``repro``'s, as data that a plan reads: no
tensor is placed by them (the port has no ``NamedSharding``).
:func:`abstract_params` gives ``{name: (shape, dtype)}`` in ``repro``'s
stacked layout (a block parameter's group axis first, keyed by the name
of the group's first layer), :func:`partition_specs` each one's spec (a
tuple with, per dimension, ``None`` or the mesh axes that shard it),
:func:`param_shardings` its spec, shape and bytes on one card, and
:func:`cache_specs` the caches on ``meta`` with their specs.  Rules
(MaxText-flavored, ``repro``'s):

  data axes = all mesh axes but "model" (("pod", "data") multi-pod).
  embed (V, d)            -> ("model", fsdp)
  in-proj  (d, X)         -> (fsdp, "model")
  out-proj (X, d)         -> ("model", fsdp)
  experts  (E, d, f)      -> EP ("model", fsdp, None) when E divides the
                             model axis, else TP (None, fsdp, "model")
  fsdp = data axes when cfg.fsdp (ZeRO-3: params+moments spread over data)
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.api.plan import resolve_device
from repro_torch.configs.registry import ArchConfig
from repro_torch.launch.mesh import (Mesh, data_axes, shard_shape,
                                     spec_data_axes)
from repro_torch.models import layers as L
from repro_torch.models import optim
from repro_torch.models.mamba import mamba2_mixer
from repro_torch.models.moe import moe_ffn

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_KEEP_F32 = ("A_log", "D", "dt_bias", "router")


def _dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def mrope_sections(cfg: ArchConfig) -> Tuple[int, int, int]:
    d2 = cfg.head_dim // 2
    hw = int(round(d2 * 3 / 8))
    return (d2 - 2 * hw, hw, hw)       # (16, 24, 24) at head_dim=128


# ==========================================================================
# parameters
# ==========================================================================
class _Params(nn.Module):
    """A module of named parameters, each with its initializer: ``("normal",
    scale)`` (``scale`` times a float32 standard normal, cast to the
    parameter's dtype, as ``repro``'s ``_init``) or ``("fill", value)``."""

    def __init__(self, device):
        super().__init__()
        self._device = device
        self._inits: Dict[str, tuple] = {}

    def _add(self, name: str, shape, dtype, init) -> None:
        self.register_parameter(name, nn.Parameter(
            torch.empty(shape, dtype=dtype, device=self._device)))
        self._inits[name] = init

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for name, (kind, value) in self._inits.items():
            p = getattr(self, name)
            if kind == "fill":
                p.fill_(value)
            else:
                p.copy_(value * torch.randn(p.shape, generator=generator,
                                            device=generator.device))


class Attention(_Params):
    def __init__(self, cfg: ArchConfig, dt, device, *, cross: bool = False):
        super().__init__(device)
        d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        normal = ("normal", 0.02)
        self._add("wq", (d, h * hd), dt, normal)
        self._add("wk", (d, kv * hd), dt, normal)
        self._add("wv", (d, kv * hd), dt, normal)
        self._add("wo", (h * hd, d), dt, normal)
        if cfg.attn_bias:
            self._add("bq", (h * hd,), dt, ("fill", 0.0))
            self._add("bk", (kv * hd,), dt, ("fill", 0.0))
            self._add("bv", (kv * hd,), dt, ("fill", 0.0))
        if cfg.qk_norm and not cross:
            self._add("q_norm", (hd,), dt, ("fill", 1.0))
            self._add("k_norm", (hd,), dt, ("fill", 1.0))


class MLP(_Params):
    def __init__(self, cfg: ArchConfig, dt, device):
        super().__init__(device)
        d, f = cfg.d_model, cfg.d_ff
        self._add("w_in", (d, f), dt, ("normal", 0.02))
        self._add("w_out", (f, d), dt, ("normal", 0.02))
        if cfg.act == "silu":
            self._add("w_gate", (d, f), dt, ("normal", 0.02))


class MoE(_Params):
    def __init__(self, cfg: ArchConfig, dt, device):
        super().__init__(device)
        d, e = cfg.d_model, cfg.n_experts
        f = cfg.moe_d_ff or cfg.d_ff
        normal = ("normal", 0.02)
        self._add("router", (d, e), torch.float32, normal)
        self._add("w_in", (e, d, f), dt, normal)
        self._add("w_gate", (e, d, f), dt, normal)
        self._add("w_out", (e, f, d), dt, normal)
        if cfg.shared_expert:
            self._add("shared_w_in", (d, cfg.d_ff), dt, normal)
            self._add("shared_w_gate", (d, cfg.d_ff), dt, normal)
            self._add("shared_w_out", (cfg.d_ff, d), dt, normal)


class Mamba2Mixer(_Params):
    def __init__(self, cfg: ArchConfig, dt, device):
        super().__init__(device)
        d, di = cfg.d_model, cfg.d_inner
        h, n, k = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_conv
        f32 = torch.float32
        self._add("in_proj", (d, 2 * di + 2 * n + h), dt, ("normal", 0.02))
        self._add("conv_w", (k, di + 2 * n), dt, ("normal", 0.1))
        self._add("A_log", (h,), f32, ("fill", 0.0))
        self._add("D", (h,), f32, ("fill", 1.0))
        self._add("dt_bias", (h,), f32, ("fill", -2.0))
        self._add("gate_norm", (di,), dt, ("fill", 1.0))
        self._add("out_proj", (di, d), dt, ("normal", 0.02))


class Block(_Params):
    """One layer: ``ln1`` + mixer (attention or Mamba-2), the decoder's
    cross-attention (``lnx`` + ``xattn``) in encoder-decoder models, then
    ``ln2`` + feed-forward (MLP or MoE) unless the stack is mixer-only."""

    def __init__(self, cfg: ArchConfig, kind: Tuple[str, str], dt, device,
                 *, decoder_cross: bool):
        super().__init__(device)
        mixer, ffn = kind
        d = cfg.d_model
        self._add("ln1", (d,), dt, ("fill", 1.0))
        self.mixer = (Attention(cfg, dt, device) if mixer == "attn"
                      else Mamba2Mixer(cfg, dt, device))
        if decoder_cross and mixer == "attn":
            self._add("lnx", (d,), dt, ("fill", 1.0))
            self.xattn = Attention(cfg, dt, device, cross=True)
        if ffn != "none":
            self._add("ln2", (d,), dt, ("fill", 1.0))
            self.ffn = (MLP(cfg, dt, device) if ffn == "mlp"
                        else MoE(cfg, dt, device))


class LM(_Params):
    """The weights of one architecture: ``embed`` (vocab_padded, d),
    ``final_norm``, ``blocks`` in layer order and, for encoder-decoder
    models, ``enc_blocks`` and ``enc_norm``."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__(device)
        dt = _dtype(cfg.param_dtype)
        self._add("embed", (cfg.vocab_padded, cfg.d_model), dt,
                  ("normal", 0.02))
        self._add("final_norm", (cfg.d_model,), dt, ("fill", 1.0))
        self.blocks = nn.ModuleList(
            Block(cfg, kind, dt, device,
                  decoder_cross=cfg.family == "encdec")
            for kind in cfg.layer_kinds())
        if cfg.family == "encdec":
            self.enc_blocks = nn.ModuleList(
                Block(cfg, ("attn", "mlp"), dt, device, decoder_cross=False)
                for _ in range(cfg.encoder_layers))
            self._add("enc_norm", (cfg.d_model,), dt, ("fill", 1.0))
        self._casts: Dict[torch.dtype, tuple] = {}

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.drop_casts()
        for m in self.modules():
            if isinstance(m, _Params):
                _Params.reset_parameters(m, generator)

    def casts(self, cdt: torch.dtype):
        """(decoder block weights, embedding table) in ``cdt`` for
        serving, cast at the first call for ``cdt`` and kept."""
        if cdt not in self._casts:
            self._casts[cdt] = ([_cast_block(b, cdt) for b in self.blocks],
                                self.embed.to(cdt))
        return self._casts[cdt]

    def drop_casts(self) -> None:
        self._casts.clear()

    def _apply(self, fn, *args, **kwargs):
        self.drop_casts()
        return super()._apply(fn, *args, **kwargs)

    def _load_from_state_dict(self, *args, **kwargs):
        self.drop_casts()
        return super()._load_from_state_dict(*args, **kwargs)


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device=None) -> LM:
    """Random weights for ``cfg`` on ``device`` (CUDA unless named; raises
    without a card): built on ``meta``, given storage on the device, then
    drawn from ``generator`` in module order, on the generator's own
    device and copied over (a CPU generator gives the card and the CPU
    the same weights)."""
    model = LM(cfg, device="meta").to_empty(device=resolve_device(device))
    model.reset_parameters(generator)
    return model


def param_count(cfg: ArchConfig) -> int:
    """Parameters of ``cfg``, counted on ``meta`` (nothing is allocated)."""
    return sum(p.numel() for p in LM(cfg, device="meta").parameters())


def active_param_count(cfg: ArchConfig) -> int:
    """MoE-aware active parameters (top_k / n_experts of expert weights),
    by ``repro``'s rule: a ``w_*`` weight of a MoE config whose leaf in
    ``repro``'s stacked pytree (group axis included) has rank >= 3 is
    scaled, which takes in a dense MLP's weights of an interleaved MoE
    stack too."""
    total = 0
    for name, p in LM(cfg, device="meta").named_parameters():
        n = p.numel()
        stacked = name.startswith(("blocks.", "enc_blocks."))
        if (cfg.n_experts and p.dim() + stacked >= 3
                and name.rsplit(".", 1)[-1].startswith("w_")):
            n = n * cfg.top_k // cfg.n_experts
        total += n
    return total


# ==========================================================================
# partition specs
# ==========================================================================
_IN_W = ("wq", "wk", "wv", "w_in", "w_gate", "in_proj",
         "shared_w_in", "shared_w_gate")
_OUT_W = ("wo", "w_out", "out_proj", "shared_w_out")
_STACKS = ("blocks", "enc_blocks")


def stacked_name(cfg: ArchConfig, name: str) -> Tuple[str, int, int]:
    """(name in ``repro``'s stacked layout, group index, groups) of the
    port's parameter ``name``: layer i of the decoder is group i // period
    of ``blocks.{i % period}``, encoder layer i group i of
    ``enc_blocks.0``; a parameter outside the stacks is its own (0, 1)."""
    stack, _, rest = name.partition(".")
    if stack not in _STACKS:
        return name, 0, 1
    i, _, leaf = rest.partition(".")
    i = int(i)
    if stack == "enc_blocks":
        return f"enc_blocks.0.{leaf}", i, cfg.encoder_layers
    period = cfg.scan_period()
    return (f"blocks.{i % period}.{leaf}", i // period,
            cfg.n_layers // period)


def abstract_params(cfg: ArchConfig) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """Full-scale ``{name: (shape, dtype)}`` in ``repro``'s stacked layout,
    read from ``LM(cfg, device="meta")`` (nothing is allocated): a block
    parameter carries its group axis first and is keyed by the name of
    its group's first layer."""
    out = {}
    for name, p in LM(cfg, device="meta").named_parameters():
        key, g, groups = stacked_name(cfg, name)
        if g == 0:
            group_axis = (groups,) if name.startswith(_STACKS) else ()
            out[key] = (group_axis + tuple(p.shape), p.dtype)
    return out


def partition_specs(cfg: ArchConfig, mesh: Mesh) -> Dict[str, tuple]:
    """``repro``'s spec of every parameter of :func:`abstract_params`,
    keyed alike: per dimension ``None`` or the axis (or tuple of axes)
    that shards it, the group axis of a stacked parameter ``None``."""
    da = spec_data_axes(mesh)
    m = mesh.shape["model"]
    fsdp = da if cfg.fsdp else None
    ep = cfg.n_experts >= m and cfg.n_experts % m == 0
    if isinstance(fsdp, tuple):
        ff = fsdp + ("model",)
    else:
        ff = (fsdp, "model") if fsdp else "model"

    def rule(key: str, shape: tuple) -> tuple:
        stacked = key.startswith(_STACKS)
        name = key.rsplit(".", 1)[-1]
        rank = len(shape) - (1 if stacked else 0)

        def S(*spec):
            return ((None,) + spec) if stacked else spec

        if name == "embed":
            return ("model", fsdp)
        if name in _IN_W:
            if rank == 3:                      # (E, d, ff) expert weights
                if ep:
                    return S("model", fsdp, None)
                if cfg.moe_ff_fsdp:            # keep contracted d unsharded
                    return S(None, None, ff)
                return S(None, fsdp, "model")
            return S(fsdp, "model")
        if name in _OUT_W:
            if rank == 3:                      # (E, ff, d)
                if ep:
                    return S("model", fsdp, None)
                if cfg.moe_ff_fsdp:
                    return S(None, ff, None)
                return S(None, "model", fsdp)
            return S("model", fsdp)
        if name == "conv_w":
            return S(None, "model")
        if name in ("A_log", "D", "dt_bias"):
            return S("model") if cfg.ssm_heads % m == 0 else S(None)
        if name == "gate_norm":
            return S("model") if cfg.d_inner % m == 0 else S(None)
        return S(*([None] * rank))             # norms, biases, router

    return {key: rule(key, shape)
            for key, (shape, _) in abstract_params(cfg).items()}


def param_shardings(cfg: ArchConfig, mesh: Mesh
                    ) -> Dict[str, Tuple[tuple, tuple, int]]:
    """``{name: (spec, local shape, local bytes)}`` on one card for every
    parameter of :func:`abstract_params`; a dimension an axis does not
    divide takes the ceiling (the largest shard)."""
    specs = partition_specs(cfg, mesh)
    out = {}
    for key, (shape, dtype) in abstract_params(cfg).items():
        local = shard_shape(mesh, specs[key], shape)
        out[key] = (specs[key], local,
                    int(np.prod(local)) * dtype.itemsize)
    return out


def _to_tensor(a) -> torch.Tensor:
    a = np.array(a)                          # a writable, contiguous copy
    if a.dtype.name == "bfloat16":           # ml_dtypes' bfloat16
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


@torch.no_grad()
def params_from_jax(cfg: ArchConfig, tree, device=None) -> LM:
    """The port's :class:`LM` holding ``repro``'s parameters.

    ``tree`` is ``repro.models.lm.init_params``' pytree with numpy leaves:
    ``blocks[j]`` stacks the blocks of pattern position j on a leading
    group axis, so layer i is ``blocks[i % period][..][i // period]``, and
    encoder layer i is ``enc_blocks[0][..][i]``.  The module lies on
    ``device``: CUDA unless named, and without a card this raises."""
    model = LM(cfg, device="meta").to_empty(device=resolve_device(device))
    period = cfg.scan_period()

    def put(p, leaf, idx=None):
        leaf = np.asarray(leaf) if idx is None else np.asarray(leaf)[idx]
        if tuple(leaf.shape) != tuple(p.shape):
            raise ValueError(f"shape {leaf.shape} for a parameter of "
                             f"{tuple(p.shape)}")
        p.copy_(_to_tensor(leaf))

    def walk(tree_, name):
        for part in name.split("."):
            tree_ = tree_[part]
        return tree_

    own = list(model._parameters)
    stacks = [("blocks", model.blocks, lambda i: (i % period, i // period))]
    if cfg.family == "encdec":
        stacks.append(("enc_blocks", model.enc_blocks, lambda i: (0, i)))
    if set(tree) != set(own) | {key for key, _, _ in stacks}:
        raise ValueError(f"pytree keys {sorted(tree)} do not match {cfg.name}")
    for name in own:
        put(getattr(model, name), tree[name])
    for key, blocks, where in stacks:
        for i, block in enumerate(blocks):
            j, g = where(i)
            named = list(block.named_parameters())
            if len(named) != len(list(_leaves(tree[key][j]))):
                raise ValueError(f"{key}[{j}] holds other leaves than "
                                 f"layer {i} of {cfg.name}")
            for name, p in named:
                put(p, walk(tree[key][j], name), g)
    return model


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ==========================================================================
# forward
# ==========================================================================
def _rope(cfg: ArchConfig, positions, mrope_pos=None):
    if not cfg.rope:
        return None
    if cfg.mrope:
        return L.mrope_cos_sin(mrope_pos, mrope_sections(cfg), cfg.head_dim,
                               cfg.rope_theta)
    return L.rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)


def _cast_block(block: _Params, cdt: torch.dtype) -> Dict[str, Any]:
    """A block's weights in the compute dtype, its children's as nested
    dicts; SSM decay scalars and the router stay float32."""
    out: Dict[str, Any] = {
        n: (p if n in _KEEP_F32 or not p.is_floating_point() else p.to(cdt))
        for n, p in block._parameters.items()}
    for n, m in block.named_children():
        out[n] = _cast_block(m, cdt)
    return out


def _apply_block(cfg: ArchConfig, kind, bp, x, cos_sin, mode, cache=None,
                 pos=None, enc=None, causal: bool = True):
    """One layer on ``x``; ``bp`` is the block's weights in the compute
    dtype.  Returns (x, the layer's new cache, the MoE aux loss)."""
    mixer, ffn = kind
    new_cache: Dict[str, Any] = {}
    h = L.rms_norm(x, bp["ln1"], cfg.norm_eps)
    akw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
               head_dim=cfg.head_dim, qk_norm=cfg.qk_norm,
               norm_eps=cfg.norm_eps)
    if mixer == "attn":
        if mode == "train":
            out = L.attn_train(bp["mixer"], h, causal=causal,
                               cos_sin=cos_sin,
                               sliding_window=cfg.sliding_window,
                               attn_chunk=cfg.attn_chunk, **akw)
        elif mode == "prefill":
            out, new_cache["self"] = L.attn_prefill(
                bp["mixer"], h, cache["self"], cos_sin=cos_sin,
                sliding_window=cfg.sliding_window,
                attn_chunk=cfg.attn_chunk, **akw)
        else:
            out, new_cache["self"] = L.attn_decode(
                bp["mixer"], h, cache["self"], pos, cos_sin=cos_sin, **akw)
        x = x + out.to(x.dtype)
        if "xattn" in bp:
            hx = L.rms_norm(x, bp["lnx"], cfg.norm_eps)
            if mode == "decode":
                out = L.xattn_decode(bp["xattn"], hx, cache["cross"],
                                     n_heads=cfg.n_heads,
                                     n_kv_heads=cfg.n_kv_heads,
                                     head_dim=cfg.head_dim)
                new_cache["cross"] = cache["cross"]
            else:
                out = L.attn_train(bp["xattn"], hx, causal=False,
                                   cos_sin=None, x_kv=enc, **akw)
                if mode == "prefill":
                    new_cache["cross"] = L.xattn_make_cache(
                        bp["xattn"], enc, n_kv_heads=cfg.n_kv_heads,
                        head_dim=cfg.head_dim,
                        dtype=cache["cross"]["k"].dtype)
            x = x + out.to(x.dtype)
    else:  # mamba
        mkw = dict(n_heads=cfg.ssm_heads, head_dim=cfg.ssm_head_dim,
                   ssm_state=cfg.ssm_state, chunk=cfg.ssm_chunk,
                   norm_eps=cfg.norm_eps)
        if mode == "train":
            out, _ = mamba2_mixer(bp["mixer"], h, **mkw)
        elif mode == "prefill":
            out, new_cache = mamba2_mixer(bp["mixer"], h, return_cache=True,
                                          **mkw)
        else:
            out, new_cache = mamba2_mixer(bp["mixer"], h, cache=cache, **mkw)
        x = x + out.to(x.dtype)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if ffn != "none":
        h2 = L.rms_norm(x, bp["ln2"], cfg.norm_eps)
        if ffn == "mlp":
            out = L.mlp(bp["ffn"], h2, act=cfg.act)
        elif cfg.moe_aux_weight and mode == "train":
            out, aux = moe_ffn(bp["ffn"], h2, n_experts=cfg.n_experts,
                               top_k=cfg.top_k, act=cfg.act,
                               capacity_factor=cfg.moe_capacity_factor,
                               return_aux=True)
        else:
            out = moe_ffn(bp["ffn"], h2, n_experts=cfg.n_experts,
                          top_k=cfg.top_k, act=cfg.act,
                          capacity_factor=cfg.moe_capacity_factor)
        x = x + out.to(x.dtype)
    return x, new_cache, aux


def _run_stack(cfg: ArchConfig, blocks: List[Dict], x, *, kinds, mode,
               caches, cos_sin=None, pos=None, enc=None):
    """The layers in order, prefill or decode, on the cast weights
    ``blocks`` (``repro`` scans over layer groups).  Returns (x, the new
    caches)."""
    new_caches = []
    for i, bp in enumerate(blocks):
        x, nc, _ = _apply_block(cfg, kinds[i], bp, x, cos_sin, mode,
                                cache=caches[i], pos=pos, enc=enc)
        new_caches.append(nc)
    return x, new_caches


# the products with no batch dimension, which "dots" remat keeps
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ArchConfig, fn):
    """``fn`` as one activation-checkpoint region: its outputs are
    recomputed in the backward pass from its inputs; under
    ``remat_policy == "dots"`` the outputs of ``aten.mm``/``aten.addmm``
    (``repro``'s dots with no batch dimension) are kept instead."""
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy)
    return functools.partial(ckpt.checkpoint, fn, use_reentrant=False, **kw)


def _train_stack(cfg: ArchConfig, blocks, x, *, kinds, period: int,
                 cos_sin=None, enc=None, causal: bool = True):
    """The layers of ``blocks`` (modules) in train mode, in groups of
    ``period`` consecutive layers (``repro``'s scan body), each group
    casting its weights to the compute dtype and, under ``cfg.remat``
    with autograd on, one checkpoint region.  Returns (x, the summed MoE
    aux loss)."""
    cdt = _dtype(cfg.compute_dtype)

    def group(x, lo: int):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(lo, lo + period):
            x, _, a = _apply_block(cfg, kinds[i], _cast_block(blocks[i], cdt),
                                   x, cos_sin, "train", enc=enc,
                                   causal=causal)
            aux = aux + a
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, len(blocks), period):
        fn = functools.partial(group, lo=lo)
        remat = cfg.remat and torch.is_grad_enabled()
        x, a = _remat(cfg, fn)(x) if remat else fn(x)
        aux = aux + a
    return x, aux


def _encode(cfg: ArchConfig, params: LM, audio_embeds):
    """The encoder stack on the audio frames (one layer a group)."""
    cdt = _dtype(cfg.compute_dtype)
    enc = audio_embeds.to(cdt)
    enc = enc + L.sinusoidal_positions(enc.shape[1], cfg.d_model,
                                       device=enc.device).to(cdt)[None]
    enc, _ = _train_stack(cfg, params.enc_blocks, enc,
                          kinds=[("attn", "mlp")] * len(params.enc_blocks),
                          period=1, causal=False)
    return L.rms_norm(enc, params.enc_norm, cfg.norm_eps)


def _embed_tokens(cfg: ArchConfig, params: LM, tokens, batch):
    """Take, then cast: the same bits as ``repro``'s cast-then-take, one
    vocab-th of the reading."""
    cdt = _dtype(cfg.compute_dtype)
    x = params.embed[tokens].to(cdt)
    if cfg.family == "vlm" and "patch_embeds" in batch:
        pe = batch["patch_embeds"]
        x[:, :pe.shape[1]] = pe.to(cdt)
    return x


def _logits(cfg: ArchConfig, params: LM, x):
    _, embed = params.casts(_dtype(cfg.compute_dtype))
    return x @ embed.T


def forward_hidden(cfg: ArchConfig, params: LM, batch):
    """Forward pass up to the final norm, under autograd (the training
    path: weights cast inside each remat group).

    Returns ((B, S, d) hidden states, moe aux loss scalar)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = _embed_tokens(cfg, params, tokens, batch)
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    cos_sin = _rope(cfg, positions, batch.get("positions"))
    enc = (_encode(cfg, params, batch["audio_embeds"])
           if cfg.family == "encdec" else None)
    x, aux = _train_stack(cfg, params.blocks, x, kinds=cfg.layer_kinds(),
                          period=cfg.scan_period(), cos_sin=cos_sin, enc=enc)
    return L.rms_norm(x, params.final_norm, cfg.norm_eps), aux


@torch.no_grad()
def forward_train(cfg: ArchConfig, params: LM, batch):
    """batch: tokens (B,S), optional positions (3,B,S) for M-RoPE,
    patch_embeds (B,P,d) for VLM, audio_embeds (B,F,d) for encdec.
    Returns logits (B, S, vocab_padded) in compute dtype
    (:func:`forward_hidden` without autograd)."""
    x, _ = forward_hidden(cfg, params, batch)
    return x @ params.embed.to(x.dtype).T


# ==========================================================================
# training
# ==========================================================================
def loss_fn(cfg: ArchConfig, params: LM, batch):
    """Mean next-token cross entropy over ``batch["labels"]`` (B, S): the
    logits in float32 after the product in the compute dtype, the padded
    vocabulary rows at -1e30; plus ``moe_aux_weight`` x the MoE aux loss
    where that weight is set."""
    x, aux = forward_hidden(cfg, params, batch)
    logits = (x @ params.embed.to(x.dtype).T).float()
    if cfg.vocab_padded != cfg.vocab:  # mask the padded vocab rows
        pad = torch.arange(cfg.vocab_padded, device=x.device) >= cfg.vocab
        logits = torch.where(pad, L.MASKED, logits)
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None])[..., 0]
    loss = torch.mean(logz - gold)
    if cfg.moe_aux_weight:
        loss = loss + cfg.moe_aux_weight * aux
    return loss


def _vocab_chunk(cfg: ArchConfig, h, emb_c, labels, lo: int, m, s, gold):
    """One vocab chunk of :func:`loss_fn_blocked`: its float32 logits,
    the online logsumexp's update and the gold logit where the label
    falls in the chunk."""
    vb = emb_c.shape[0]
    logits = h @ emb_c.float().T                                  # (B,S,vb)
    ids = lo + torch.arange(vb, device=h.device)
    logits = torch.where(ids >= cfg.vocab, L.MASKED, logits)
    m_new = torch.maximum(m, logits.amax(-1))
    s = s * torch.exp(m - m_new) + torch.exp(
        logits - m_new[..., None]).sum(-1)
    in_chunk = (labels >= lo) & (labels < lo + vb)
    local = logits.gather(-1, torch.clamp(labels - lo, 0, vb - 1)[..., None])
    return m_new, s, torch.where(in_chunk, local[..., 0], gold)


def loss_fn_blocked(cfg: ArchConfig, params: LM, batch, n_blocks: int = 8):
    """Vocab-blocked cross entropy: ``loss_fn`` without the (B, S, vocab)
    logits.  It walks ``n_blocks`` vocab chunks with an online logsumexp
    (running max + rescaled sum) in float32 and takes the gold logit from
    the chunk that holds the label.  Each chunk is a checkpoint region,
    so the backward pass recomputes its logits instead of holding them:
    one chunk's logits are alive at a time."""
    h, aux = forward_hidden(cfg, params, batch)
    h = h.float()                                                 # (B,S,d)
    labels = batch["labels"].long()
    vp = cfg.vocab_padded
    if vp % n_blocks:
        raise ValueError(f"n_blocks {n_blocks} does not divide the padded "
                         f"vocab {vp}")
    vb = vp // n_blocks
    m = torch.full(labels.shape, -torch.inf, dtype=torch.float32,
                   device=h.device)
    s = torch.zeros(labels.shape, dtype=torch.float32, device=h.device)
    gold = torch.zeros(labels.shape, dtype=torch.float32, device=h.device)
    for i in range(n_blocks):
        m, s, gold = ckpt.checkpoint(
            _vocab_chunk, cfg, h, params.embed[i * vb:(i + 1) * vb], labels,
            i * vb, m, s, gold, use_reentrant=False)
    loss = torch.mean(m + torch.log(s) - gold)
    if cfg.moe_aux_weight:
        loss = loss + cfg.moe_aux_weight * aux
    return loss


def make_train_step(cfg: ArchConfig, *, base_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10_000,
                    vocab_blocks: int = 0):
    """Returns step(model, opt_state, batch) -> (model, opt_state, metrics):
    the loss and its gradients by autograd, then one AdamW update of the
    module's parameters, in place, at the schedule's rate for step
    ``opt_state.step + 1``.  ``metrics`` holds ``loss``, ``lr`` and
    ``gnorm`` as 0-d device tensors (nothing is read back to the host).

    ``vocab_blocks > 0`` switches to the blocked cross entropy."""
    sched = optim.get_schedule(cfg.lr_schedule)
    lfn = (loss_fn if not vocab_blocks
           else functools.partial(loss_fn_blocked, n_blocks=vocab_blocks))

    def step(model: LM, opt_state: optim.AdamWState, batch):
        model.zero_grad(set_to_none=True)
        loss = lfn(cfg, model, batch)
        loss.backward()
        lr = sched(opt_state.step + 1, base_lr=base_lr, warmup=warmup,
                   total=total_steps)
        model, opt_state, gnorm = optim.adamw_update(model, opt_state, lr=lr)
        model.zero_grad(set_to_none=True)
        model.drop_casts()              # serving's copies are stale now
        return model, opt_state, {"loss": loss.detach(), "lr": lr,
                                  "gnorm": gnorm}

    return step


# ==========================================================================
# serving (prefill + decode)
# ==========================================================================
def cache_len(cfg: ArchConfig, max_len: int) -> int:
    return min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> List[Dict]:
    """Zeroed caches, one dict a layer: attention {"self": {"k","v"}
    (B, W, KV, D)} (+ "cross" (B, F, KV, D) in encoder-decoder models),
    Mamba-2 {"conv": (B, K-1, di+2N), "ssm": (B, H, P, N) float32}, on
    ``device`` (CUDA unless named)."""
    device = resolve_device(device)
    w = cache_len(cfg, max_len)
    caches = []
    for mixer, _ in cfg.layer_kinds():
        if mixer == "attn":
            kv = (batch, w, cfg.n_kv_heads, cfg.head_dim)
            c = {"self": {"k": torch.zeros(kv, dtype=dtype, device=device),
                          "v": torch.zeros(kv, dtype=dtype, device=device)}}
            if cfg.family == "encdec":
                xs = (batch, cfg.frontend_len, cfg.n_kv_heads, cfg.head_dim)
                c["cross"] = {
                    "k": torch.zeros(xs, dtype=dtype, device=device),
                    "v": torch.zeros(xs, dtype=dtype, device=device)}
        else:
            c = {"conv": torch.zeros((batch, cfg.ssm_conv - 1,
                                      cfg.d_inner + 2 * cfg.ssm_state),
                                     dtype=dtype, device=device),
                 "ssm": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                                     cfg.ssm_state), dtype=torch.float32,
                                    device=device)}
        caches.append(c)
    return caches


def cache_specs(cfg: ArchConfig, mesh: Mesh, batch: int, max_len: int,
                dtype=torch.bfloat16, kv_shard: str = "hd"):
    """(caches on ``meta``, their specs), both one dict a layer as
    :func:`init_cache` gives them; a spec is ``repro``'s without its group
    axis (``repro``'s is ``(None,) + spec``).  SSM state shards heads;
    batch shards the data axes (replicated when it cannot divide them,
    e.g. long_500k's B = 1).  K/V model-axis placement is selectable:
      * ``hd``  — shard head_dim (always divisible; contraction psum)
      * ``seq`` — shard the cache sequence dim (balanced attention read;
                  the decode write touches one shard per step)
      * ``kv``  — shard the KV-head dim (pads 8 heads -> model width)
      * ``none``— replicate over the model axis
    """
    n_da = int(np.prod([mesh.shape[a] for a in data_axes(mesh)]))
    da = spec_data_axes(mesh) if batch % n_da == 0 else None
    kv_spec = {"hd": (da, None, None, "model"),
               "seq": (da, "model", None, None),
               "kv": (da, None, "model", None),
               "none": (da, None, None, None)}[kv_shard]
    caches = init_cache(cfg, batch, max_len, dtype, device="meta")

    def rule(name: str, leaf):
        if isinstance(leaf, dict):
            return {k: rule(k, v) for k, v in leaf.items()}
        if name in ("k", "v"):
            return kv_spec
        if name == "conv":
            return (da, None, "model")
        return (da, "model", None, None)        # ssm state

    return caches, [rule("", c) for c in caches]


@torch.no_grad()
def prefill(cfg: ArchConfig, params: LM, batch, *,
            cache_dtype=torch.bfloat16, max_len: Optional[int] = None):
    """Full-prefix forward + cache fill.  Returns (last logits (B,
    vocab_padded) float32, caches).

    ``max_len`` sizes the cache (prefix + generation headroom); without a
    sliding window the ring must never wrap, so callers decoding beyond the
    prefix must pass prefix + max_new_tokens here."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    blocks, _ = params.casts(_dtype(cfg.compute_dtype))
    x = _embed_tokens(cfg, params, tokens, batch)
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    cos_sin = _rope(cfg, positions, batch.get("positions"))
    enc = (_encode(cfg, params, batch["audio_embeds"])
           if cfg.family == "encdec" else None)
    caches = init_cache(cfg, b, max_len or s, cache_dtype, device=x.device)
    x, caches = _run_stack(cfg, blocks, x, kinds=cfg.layer_kinds(),
                           mode="prefill", cos_sin=cos_sin, caches=caches,
                           enc=enc)
    x = L.rms_norm(x[:, -1:], params.final_norm, cfg.norm_eps)
    return _logits(cfg, params, x)[:, 0].float(), caches


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: LM, caches, token, pos,
                mrope_pos=None):
    """One decode step.  token (B,1) int; pos the token's absolute
    position, an int or a 0-d integer tensor on the model's device.  The
    position stays on the device (the ring slot and the validity mask are
    computed there), so the host never reads it back and a step can be
    replayed with ``pos`` updated in place.  Updates ``caches`` in place;
    returns (logits (B, vocab_padded) float32, caches)."""
    b = token.shape[0]
    blocks, _ = params.casts(_dtype(cfg.compute_dtype))
    x = params.embed[token].to(_dtype(cfg.compute_dtype))
    if not torch.is_tensor(pos):       # a fill on the device, no copy
        pos = torch.full((), pos, dtype=torch.long, device=x.device)
    positions = pos.expand(b, 1)
    if cfg.mrope and mrope_pos is None:
        mrope_pos = pos.expand(3, b, 1)
    cos_sin = _rope(cfg, positions, mrope_pos)
    x, caches = _run_stack(cfg, blocks, x, kinds=cfg.layer_kinds(),
                           mode="decode", cos_sin=cos_sin, caches=caches,
                           pos=pos)
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    return _logits(cfg, params, x)[:, 0].float(), caches

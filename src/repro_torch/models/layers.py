"""Shared transformer layers: norm, rotary embeddings, GQA attention, MLP.

The counterpart of :mod:`repro.models.layers`, as plain PyTorch.  Functions
over parameter dicts (``name -> tensor``, the names and layouts of
``repro``'s: a projection is ``(d_in, d_out)`` and applied as ``x @ w``);
the modules of :mod:`repro_torch.models.lm` hand them their weights.
Compute dtype is the caller's, with float32 softmax and norm accumulation.

``repro``'s ``activation_pins``, ``pin_hidden`` and ``_pin_heads`` are
sharding constraints for a TPU mesh.  On one card they are the identity,
so they are left out.

Where ``repro`` promotes mixed dtypes inside a product (a bfloat16
activation times a float32 weight), torch refuses them: :func:`promote`
casts the operands to the type ``repro`` computes in.

Attention comes in three modes:
  * ``attn_train``   — full-sequence, no cache (also the encoder path)
  * ``attn_prefill`` — full-sequence + fills the KV cache (ring-rolled when
                       a sliding window bounds the cache)
  * ``attn_decode``  — one token against a (possibly ring-buffer) cache,
                       written in place; keys carry RoPE applied at write
                       time, so a ring slot permutation never corrupts
                       relative positions.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

MASKED = -1e30                    # repro's mask value (not -inf)


def promote(*ts):
    """Cast tensors to their common type (``jnp``'s promotion for the
    float32/bfloat16 pairs this package mixes)."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return tuple(t.to(dt) for t in ts)


def einsum(eq: str, *ops):
    return torch.einsum(eq, *promote(*ops))


def matmul(a, b):
    a, b = promote(a, b)
    return a @ b


def rms_norm(x, weight, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * weight.float()).to(dtype)


def sinusoidal_positions(seq_len: int, d_model: int, offset=0,
                         device=None):
    """Whisper-style fixed positional encoding (stands in for its learned
    embeddings)."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device) + offset
    dim = torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
    inv = torch.exp(-dim * math.log(10000.0) / d_model)
    ang = pos[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# --------------------------------------------------------------------------
# rotary position embeddings (standard RoPE + Qwen2-VL's 3-section M-RoPE)
# --------------------------------------------------------------------------
def _inv_freq(head_dim: int, theta: float, device):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_cos_sin(positions, head_dim: int, theta: float):
    """positions (B, S) -> cos/sin (B, S, head_dim/2) in float32."""
    inv = _inv_freq(head_dim, theta, positions.device)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def mrope_cos_sin(positions_3d, sections: Tuple[int, int, int],
                  head_dim: int, theta: float):
    """Qwen2-VL M-RoPE: head_dim/2 frequency slots split into (temporal,
    height, width) sections, each rotated by its own position stream.
    positions_3d (3, B, S) -> cos/sin (B, S, head_dim/2)."""
    t_sec, h_sec, w_sec = sections
    if t_sec + h_sec + w_sec != head_dim // 2:
        raise ValueError(f"M-RoPE sections {sections} do not cover "
                         f"head_dim/2 = {head_dim // 2}")
    dev = positions_3d.device
    sel = torch.cat([torch.zeros(t_sec, dtype=torch.long, device=dev),
                     torch.ones(h_sec, dtype=torch.long, device=dev),
                     torch.full((w_sec,), 2, dtype=torch.long, device=dev)])
    pos = positions_3d[sel].movedim(0, -1)          # (B, S, d2)
    ang = pos.float() * _inv_freq(head_dim, theta, dev)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x (B, S, H, D); cos/sin (B, S, D/2) — rotate-half convention."""
    d2 = x.shape[-1] // 2
    x1 = x[..., :d2].float()
    x2 = x[..., d2:].float()
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention core
# --------------------------------------------------------------------------
def _repeat_kv(x, n_rep: int):
    """(B, S, KV, D) -> (B, S, KV * n_rep, D); query head h reads kv head
    h // n_rep."""
    if n_rep == 1:
        return x
    return x.repeat_interleave(n_rep, dim=2)


def _scale(d: int) -> float:
    """1 / sqrt(d) as float32 arithmetic rounds it (a float32 value, so a
    float32 tensor multiplies by it exactly as by ``repro``'s scalar)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def sdpa(q, k, v, *, causal: bool, sliding_window: Optional[int] = None,
         kv_valid: Optional[torch.Tensor] = None):
    """q (B,Sq,H,D); k,v (B,Sk,KV,D); float32 softmax accumulation.

    ``kv_valid``: (Sk,) bool validity (decode ring caches); when given,
    causal/sliding masks are assumed already encoded in validity.
    """
    b, sq, h, d = q.shape
    k = _repeat_kv(k, h // k.shape[2])
    v = _repeat_kv(v, h // v.shape[2])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    sk = k.shape[1]
    if kv_valid is not None:
        keep = kv_valid
    else:
        q_pos = torch.arange(sq, device=q.device)[:, None]
        k_pos = torch.arange(sk, device=q.device)[None, :]
        keep = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
        if causal:
            keep &= k_pos <= q_pos
        if sliding_window is not None:
            keep &= k_pos > q_pos - sliding_window
    if logits.requires_grad:
        # in place, on the einsum's output (a view), autograd would copy
        # the (B, H, Sq, Sk) logits three times in the backward pass
        logits = torch.where(keep, logits * _scale(d), MASKED)
    else:
        logits.mul_(_scale(d)).masked_fill_(~keep, MASKED)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    del logits
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.to(q.dtype))


def sdpa_chunked(q, k, v, *, causal: bool,
                 sliding_window: Optional[int] = None, kv_chunk: int = 2048):
    """Flash-style attention: a loop over KV chunks with an online softmax.

    Never materializes the (B, H, Sq, Sk) logits.  As in ``repro``, K/V are
    padded with zeros to whole chunks and the pad masked (``k_pos < sk``);
    a chunk masked entirely contributes ``exp(0)`` terms that a later
    chunk's correction ``exp(m - m_new)`` wipes out."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    k = _repeat_kv(k, h // k.shape[2])
    v = _repeat_kv(v, h // v.shape[2])
    pad = -sk % kv_chunk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    n_chunks = (sk + pad) // kv_chunk
    scale = _scale(d)
    qf = q.float()
    q_pos = torch.arange(sq, device=q.device)[:, None]
    o = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq), -math.inf, dtype=torch.float32,
                   device=q.device)
    s = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    for i in range(n_chunks):
        kc = k[:, i * kv_chunk:(i + 1) * kv_chunk].float()
        vc = v[:, i * kv_chunk:(i + 1) * kv_chunk].float()
        logits = torch.einsum("bqhd,bkhd->bhqk", qf, kc) * scale
        k_pos = i * kv_chunk + torch.arange(kv_chunk,
                                            device=q.device)[None, :]
        keep = k_pos < sk                       # drop the pad tail
        if causal:
            keep = keep & (k_pos <= q_pos)
        if sliding_window is not None:
            keep = keep & (k_pos > q_pos - sliding_window)
        logits = torch.where(keep, logits, MASKED)
        m_new = torch.maximum(m, logits.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        s = s * corr + p.sum(-1)
        o = o * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vc)
        m = m_new
    out = o / torch.clamp(s[..., None], min=1e-30)
    return out.movedim(1, 2).to(q.dtype)        # (B, Sq, H, D)


def _qkv(params, x, x_kv, n_heads, n_kv_heads, head_dim, qk_norm, norm_eps):
    b, sq, _ = x.shape
    src = x if x_kv is None else x_kv
    sk = src.shape[1]
    q = x @ params["wq"]
    k = src @ params["wk"]
    v = src @ params["wv"]
    if "bq" in params:
        q = q + params["bq"].to(q.dtype)
        k = k + params["bk"].to(k.dtype)
        v = v + params["bv"].to(v.dtype)
    q = q.reshape(b, sq, n_heads, head_dim)
    k = k.reshape(b, sk, n_kv_heads, head_dim)
    v = v.reshape(b, sk, n_kv_heads, head_dim)
    if qk_norm:
        q = rms_norm(q, params["q_norm"], norm_eps)
        k = rms_norm(k, params["k_norm"], norm_eps)
    return q, k, v


def _attend(q, k, v, *, causal, sliding_window, attn_chunk):
    if attn_chunk:
        return sdpa_chunked(q, k, v, causal=causal,
                            sliding_window=sliding_window,
                            kv_chunk=attn_chunk)
    return sdpa(q, k, v, causal=causal, sliding_window=sliding_window)


def attn_train(params, x, *, n_heads, n_kv_heads, head_dim, causal=True,
               cos_sin=None, qk_norm=False, sliding_window=None,
               norm_eps=1e-6, x_kv=None, attn_chunk=0):
    """Full-sequence attention (training forward / encoder /
    cross-attention).  ``attn_chunk > 0`` switches to the chunked form."""
    b, sq, _ = x.shape
    q, k, v = _qkv(params, x, x_kv, n_heads, n_kv_heads, head_dim,
                   qk_norm, norm_eps)
    if cos_sin is not None:
        q = apply_rope(q, *cos_sin)
        if x_kv is None:
            k = apply_rope(k, *cos_sin)
    out = _attend(q, k, v, causal=causal and x_kv is None,
                  sliding_window=sliding_window, attn_chunk=attn_chunk)
    return out.reshape(b, sq, n_heads * head_dim) @ params["wo"]


def attn_prefill(params, x, cache, *, n_heads, n_kv_heads, head_dim,
                 cos_sin=None, qk_norm=False, sliding_window=None,
                 norm_eps=1e-6, attn_chunk=0):
    """Causal prefill; fills ``cache`` {"k","v"} (B, W, KV, D) in place
    and returns it.

    W < S means a sliding-window ring cache: the last W (rope'd) keys are
    rolled so token t lands in slot t mod W — decode then appends at
    (pos mod W) with no relocation.
    """
    b, s, _ = x.shape
    q, k, v = _qkv(params, x, None, n_heads, n_kv_heads, head_dim,
                   qk_norm, norm_eps)
    if cos_sin is not None:
        q = apply_rope(q, *cos_sin)
        k = apply_rope(k, *cos_sin)
    out = _attend(q, k, v, causal=True, sliding_window=sliding_window,
                  attn_chunk=attn_chunk)
    ck, cv = cache["k"], cache["v"]
    w = ck.shape[1]
    if w < s:
        ck.copy_(torch.roll(k[:, -w:], s % w, dims=1))
        cv.copy_(torch.roll(v[:, -w:], s % w, dims=1))
    else:
        ck[:, :s] = k
        cv[:, :s] = v
    return out.reshape(b, s, n_heads * head_dim) @ params["wo"], cache


def attn_decode(params, x, cache, pos, *, n_heads, n_kv_heads,
                head_dim, cos_sin=None, qk_norm=False, norm_eps=1e-6):
    """One-token decode against a (ring) cache; x (B, 1, d), pos the
    token's absolute position as a 0-d integer tensor on x's device.
    Writes slot ``pos % W`` of ``cache`` in place (an ``index_copy_``, so
    the host never reads ``pos``) and returns it.

    Keys in the cache already carry RoPE; masking is pure validity:
    valid slots = min(pos+1, W) (a full ring holds exactly the last W
    tokens, which is the sliding window by construction).
    """
    b = x.shape[0]
    q, k, v = _qkv(params, x, None, n_heads, n_kv_heads, head_dim,
                   qk_norm, norm_eps)
    if cos_sin is not None:
        q = apply_rope(q, *cos_sin)
        k = apply_rope(k, *cos_sin)
    ck, cv = cache["k"], cache["v"]
    w = ck.shape[1]
    slot = (pos % w).reshape(1)
    ck.index_copy_(1, slot, k.to(ck.dtype))
    cv.index_copy_(1, slot, v.to(cv.dtype))
    kv_valid = torch.arange(w, device=x.device) < torch.clamp(pos + 1,
                                                              max=w)
    out = sdpa(q, ck.to(q.dtype), cv.to(q.dtype), causal=False,
               kv_valid=kv_valid)
    return out.reshape(b, 1, n_heads * head_dim) @ params["wo"], cache


def xattn_decode(params, x, cross_cache, *, n_heads, n_kv_heads, head_dim,
                 norm_eps=1e-6):
    """Cross-attention during decode: K/V fixed from the encoder (cached)."""
    b = x.shape[0]
    q = x @ params["wq"]
    if "bq" in params:
        q = q + params["bq"].to(q.dtype)
    q = q.reshape(b, 1, n_heads, head_dim)
    out = sdpa(q, cross_cache["k"].to(q.dtype),
               cross_cache["v"].to(q.dtype), causal=False)
    return out.reshape(b, 1, n_heads * head_dim) @ params["wo"]


def xattn_make_cache(params, enc, *, n_kv_heads, head_dim, dtype):
    """Precompute cross-attention K/V from encoder states (prefill)."""
    b, sk, _ = enc.shape
    k = enc @ params["wk"]
    v = enc @ params["wv"]
    if "bk" in params:
        k = k + params["bk"].to(k.dtype)
        v = v + params["bv"].to(v.dtype)
    return {"k": k.reshape(b, sk, n_kv_heads, head_dim).to(dtype),
            "v": v.reshape(b, sk, n_kv_heads, head_dim).to(dtype)}


# --------------------------------------------------------------------------
# feed-forward
# --------------------------------------------------------------------------
def _activation(act: str):
    """``repro``'s activations: SiLU, or GELU in its tanh form (the
    default of ``jax.nn.gelu``)."""
    if act == "silu":
        return F.silu
    return lambda x: F.gelu(x, approximate="tanh")


def mlp(params, x, act: str = "silu"):
    """SwiGLU (w_gate present) or plain 2-layer MLP."""
    a = _activation(act)
    if "w_gate" in params:
        hidden = a(x @ params["w_gate"]) * (x @ params["w_in"])
    else:
        hidden = a(x @ params["w_in"])
    return hidden @ params["w_out"]

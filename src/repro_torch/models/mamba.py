"""Mamba-2 (SSD — state-space duality) mixer: the chunked-scan form for a
whole sequence plus the O(1)-per-token recurrent decode form.

The counterpart of :mod:`repro.models.mamba`, as plain PyTorch.  The
sequence is split into chunks; intra-chunk outputs come from a masked
attention-like quadratic form, inter-chunk state from a recurrence over
the chunks, carried in float32 (a Python loop here, ``lax.scan`` in
``repro``).  Both forms share parameters, so prefill hands its final state
to decode.

Shapes (single group, g=1, as in mamba2-370m):
  x (B, S, d_model); d_inner = expand*d_model; H heads of head_dim P;
  state size N; dt (B, S, H); A (H,) negative; B_, C_ (B, S, N).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import einsum, matmul, rms_norm


def _segsum(x):
    """Stable 'segment sum' producing the lower-triangular decay matrix.

    x (..., L) -> (..., L, L) with out[i, j] = sum_{k in (j, i]} x[k] for
    j < i, 0 on diagonal, -inf above."""
    L = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(xh, dt, A, B_, C_, *, chunk: int):
    """Chunked SSD scan.

    xh (B, S, H, P); dt (B, S, H) (already softplus'd); A (H,) < 0;
    B_, C_ (B, S, N).  Returns (y (B, S, H, P), final_state (B, H, P, N)).
    """
    b, s, h, p = xh.shape
    n = B_.shape[-1]
    pad = -s % chunk
    if pad:  # dt=0 padding is state-neutral (decay exp(0)=1, zero update)
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, pad))
    s_p = s + pad
    c = s_p // chunk

    # chunked views
    xc = xh.reshape(b, c, chunk, h, p)
    dtc = dt.reshape(b, c, chunk, h)
    Bc = B_.reshape(b, c, chunk, n)
    Cc = C_.reshape(b, c, chunk, n)

    dA = dtc * A[None, None, None, :]                      # (b,c,l,h) <= 0
    dA_cum = torch.cumsum(dA, dim=2)                       # (b,c,l,h)

    # 1. intra-chunk (the "duality": masked attention within a chunk)
    L = torch.exp(_segsum(dA.movedim(2, 3)))               # (b,c,h,l,l)
    att = torch.einsum("bcln,bcmn->bclm", Cc, Bc)          # (b,c,l,l)
    scores = att[:, :, None, :, :] * L                     # (b,c,h,l,m)
    xw = xc * dtc[..., None]                               # dt-weighted input
    y_diag = einsum("bchlm,bcmhp->bclhp", scores, xw)

    # 2. per-chunk final states
    decay_states = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)   # (b,c,l,h)
    states = einsum("bcln,bclh,bclhp->bchpn", Bc, decay_states * dtc, xc)

    # 3. inter-chunk recurrence over the chunks, carried in float32
    chunk_decay = torch.exp(dA_cum[:, :, -1, :]).float()   # (b,c,h)
    states = states.float()
    carry = torch.zeros((b, h, p, n), dtype=torch.float32, device=xh.device)
    prev = []
    for i in range(c):
        prev.append(carry)                                 # emit PREVIOUS
        carry = carry * chunk_decay[:, i, :, None, None] + states[:, i]
    prev_states = torch.stack(prev, dim=1)                 # (b,c,h,p,n)

    # 4. state -> output contribution
    state_decay = torch.exp(dA_cum)                        # (b,c,l,h)
    y_off = einsum("bcln,bchpn,bclh->bclhp", Cc, prev_states, state_decay)
    y = (y_diag + y_off).reshape(b, s_p, h, p)[:, :s]
    return y, carry


def _causal_conv(x, w, cache: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Depthwise causal conv1d, kernel K.  x (B, S, C); w (K, C).

    With ``cache`` (B, K-1, C): decode mode (S == 1), returns new cache.
    """
    k = w.shape[0]
    if cache is None:
        s = x.shape[1]
        xp = F.pad(x, (0, 0, k - 1, 0))
        out = xp[:, 0:s, :] * w[0][None, None]
        for i in range(1, k):
            out = out + xp[:, i:i + s, :] * w[i][None, None]
        return out, None
    ctx = torch.cat([cache, x], dim=1)                     # (B, K, C)
    out = einsum("bkc,kc->bc", ctx, w)[:, None, :]
    return out, ctx[:, 1:, :]


def mamba2_mixer(params, x, *, n_heads: int, head_dim: int, ssm_state: int,
                 chunk: int = 256, norm_eps: float = 1e-6,
                 cache: Optional[dict] = None, return_cache: bool = False):
    """Mamba-2 block mixer.  params:
      in_proj (d, 2*di + 2*N + H), conv_w (K, di + 2*N), A_log (H,),
      D (H,), dt_bias (H,), gate_norm (di,), out_proj (di, d).

    cache (decode): {"conv": (B, K-1, di+2N), "ssm": (B, H, P, N)}.
    Returns (y (B,S,d), new_cache | None).
    """
    b, s, d = x.shape
    di = n_heads * head_dim
    n = ssm_state

    zxbcdt = x @ params["in_proj"]                         # (B,S,2di+2N+H)
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * n, n_heads], dim=-1)
    dt = F.softplus(dt + params["dt_bias"])                # (B,S,H)

    conv_cache = cache["conv"] if cache is not None else None
    xbc_raw = xbc  # pre-conv stream (its tail seeds the decode conv cache)
    xbc, new_conv = _causal_conv(xbc, params["conv_w"], conv_cache)
    xbc = F.silu(xbc)
    xs, B_, C_ = torch.split(xbc, [di, n, n], dim=-1)
    xh = xs.reshape(b, s, n_heads, head_dim)
    A = -torch.exp(params["A_log"].float())                # (H,) < 0

    if cache is None:
        y, final = ssd_chunked(xh, dt, A, B_, C_, chunk=chunk)
        new_cache = None
        if return_cache:  # prefill: hand the final state to decode
            k = params["conv_w"].shape[0]
            new_cache = {"conv": xbc_raw[:, -(k - 1):, :], "ssm": final}
    else:
        # recurrent decode: h' = exp(dt*A) h + dt * B ⊗ x ; y = C·h
        h_prev = cache["ssm"]                              # (B,H,P,N)
        dA = torch.exp(dt[:, 0, :] * A[None, :])           # (B,H)
        upd = einsum("bh,bhp,bn->bhpn", dt[:, 0], xh[:, 0], B_[:, 0])
        h_new = h_prev * dA[..., None, None] + upd
        y = einsum("bn,bhpn->bhp", C_[:, 0], h_new)[:, None]
        y = y.reshape(b, 1, n_heads, head_dim)
        new_cache = {"conv": new_conv, "ssm": h_new}

    y = y + xh * params["D"][None, None, :, None]          # skip connection
    y = y.reshape(b, s, di)
    y = rms_norm(y * F.silu(z), params["gate_norm"], norm_eps)
    return matmul(y, params["out_proj"]), new_cache

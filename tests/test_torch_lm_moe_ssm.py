"""The port's LM substrate against ``repro``'s on the CPU: the MoE, hybrid
and SSM smoke configs end to end (the checks of ``test_torch_lm.py``),
the MoE dispatch with capacity drops, the chunked SSD scan and the causal
convolution.  Mixtral's smoke prompt runs past its 32-token window, so its
ring cache rolls at prefill and wraps while decoding."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.models import mamba as jmamba
from repro.models import moe as jmoe
from repro_torch import configs as tconfigs
from repro_torch.models import lm as tlm
from repro_torch.models import mamba as tmamba
from repro_torch.models import moe as tmoe
from test_torch_lm import check_smoke

MOE_SSM_ARCHS = ["mixtral-8x22b", "llama4-maverick-400b-a17b",
                 "jamba-v0.1-52b", "mamba2-370m"]


@pytest.mark.parametrize("arch", MOE_SSM_ARCHS)
def test_smoke_config_matches_repro(arch):
    check_smoke(arch)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "mamba2-370m"])
def test_bf16_compute_matches_repro(arch):
    """The smoke configs computing in bfloat16, as configured; Mamba-2's
    decode drifts from its chunked forward in ``repro`` too, and the
    port's drift is held to a factor of ``repro``'s."""
    check_smoke(arch, tol=2e-2, compute_dtype="bfloat16")


@pytest.mark.parametrize("arch", MOE_SSM_ARCHS)
def test_param_counts_match_repro(arch):
    jcfg, tcfg = jconfigs.get_arch(arch), tconfigs.get_arch(arch)
    assert tlm.param_count(tcfg) == jlm.param_count(jcfg)
    assert tlm.active_param_count(tcfg) == jlm.active_param_count(jcfg)


def moe_params(rng, d=32, e=4, f=48, shared=False):
    p = {"router": rng.normal(size=(d, e)),
         "w_in": rng.normal(size=(e, d, f)) * 0.1,
         "w_gate": rng.normal(size=(e, d, f)) * 0.1,
         "w_out": rng.normal(size=(e, f, d)) * 0.1}
    if shared:
        p.update(shared_w_in=rng.normal(size=(d, f)) * 0.1,
                 shared_w_gate=rng.normal(size=(d, f)) * 0.1,
                 shared_w_out=rng.normal(size=(f, d)) * 0.1)
    return {k: v.astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("top_k,shared", [(2, False), (1, True)])
def test_moe_ffn_with_capacity_drops_matches_repro(top_k, shared):
    """capacity_factor 0.5 gives each expert room for half its even share,
    so pairs are dropped; the aux loss too."""
    rng = np.random.default_rng(7)
    p = moe_params(rng, shared=shared)
    x = rng.normal(size=(2, 12, 32)).astype(np.float32)
    kw = dict(n_experts=4, top_k=top_k, capacity_factor=0.5,
              return_aux=True)
    want, want_aux = jmoe.moe_ffn({k: jnp.asarray(v) for k, v in p.items()},
                                  jnp.asarray(x), **kw)
    got, got_aux = tmoe.moe_ffn({k: torch.from_numpy(v)
                                 for k, v in p.items()},
                                torch.from_numpy(x), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-6)
    # some pairs were dropped: their tokens' outputs lack those experts
    probs = torch.softmax(torch.from_numpy(x.reshape(-1, 32))
                          @ torch.from_numpy(p["router"]), -1)
    load = torch.bincount(torch.topk(probs, top_k).indices.reshape(-1),
                          minlength=4)
    assert int(load.max()) > max(int(24 * top_k * 0.5 / 4), 4)


@pytest.mark.parametrize("s,chunk", [(20, 8), (16, 8), (5, 8)])
def test_ssd_chunked_matches_repro(s, chunk):
    rng = np.random.default_rng(8)
    b, h, p, n = 2, 3, 4, 6
    xh = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)))).astype(np.float32)
    A = -np.exp(rng.normal(size=(h,)) * 0.3).astype(np.float32)
    B_ = rng.normal(size=(b, s, n)).astype(np.float32)
    C_ = rng.normal(size=(b, s, n)).astype(np.float32)
    y, final = jmamba.ssd_chunked(*map(jnp.asarray, (xh, dt, A, B_, C_)),
                                  chunk=chunk)
    ty, tfinal = tmamba.ssd_chunked(*map(torch.from_numpy,
                                         (xh, dt, A, B_, C_)), chunk=chunk)
    assert ty.shape == (b, s, h, p) and tfinal.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tfinal.numpy(), np.asarray(final), rtol=1e-4,
                               atol=1e-5)


def test_segsum_matches_repro():
    x = np.random.default_rng(9).normal(size=(2, 6)).astype(np.float32)
    got = tmamba._segsum(torch.from_numpy(x)).numpy()
    want = np.asarray(jmamba._segsum(jnp.asarray(x)))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[~np.isinf(got)], want[~np.isinf(want)],
                               atol=1e-6)


def test_causal_conv_prefill_and_decode_match_repro():
    rng = np.random.default_rng(10)
    x = rng.normal(size=(2, 9, 5)).astype(np.float32)
    w = rng.normal(size=(4, 5)).astype(np.float32)
    want, _ = jmamba._causal_conv(jnp.asarray(x), jnp.asarray(w))
    got, _ = tmamba._causal_conv(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # decode: the cache holds the last K-1 inputs; one new token
    cache = x[:, -3:]
    tok = rng.normal(size=(2, 1, 5)).astype(np.float32)
    want, want_c = jmamba._causal_conv(jnp.asarray(tok), jnp.asarray(w),
                                       jnp.asarray(cache))
    got, got_c = tmamba._causal_conv(torch.from_numpy(tok),
                                     torch.from_numpy(w),
                                     torch.from_numpy(cache))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    full, _ = tmamba._causal_conv(
        torch.from_numpy(np.concatenate([x, tok], 1)), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy()[:, 0], full.numpy()[:, -1],
                               rtol=1e-5, atol=1e-6)

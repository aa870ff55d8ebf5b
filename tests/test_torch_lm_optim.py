"""The port's optimiser, LR schedules, train step and token stream against
``repro``'s on the CPU.

``adamw_update`` is fed the same gradients as ``repro``'s for three steps
(float32 and bfloat16 leaves); the cosine and WSD schedules are compared
at the steps where their branches meet; ``make_train_step`` runs five
steps from the same weights (``params_from_jax``) on the same batches in
both packages; ``token_batches`` draws the same arrays from the same
generator.  Two tests guard serving's cached bf16 copies: after a step,
or a ``load_state_dict``, ``prefill`` must read the new weights.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from repro.data import pipeline as jpipeline
from repro.models import lm as jlm
from repro.models import optim as joptim
from repro_torch import configs as tconfigs
from repro_torch.data import pipeline as tpipeline
from repro_torch.models import lm as tlm
from repro_torch.models import optim as toptim
from test_torch_lm import jax_batch, smoke_case, torch_batch
from test_torch_lm_train import (ZERO_TOL, leaves, port_tree, train_batch,
                                 zero_leaf)

# (name, shape, dtype) of the optimiser test's leaves; repro flattens a
# dict in key order, the module registers them in this order too
LEAVES = (("a", (8, 16), "float32"), ("b", (40,), "bfloat16"),
          ("c", (4, 4, 4), "float32"), ("d", (6, 5), "bfloat16"))


class Leaves(nn.Module):
    def __init__(self, arrays: dict):
        super().__init__()
        for name, a in arrays.items():
            t = torch.from_numpy(np.array(a, np.float32))
            self.register_parameter(name, nn.Parameter(
                t.to(getattr(torch, a.dtype.name))))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def close(got, want, what: str):
    """Within 1e-6 of ``want``'s largest magnitude: the packages sum the
    squared gradients in another order, so the clip scale can differ by
    an ulp, and where a moment's terms cancel that ulp is a larger part
    of the element than 1e-6 of it."""
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max(), err_msg=what)


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bfloat16 values at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("grad_scale", [0.01, 10.0],
                         ids=["unclipped", "clipped"])
def test_adamw_update_matches_repro(grad_scale):
    """Three steps fed the same gradients: float32 leaves and the float32
    moments within 1e-6 (:func:`close`), bfloat16 leaves within one
    bfloat16 ulp;
    the gradient norm too (at 10x the norm exceeds ``grad_clip`` 1, so
    the clip scales every gradient)."""
    rng = np.random.default_rng(3)
    params = {n: jnp.asarray(0.02 * rng.normal(size=s), getattr(jnp, dt))
              for n, s, dt in LEAVES}
    model = Leaves({n: np.asarray(p) for n, p in params.items()})
    state, tstate = joptim.adamw_init(params), toptim.adamw_init(model)
    for step in range(3):
        grads = {n: jnp.asarray(grad_scale * rng.normal(size=s),
                                getattr(jnp, dt)) for n, s, dt in LEAVES}
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(np.array(grads[n], np.float32)
                                      ).to(p.dtype)
        params, state, gnorm = joptim.adamw_update(params, grads, state,
                                                   lr=1e-2)
        model, tstate, tgnorm = toptim.adamw_update(model, tstate, lr=1e-2)
        assert int(tstate.step) == int(state.step) == step + 1
        np.testing.assert_allclose(float(tgnorm), float(gnorm), rtol=1e-6)
        for n, s, dt in LEAVES:
            got = to_numpy(getattr(model, n))
            want = np.asarray(params[n], np.float32)
            assert tstate.m[n].dtype == torch.float32
            close(to_numpy(tstate.m[n]), np.asarray(state.m[n]), f"m {n}")
            close(to_numpy(tstate.v[n]), np.asarray(state.v[n]), f"v {n}")
            if dt == "bfloat16":
                assert getattr(model, n).dtype == torch.bfloat16
                assert (np.abs(got - want) <= bf16_ulp(want)).all(), n
            else:
                close(got, want, n)


@pytest.mark.parametrize("name", ["cosine", "wsd"])
def test_schedule_matches_repro(name):
    """At step 0, 1, warmup - 1, warmup, mid-way, the WSD decay start
    (90 % of ``total``), ``total`` and past it."""
    warmup, total = 20, 200
    kw = dict(base_lr=3e-3, warmup=warmup, total=total)
    jsched, tsched = joptim.get_schedule(name), toptim.get_schedule(name)
    for step in (0, 1, warmup - 1, warmup, (warmup + total) // 2, 180, 185,
                 total, total + 7):
        want = float(jsched(jnp.asarray(step, jnp.int32), **kw))
        got = tsched(torch.tensor(step, dtype=torch.int32), **kw)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, rtol=1e-6,
                                   err_msg=f"{name} step {step}")


STEP_ARCHS = ["qwen3-14b", "minicpm-2b", "mixtral-8x22b", "mamba2-370m",
              "jamba-v0.1-52b", "whisper-large-v3", "qwen2-vl-72b"]
STEPS, BASE_LR = 5, 1e-3
# A leaf's weights within UPDATE_TOL of its update (norms) and its final
# moments within MOMENT_TOL of their largest magnitude.  The gradients
# agree within GRAD_TOL (1e-4) of each leaf's largest |g|; Adam divides
# each element by its own sqrt(v), which makes the relative difference of
# a small-gradient element's step larger, and each moment sums five steps'
# gradients, the later ones taken at weights that already differ.  Over
# these configs the worst reading is 2.8e-4 for the weights and 1.5e-4 for
# the moments; a step skipped or applied with the wrong sign moves a leaf
# by more than a fifth of its update.
UPDATE_TOL, MOMENT_TOL = 1e-2, 1e-3


@pytest.mark.parametrize("arch, vocab_blocks", [
    *(pytest.param(a, 0, id=a) for a in STEP_ARCHS),
    pytest.param("minicpm-2b", 2, id="minicpm-2b-vocab_blocks2")])
def test_make_train_step_matches_repro(arch, vocab_blocks):
    """Five steps of ``make_train_step`` from the same weights on the same
    batches (minicpm on its WSD schedule, the rest cosine; warmup 2 of
    20 steps, so that the last step's rate is no small part of the sum;
    ``vocab_blocks`` 2 trains on the blocked cross entropy): each step's
    loss and rate within rtol 1e-5; then the weights and the AdamW
    moments.  Each leaf's weights lie within UPDATE_TOL x the norm of its
    update (``repro``'s final weights less the initial ones), and every
    weight within 2 x the sum of the rates.  That sum bounds what the
    update can move a weight whose gradient is at rounding level and
    flips its sign between the packages (Adam's normalized step is at
    most ~1 a step, weight decay adds 0.1 x |w| ~ 2e-3 of it): the whole
    bound for the leaves whose gradient is zero in exact arithmetic
    (``zero_leaf``), whose moments are held below ZERO_TOL (m) and
    ZERO_TOL ** 2 (v) of the model's largest."""
    jcfg, tcfg, params, model = smoke_case(arch)
    w0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    kw = dict(base_lr=BASE_LR, warmup=2, total_steps=4 * STEPS,
              vocab_blocks=vocab_blocks)
    jstep = jax.jit(jlm.make_train_step(jcfg, **kw))
    tstep = tlm.make_train_step(tcfg, **kw)
    state, tstate = joptim.adamw_init(params), toptim.adamw_init(model)
    lr_sum = 0.0
    for i in range(STEPS):
        batch = train_batch(jcfg, seed=i)
        params, state, m = jstep(params, state, jax_batch(batch))
        model, tstate, tm = tstep(model, tstate, torch_batch(batch))
        for key in ("loss", "lr", "gnorm"):
            assert torch.is_tensor(tm[key]) and tm[key].dim() == 0
        np.testing.assert_allclose(float(tm["loss"]), float(m["loss"]),
                                   rtol=1e-5, err_msg=f"step {i}")
        np.testing.assert_allclose(float(tm["lr"]), float(m["lr"]),
                                   rtol=1e-5)
        lr_sum += float(m["lr"])
    assert all(p.grad is None for p in model.parameters())
    assert int(tstate.step) == int(state.step) == STEPS
    want = tlm.params_from_jax(tcfg, jax.tree.map(np.asarray, params), "cpu")
    for (name, got), (_, ref) in zip(model.named_parameters(),
                                     want.named_parameters()):
        err = (got - ref).abs().max().item()
        assert err <= 2 * lr_sum, f"{name}: {err} > {2 * lr_sum}"
        if not zero_leaf(tcfg, name):
            diff = (got - ref).norm().item()
            update = (ref - w0[name]).norm().item()
            assert diff <= UPDATE_TOL * update, f"{name}: {diff} {update}"
    for key in ("m", "v"):
        got = dict(leaves(port_tree(tcfg, getattr(tstate, key).items())))
        ref = dict(leaves(jax.tree.map(np.asarray, getattr(state, key))))
        assert got.keys() == ref.keys()
        top = max(np.abs(r).max() for r in ref.values())
        for name, r in ref.items():
            if zero_leaf(tcfg, name):
                bound = (ZERO_TOL if key == "m" else ZERO_TOL ** 2) * top
                assert np.abs(got[name]).max() < bound, f"{key} {name}"
                assert np.abs(r).max() < bound, f"{key} {name}"
            else:
                np.testing.assert_allclose(
                    got[name], r, rtol=0, atol=MOMENT_TOL * np.abs(r).max(),
                    err_msg=f"{key} {name}")


def test_token_batches_match_repro():
    want = list(jpipeline.token_batches(np.random.default_rng(7), 1000, 3,
                                        5, 4))
    got = list(tpipeline.token_batches(np.random.default_rng(7), 1000, 3,
                                       5, 4))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.keys() == w.keys() == {"tokens", "labels"}
        for k in g:
            assert g[k].dtype == np.int32 and g[k].shape == (3, 5)
            np.testing.assert_array_equal(g[k], w[k])
        np.testing.assert_array_equal(g["tokens"][:, 1:], g["labels"][:, :-1])


def serving_logits(cfg, model, batch):
    return tlm.prefill(cfg, model, batch)[0]


def bf16_case():
    cfg = dataclasses.replace(tconfigs.get_smoke("qwen3-14b"),
                              compute_dtype="bfloat16")
    model = tlm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, model, torch_batch(train_batch(cfg))


def test_train_step_drops_the_stale_bf16_copies():
    """Serving in bf16 caches bf16 copies of the weights (``LM.casts``).
    After a train step, ``prefill`` must equal that of a fresh module
    holding the updated weights, not the copies from before."""
    cfg, model, batch = bf16_case()
    before = serving_logits(cfg, model, batch)          # caches the casts
    step = tlm.make_train_step(cfg, base_lr=1e-2, warmup=1, total_steps=4)
    step(model, toptim.adamw_init(model), batch)
    fresh = tlm.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    fresh.load_state_dict(model.state_dict())
    after = serving_logits(cfg, model, batch)
    assert torch.equal(after, serving_logits(cfg, fresh, batch))
    assert not torch.equal(after, before)


def test_load_state_dict_drops_the_stale_bf16_copies():
    """``load_state_dict`` copies into the parameters in place; serving
    must then read the loaded weights, not the copies of the old ones."""
    cfg, model, batch = bf16_case()
    serving_logits(cfg, model, batch)                   # caches the casts
    other = tlm.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    want = serving_logits(cfg, other, batch)
    model.load_state_dict(other.state_dict())
    assert torch.equal(serving_logits(cfg, model, batch), want)


def test_adamw_keeps_float32_moments_of_bf16_weights():
    """mixtral's smoke config with bfloat16 weights: the moments are
    float32, the weights stay bfloat16 and move."""
    tcfg = dataclasses.replace(tconfigs.get_smoke("mixtral-8x22b"),
                               param_dtype="bfloat16")
    model = tlm.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    w0 = model.blocks[0].ffn.w_in.detach().clone()
    state = toptim.adamw_init(model)
    step = tlm.make_train_step(tcfg, base_lr=1e-2, warmup=1, total_steps=4)
    model, state, m = step(model, state, torch_batch(train_batch(tcfg)))
    assert all(v.dtype == torch.float32 for v in state.m.values())
    assert all(v.dtype == torch.float32 for v in state.v.values())
    assert model.blocks[0].ffn.w_in.dtype == torch.bfloat16
    assert not torch.equal(model.blocks[0].ffn.w_in, w0)
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["gnorm"]))

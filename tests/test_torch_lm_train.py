"""The port's LM training path against ``repro``'s on the CPU: ``loss_fn``
and its gradients for the ten smoke configs, the MoE aux loss, the
padded vocabulary, the vocab-blocked cross entropy, the three remat
policies and one bfloat16 case.

Each case draws ``repro``'s parameters (``init_params`` with a
``PRNGKey``), carries them across with ``params_from_jax`` and feeds both
packages the same numpy batch.  ``repro``'s gradients come from
``jax.value_and_grad``, the port's from autograd into each parameter's
``.grad``; :func:`port_grads` stacks the port's layers into ``repro``'s
layout (layer i is ``blocks[i % period][..][i // period]``) so the two
pytrees compare leaf by leaf.  Losses agree within rtol 1e-5 and each
gradient leaf within 1e-4 of that leaf's largest |g|.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch.data.pipeline import token_batches
from repro_torch.models import lm as tlm
from test_torch_lm import jax_batch, smoke_case, torch_batch

B, S = 2, 16
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4
# Leaves whose gradient is zero in exact arithmetic, so that both packages
# give rounding noise (~1e-11) of no scale of its own: a key bias that no
# RoPE rotates shifts every logit of a query row alike, which the softmax
# cancels; with one expert a token (top_k 1) the renormalized routing
# weight is 1, so the router gets no gradient without the aux loss.  They
# are held below ZERO_TOL of the model's largest |g| instead.
ZERO_TOL = 1e-7


def zero_leaf(cfg, name: str) -> bool:
    leaf = name.rsplit(".", 1)[-1]
    unrotated = (not cfg.rope or ".xattn." in name
                 or name.startswith("enc_blocks"))
    return (leaf == "bk" and unrotated) or (
        leaf == "router" and cfg.top_k == 1 and not cfg.moe_aux_weight)


def train_batch(cfg, seed: int = 0, b: int = B, s: int = S) -> dict:
    """numpy tokens and labels from ``token_batches`` at ``seed`` (int32,
    as ``repro`` takes them), with the frontends' stub inputs where the
    family has them."""
    rng = np.random.default_rng(seed)
    batch = dict(next(token_batches(rng, cfg.vocab, b, s, 1)))
    if cfg.mrope:
        batch["positions"] = np.broadcast_to(
            np.arange(s, dtype=np.int32)[None, None], (3, b, s)).copy()
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.normal(
            size=(b, 4, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["audio_embeds"] = rng.normal(
            size=(b, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return batch


def port_grads(cfg, model) -> dict:
    """The module's ``.grad``s as numpy float32 in ``repro``'s stacked
    pytree layout."""
    return port_tree(cfg, ((n, p.grad) for n, p in model.named_parameters()))


def port_tree(cfg, named) -> dict:
    """(parameter name, tensor) pairs as numpy float32 in ``repro``'s
    stacked pytree layout."""
    period = cfg.scan_period()
    out = {}
    stacked = {}
    for name, t in named:
        g = t.float().numpy()
        key, *rest = name.split(".")
        if key not in ("blocks", "enc_blocks"):
            out[name] = g
            continue
        i = int(rest[0])
        j, grp = (i % period, i // period) if key == "blocks" else (0, i)
        stacked.setdefault((key, j, tuple(rest[1:])), {})[grp] = g
    for (key, j, path), by_group in stacked.items():
        node = out.setdefault(key, {}).setdefault(j, {})
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.stack([by_group[g] for g in sorted(by_group)])
    for key in ("blocks", "enc_blocks"):
        if key in out:
            out[key] = [out[key][j] for j in sorted(out[key])]
    return out


def leaves(tree, prefix=""):
    """(dotted path, leaf) pairs of a nested dict/list pytree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree, np.float32)


def check_grads(cfg, got: dict, want: dict, tol: float = GRAD_TOL):
    got, want = dict(leaves(got)), dict(leaves(want))
    assert got.keys() == want.keys()
    top = max(np.abs(w).max() for w in want.values())
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        if zero_leaf(cfg, name):
            assert np.abs(g).max() < ZERO_TOL * top, name
            assert np.abs(w).max() < ZERO_TOL * top, name
        else:
            assert np.abs(g - w).max() <= tol * np.abs(w).max(), name


@functools.lru_cache(maxsize=None)
def repro_loss_and_grads(arch: str, **overrides):
    """``repro``'s loss and gradients (numpy pytree) on ``train_batch``."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), **overrides)
    params = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    batch = jax_batch(train_batch(jcfg))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(jcfg, p, batch)))(params)
    return float(loss), jax.tree.map(np.asarray, grads)


def repro_blocked_loss(arch: str, n_blocks: int, **overrides) -> float:
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), **overrides)
    params = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    batch = jax_batch(train_batch(jcfg))
    return float(jax.jit(lambda p: jlm.loss_fn_blocked(
        jcfg, p, batch, n_blocks=n_blocks))(params))


def port_loss_and_grads(arch: str, loss=tlm.loss_fn, **overrides):
    """The port's loss (a float) and the module holding its gradients."""
    _, tcfg, _, model = smoke_case(arch, **overrides)
    out = loss(tcfg, model, torch_batch(train_batch(tcfg)))
    out.backward()
    return tcfg, out.item(), model


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_loss_matches_repro(arch):
    want, _ = repro_loss_and_grads(arch)
    _, got, _ = port_loss_and_grads(arch)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert abs(got - np.log(256)) < 0.1     # a 0.02-std init, vocab 256


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_grads_match_repro(arch):
    _, want = repro_loss_and_grads(arch)
    tcfg, _, model = port_loss_and_grads(arch)
    check_grads(tcfg, port_grads(tcfg, model), want)


def test_padded_vocab_masks_the_pad_rows():
    """vocab 250 pads to 256 rows: the six pad logits are -1e30 in both
    packages, so they take no probability and get no gradient."""
    want, want_g = repro_loss_and_grads("qwen3-14b", vocab=250)
    tcfg, got, model = port_loss_and_grads("qwen3-14b", vocab=250)
    assert tcfg.vocab_padded == 256
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    check_grads(tcfg, port_grads(tcfg, model), want_g)
    assert not model.embed.grad[250:].any()


@pytest.mark.parametrize("arch", ["mixtral-8x22b",
                                  "llama4-maverick-400b-a17b"])
def test_moe_aux_loss_matches_repro(arch):
    """``moe_aux_weight > 0`` adds the Switch load-balance term (summed
    over the MoE layers) to the loss, and its gradient reaches the
    router."""
    want, want_g = repro_loss_and_grads(arch, moe_aux_weight=0.01)
    tcfg, got, model = port_loss_and_grads(arch, moe_aux_weight=0.01)
    base, _ = repro_loss_and_grads(arch)
    assert abs(want - base) > 1e-3               # the term is there
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    check_grads(tcfg, port_grads(tcfg, model), want_g)


@pytest.mark.parametrize("n_blocks", [2, 4])
@pytest.mark.parametrize("arch,overrides", [
    ("qwen3-14b", {"vocab": 250}), ("whisper-large-v3", {})],
    ids=["qwen3-vocab250", "whisper"])
def test_blocked_loss_matches_repro_and_loss_fn(arch, overrides, n_blocks):
    """``loss_fn_blocked``: ``repro``'s loss and the port's ``loss_fn``,
    and the gradients of the port's ``loss_fn``.  qwen3's pad rows fall in
    the last chunk."""
    want = repro_blocked_loss(arch, n_blocks, **overrides)
    blocked = functools.partial(tlm.loss_fn_blocked, n_blocks=n_blocks)
    tcfg, got, model = port_loss_and_grads(arch, loss=blocked, **overrides)
    _, plain, ref = port_loss_and_grads(arch, **overrides)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got, plain, rtol=LOSS_RTOL)
    check_grads(tcfg, port_grads(tcfg, model), port_grads(tcfg, ref))


def saved_shapes(fn) -> list:
    """Shapes of the tensors autograd saves for the backward pass while
    ``fn`` runs, outside checkpoint regions: a region's inputs, and what
    ops outside any region save (inside one, the region's own hooks
    nest within these and keep nothing but the inputs)."""
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return shapes


def test_blocked_loss_holds_no_chunk_logits():
    """The backward pass recomputes each chunk's logits: no (B, S, V / n)
    tensor is saved, where ``loss_fn`` saves its (B, S, V) float32
    logits."""
    cfg, _, _, model = smoke_case("qwen3-14b")
    batch = torch_batch(train_batch(cfg))
    vp = cfg.vocab_padded
    plain = saved_shapes(lambda: tlm.loss_fn(cfg, model, batch))
    blocked = saved_shapes(
        lambda: tlm.loss_fn_blocked(cfg, model, batch, n_blocks=2))
    assert (B, S, vp) in plain
    assert not {(B, S, vp), (B, S, vp // 2)} & set(blocked)


def test_full_remat_saves_only_group_inputs():
    """Under remat "full" a layer group keeps its input (B, S, d) and
    recomputes the rest: a few activation-sized tensors outside the
    regions, against dozens a layer with remat off."""
    cfg, _, _, model = smoke_case("qwen3-14b")
    off = dataclasses.replace(cfg, remat=False)
    batch = torch_batch(train_batch(cfg))
    full = saved_shapes(lambda: tlm.loss_fn(cfg, model, batch))
    plain = saved_shapes(lambda: tlm.loss_fn(off, model, batch))
    acts = (B, S, cfg.d_model)
    # one input a group; the final norm and the logits' product save four
    assert full.count(acts) <= cfg.n_layers + 4
    assert plain.count(acts) >= 8 * cfg.n_layers


def test_attention_backward_copies_no_logits():
    """Under autograd the attention logits are scaled and masked out of
    place: in place, on the einsum's output view, the backward pass
    copied the (B, H, S, S) logits three times a layer."""
    from torch.utils._python_dispatch import TorchDispatchMode

    cfg, _, _, model = smoke_case("qwen3-14b", remat=False)
    s = 2 * cfg.head_dim                     # logits outsize q, k and v
    logits_shape = (B, cfg.n_heads, s, s)
    copies = []

    class Copies(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.copy_.default,
                        torch.ops.aten.clone.default):
                copies.append(tuple(args[0].shape))
            return func(*args, **(kwargs or {}))

    loss = tlm.loss_fn(cfg, model, torch_batch(train_batch(cfg, s=s)))
    with Copies():
        loss.backward()
    assert all(np.prod(c) < np.prod(logits_shape) for c in copies), copies


@pytest.mark.parametrize("arch", ["qwen3-14b", "mixtral-8x22b",
                                  "mamba2-370m", "whisper-large-v3",
                                  "jamba-v0.1-52b"])
def test_remat_policies_agree(arch):
    """Remat "full", "dots" and off: the same loss and gradients within
    1e-6 relative (recomputation repeats the same operations)."""
    runs = {}
    for policy, over in (("off", {"remat": False}), ("full", {}),
                         ("dots", {"remat_policy": "dots"})):
        cfg, loss, model = port_loss_and_grads(arch, **over)
        runs[policy] = (loss, port_grads(cfg, model))
    loss, grads = runs["off"]
    for policy in ("full", "dots"):
        np.testing.assert_allclose(runs[policy][0], loss, rtol=1e-6)
        for (name, g), (_, w) in zip(leaves(runs[policy][1]),
                                     leaves(grads)):
            np.testing.assert_allclose(g, w, rtol=1e-6,
                                       atol=1e-6 * np.abs(w).max(),
                                       err_msg=f"{policy} {name}")


def test_dots_policy_keeps_unbatched_products_only():
    """The ops that reach the "dots" policy in a training step: the
    projections' ``aten.mm`` are kept, attention's and the experts'
    batched ``aten.bmm`` are recomputed (``repro``'s
    ``dots_with_no_batch_dims_saveable``)."""
    cfg, _, _, model = smoke_case("mixtral-8x22b", remat_policy="dots")
    seen = {}
    real = tlm._dots_policy

    def spy(ctx, op, *args, **kwargs):
        verdict = real(ctx, op, *args, **kwargs)
        seen.setdefault(str(op), set()).add(verdict)
        return verdict
    tlm._dots_policy = spy
    try:
        tlm.loss_fn(cfg, model, torch_batch(train_batch(cfg))).backward()
    finally:
        tlm._dots_policy = real
    save = torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
    kept = {op for op, v in seen.items() if save in v}
    assert kept == {"aten.mm.default"}
    assert "aten.bmm.default" in seen          # attention, experts


def test_bf16_compute_matches_repro():
    """qwen3's smoke config computing in bfloat16 (float32 weights, cast
    at use).  Tolerances from bfloat16's unit roundoff 2^-8 = 3.9e-3:
    the two packages round at different points (``repro`` casts the
    table before the gather, its XLA products may round partial sums),
    and a gradient passes forward and back through two layers of
    products each rounded to bfloat16, a few roundoffs in all, so each
    leaf within 5e-2 of its largest |g| (a wrong or missing term moves a
    leaf by O(1) of it).  The loss is a float32 mean over float32 logits
    whose bf16 error is ~4e-3 of |logit| ~0.2: rtol 1e-3."""
    over = {"compute_dtype": "bfloat16"}
    want, want_g = repro_loss_and_grads("qwen3-14b", **over)
    tcfg, got, model = port_loss_and_grads("qwen3-14b", **over)
    np.testing.assert_allclose(got, want, rtol=1e-3)
    check_grads(tcfg, port_grads(tcfg, model), want_g, tol=5e-2)


def test_serving_forward_stays_out_of_autograd():
    """``forward_train`` (``forward_hidden`` under ``torch.no_grad``)
    builds no graph; ``forward_hidden`` does, and equals it in float32."""
    cfg, _, _, model = smoke_case("qwen3-14b")
    batch = torch_batch(train_batch(cfg))
    served = tlm.forward_train(cfg, model, batch)
    assert not served.requires_grad
    hidden, _ = tlm.forward_hidden(cfg, model, batch)
    assert hidden.requires_grad
    logits = hidden @ model.embed.T
    np.testing.assert_allclose(logits.detach().numpy(), served.numpy(),
                               rtol=0, atol=1e-6 * served.abs().max().item())

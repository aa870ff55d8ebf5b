"""The port's LM substrate against ``repro``'s on the CPU: the dense, VLM
and encoder-decoder smoke configs end to end, the attention and RoPE
layers, ``onehot_matmul``, the configs and the parameter counts.

Each smoke case draws ``repro``'s parameters (``init_params`` with a
``PRNGKey``), carries them across with ``params_from_jax`` and feeds both
packages the same numpy batch.  ``forward_train``, ``prefill`` and 8
greedy ``decode_step``s must agree within 1e-4 of the largest |logit|.
Both decode the same tokens (``repro``'s argmax), and the port's argmax
must equal ``repro``'s wherever ``repro``'s top two logits lie more than
1e-3 of that apart.  The port's decode logits must also match its own
forward pass at the same positions within 5e-3 (``repro``'s bound in
``tests/test_models_smoke.py``).  The MoE and SSM configs run the same
checks in ``test_torch_lm_moe_ssm.py``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.models import layers as jL
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch.kernels import ops as tops
from repro_torch.launch.serve import lm_batch
from repro_torch.models import layers as tL
from repro_torch.models import lm as tlm

B, S, STEPS = 2, 16, 8
PARITY, GAP, SELF = 1e-4, 1e-3, 5e-3
# computing in bfloat16, ``repro``'s own decode drifts from its forward
# pass beyond SELF where the two take different algorithms (Mamba-2's
# recurrence against its chunked scan); the port's drift is held to
# this factor of ``repro``'s
OWN_DRIFT = 1.5
DENSE_ARCHS = ["qwen3-14b", "minicpm-2b", "command-r-35b", "deepseek-67b",
               "qwen2-vl-72b", "whisper-large-v3"]


def prompt_len(cfg) -> int:
    """Past the sliding window where there is one, so the ring cache rolls
    at prefill and wraps while decoding."""
    return cfg.sliding_window + 8 if cfg.sliding_window else S


def make_batch(cfg, s: int) -> dict:
    """The serve driver's random prompts (seed 0) as numpy, integers in
    int32 as ``repro`` takes them."""
    batch = {}
    for k, v in lm_batch(cfg, B, s, 0, "cpu").items():
        v = np.ascontiguousarray(v.numpy())
        batch[k] = v.astype(np.int32) if v.dtype == np.int64 else v
    return batch


def mrope_positions(s: int):
    return np.broadcast_to(np.arange(s, dtype=np.int32)[None, None],
                           (3, B, s)).copy()


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch):
    return {k: (torch.from_numpy(v).long() if v.dtype == np.int32
                else torch.from_numpy(v)) for k, v in batch.items()}


def extended(cfg, batch, tokens):
    """``batch`` with ``tokens`` (B, n) appended to its prompt."""
    full = dict(batch)
    full["tokens"] = np.concatenate([batch["tokens"], tokens], axis=1)
    if cfg.mrope:
        full["positions"] = mrope_positions(full["tokens"].shape[1])
    return full


def run_repro(cfg, params, batch, steps: int):
    """repro's greedy decode: (prefill logits, [decode logits], tokens
    (B, steps) fed to the decode steps, forward logits over prompt +
    tokens)."""
    s = batch["tokens"].shape[1]
    logits, cache = jlm.prefill(cfg, params, jax_batch(batch),
                                cache_dtype=jnp.float32, max_len=s + steps)
    pre = np.asarray(logits)
    dec = jax.jit(functools.partial(jlm.decode_step, cfg))
    outs, toks = [], []
    logits = pre
    for i in range(steps):
        tok = np.argmax(logits, -1).astype(np.int32)[:, None]
        toks.append(tok)
        logits, cache = dec(params, cache, jnp.asarray(tok),
                            jnp.asarray(s + i, jnp.int32))
        logits = np.asarray(logits)
        outs.append(logits)
    tokens = np.concatenate(toks, axis=1)
    fwd = jlm.forward_train(cfg, params, jax_batch(extended(cfg, batch,
                                                            tokens)))
    return pre, outs, tokens, np.asarray(fwd.astype(jnp.float32))


def run_port(cfg, model, batch, tokens):
    """The port on the same batch, decoding ``tokens``: (prefill logits,
    [decode logits], forward logits over prompt + tokens)."""
    s = batch["tokens"].shape[1]
    steps = tokens.shape[1]
    logits, cache = tlm.prefill(cfg, model, torch_batch(batch),
                                cache_dtype=torch.float32, max_len=s + steps)
    pre = logits.numpy()
    outs = []
    for i in range(steps):
        tok = torch.from_numpy(tokens[:, i:i + 1]).long()
        logits, cache = tlm.decode_step(cfg, model, cache, tok, s + i)
        outs.append(logits.numpy())
    full = torch_batch(extended(cfg, batch, tokens))
    return pre, outs, tlm.forward_train(cfg, model, full).float().numpy()


def rel_err(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def check_argmax(got, want):
    """``got``'s argmax equals ``want``'s in every row where ``want``'s top
    two logits lie more than GAP of its largest |logit| apart."""
    top2 = np.sort(want, -1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > GAP * np.abs(want).max()
    assert clear.any()
    np.testing.assert_array_equal(got.argmax(-1)[clear],
                                  want.argmax(-1)[clear])


def smoke_case(arch: str, seed: int = 0, **overrides):
    """(repro's config, the port's, repro's params, the port's LM)."""
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), **overrides)
    tcfg = dataclasses.replace(tconfigs.get_smoke(arch), **overrides)
    params = jlm.init_params(jcfg, jax.random.PRNGKey(seed))
    model = tlm.params_from_jax(tcfg, jax.tree.map(np.asarray, params),
                                "cpu")
    return jcfg, tcfg, params, model


def check_smoke(arch: str, tol: float = PARITY, **overrides):
    jcfg, tcfg, params, model = smoke_case(arch, **overrides)
    s = prompt_len(jcfg)
    batch = make_batch(jcfg, s)
    pre, outs, tokens, fwd = run_repro(jcfg, params, batch, STEPS)
    t_pre, t_outs, t_fwd = run_port(tcfg, model, batch, tokens)
    assert t_fwd.shape == (B, s + STEPS, jcfg.vocab_padded)
    assert t_pre.shape == (B, jcfg.vocab_padded)
    assert rel_err(t_fwd, fwd) < tol
    assert rel_err(t_pre, pre) < tol
    check_argmax(t_pre, pre)
    for want, got in zip(outs, t_outs):
        assert rel_err(got, want) < tol
        check_argmax(got, want)
    # the port's decode against its own forward pass: within SELF, or
    # OWN_DRIFT times repro's own drift where that is larger
    for i, (want, got) in enumerate(zip(outs, t_outs)):
        own = rel_err(want, fwd[:, s + i])
        assert rel_err(got, t_fwd[:, s + i]) < max(SELF, OWN_DRIFT * own), i


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_smoke_config_matches_repro(arch):
    check_smoke(arch)


def test_bf16_compute_matches_repro():
    """qwen3's smoke config computing in bfloat16 (float32 weights, cast
    at use in ``repro``, once in the port: the same bits)."""
    check_smoke("qwen3-14b", tol=2e-2, compute_dtype="bfloat16")


def test_bf16_compute_minicpm_matches_repro():
    """minicpm's smoke config computing in bfloat16, as configured."""
    check_smoke("minicpm-2b", tol=2e-2, compute_dtype="bfloat16")


def bf16_drift(arch: str) -> dict:
    """For ``arch``'s smoke config computing in bfloat16: the port against
    ``repro`` (largest error of forward, prefill and decode over the
    largest |logit|) and each package's decode against its own forward
    pass (largest over the steps)."""
    jcfg, tcfg, params, model = smoke_case(arch, compute_dtype="bfloat16")
    s = prompt_len(jcfg)
    batch = make_batch(jcfg, s)
    pre, outs, tokens, fwd = run_repro(jcfg, params, batch, STEPS)
    t_pre, t_outs, t_fwd = run_port(tcfg, model, batch, tokens)
    return {
        "port_vs_repro": max([rel_err(t_fwd, fwd), rel_err(t_pre, pre)]
                             + [rel_err(g, w) for w, g in zip(outs, t_outs)]),
        "repro_decode_vs_forward": max(rel_err(o, fwd[:, s + i])
                                       for i, o in enumerate(outs)),
        "port_decode_vs_forward": max(rel_err(o, t_fwd[:, s + i])
                                      for i, o in enumerate(t_outs))}


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "mixtral-8x22b"])
def test_decode_position_stays_on_the_device(arch):
    """A 0-d position tensor filled in place before each step, as a
    replayed graph sees it, decodes the same bits as Python ints
    (qwen2-vl's M-RoPE; mixtral's ring cache wraps past its window)."""
    cfg = tconfigs.get_smoke(arch)
    model = tlm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    s = prompt_len(cfg)
    batch = lm_batch(cfg, B, s, 0, "cpu")
    runs = []
    for on_device in (False, True):
        logits, cache = tlm.prefill(cfg, model, batch, max_len=s + STEPS,
                                    cache_dtype=torch.float32)
        pos = torch.zeros((), dtype=torch.long)
        outs = []
        for i in range(STEPS):
            pos.fill_(s + i)
            logits, cache = tlm.decode_step(
                cfg, model, cache, logits.argmax(-1)[:, None],
                pos if on_device else s + i)
            outs.append(logits)
        runs.append(torch.stack(outs))
    assert torch.equal(runs[0], runs[1])


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a card, building weights or caches without naming a device
    raises rather than running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.get_smoke("qwen3-14b")
    tree = jax.tree.map(np.asarray, jlm.init_params(
        jconfigs.get_smoke("qwen3-14b"), jax.random.PRNGKey(0)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlm.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlm.params_from_jax(cfg, tree)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlm.init_cache(cfg, B, S)
    assert tlm.params_from_jax(cfg, tree, "cpu").embed.device.type == "cpu"


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_param_counts_match_repro(arch):
    jcfg, tcfg = jconfigs.get_arch(arch), tconfigs.get_arch(arch)
    assert tlm.param_count(tcfg) == jlm.param_count(jcfg)
    assert tlm.active_param_count(tcfg) == jlm.active_param_count(jcfg)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_configs_are_repro_s(arch):
    """The port's copy of the registry: every field of every config."""
    for getter in ("get_arch", "get_smoke"):
        j = getattr(jconfigs, getter)(arch)
        t = getattr(tconfigs, getter)(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.layer_kinds() == j.layer_kinds()
        assert t.scan_period() == j.scan_period()
        assert (t.vocab_padded, t.d_inner, t.ssm_heads) == (
            j.vocab_padded, j.d_inner, j.ssm_heads)


def test_registry_is_repro_s():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    assert tconfigs.all_cells() == jconfigs.all_cells()
    with pytest.raises(KeyError):
        tconfigs.get_arch("gpt-2")


def test_init_params_on_meta_then_device():
    cfg = tconfigs.get_smoke("qwen3-14b")
    gen = torch.Generator().manual_seed(0)
    a = tlm.init_params(cfg, gen, "cpu")
    b = tlm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))
    assert sum(p.numel() for p in a.parameters()) == tlm.param_count(cfg)
    assert float(a.embed.detach().std()) == pytest.approx(0.02, rel=0.1)
    assert torch.equal(a.final_norm, torch.ones(cfg.d_model))


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------
def qkv(seed: int, sq=24, sk=24, h=4, kv=2, d=16):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((B, sq, h, d), (B, sk, kv, d), (B, sk, kv, d))]


@pytest.mark.parametrize("causal,window", [(True, None), (True, 8),
                                           (False, None)])
def test_sdpa_matches_repro(causal, window):
    q, k, v = qkv(1)
    want = jL.sdpa(*map(jnp.asarray, (q, k, v)), causal=causal,
                   sliding_window=window)
    got = tL.sdpa(*map(torch.from_numpy, (q, k, v)), causal=causal,
                  sliding_window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("chunk", [8, 10])
def test_sdpa_chunked_matches_repro(chunk):
    """Chunks of 10 pad 24 keys to 30: the pad and the sliding window
    mask whole chunks for the early queries."""
    q, k, v = qkv(2)
    want = jL.sdpa_chunked(*map(jnp.asarray, (q, k, v)), causal=True,
                           sliding_window=6, kv_chunk=chunk)
    got = tL.sdpa_chunked(*map(torch.from_numpy, (q, k, v)), causal=True,
                          sliding_window=6, kv_chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    full = tL.sdpa(*map(torch.from_numpy, (q, k, v)), causal=True,
                   sliding_window=6)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_sdpa_kv_valid_matches_repro():
    q, k, v = qkv(3, sq=1, sk=12)
    valid = np.arange(12) < 7
    want = jL.sdpa(*map(jnp.asarray, (q, k, v)), causal=False,
                   kv_valid=jnp.asarray(valid))
    got = tL.sdpa(*map(torch.from_numpy, (q, k, v)), causal=False,
                  kv_valid=torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_repeat_kv_head_order():
    """Query head h reads kv head h // n_rep."""
    x = torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(1, 2, 3, 4)
    want = np.asarray(jL._repeat_kv(jnp.asarray(x.numpy()), 2))
    np.testing.assert_array_equal(tL._repeat_kv(x, 2).numpy(), want)


def test_rope_and_mrope_match_repro():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, 10, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 5000, (B, 10))
    jcs = jL.rope_cos_sin(jnp.asarray(pos), 16, 1e6)
    tcs = tL.rope_cos_sin(torch.from_numpy(pos), 16, 1e6)
    for a, b in zip(tcs, jcs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-6)
    np.testing.assert_allclose(
        tL.apply_rope(torch.from_numpy(x), *tcs).numpy(),
        np.asarray(jL.apply_rope(jnp.asarray(x), *jcs)), atol=1e-5)
    pos3 = rng.integers(0, 64, (3, B, 10))
    cfg = tconfigs.get_smoke("qwen2-vl-72b")
    sections = tlm.mrope_sections(cfg)
    assert sections == jlm.mrope_sections(jconfigs.get_smoke("qwen2-vl-72b"))
    assert tlm.mrope_sections(tconfigs.get_arch("qwen2-vl-72b")) == (
        16, 24, 24)
    jm = jL.mrope_cos_sin(jnp.asarray(pos3), sections, 16, 1e4)
    tm = tL.mrope_cos_sin(torch.from_numpy(pos3), sections, 16, 1e4)
    for a, b in zip(tm, jm):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    np.testing.assert_allclose(
        tL.apply_rope(torch.from_numpy(x), *tm).numpy(),
        np.asarray(jL.apply_rope(jnp.asarray(x), *jm)), atol=1e-5)


def test_sinusoidal_positions_match_repro():
    np.testing.assert_allclose(tL.sinusoidal_positions(12, 64).numpy(),
                               np.asarray(jL.sinusoidal_positions(12, 64)),
                               atol=1e-6)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_matches_repro(act):
    rng = np.random.default_rng(5)
    p = {k: rng.normal(size=s).astype(np.float32) * 0.1
         for k, s in (("w_in", (32, 48)), ("w_out", (48, 32)),
                      ("w_gate", (32, 48)))}
    if act == "gelu":
        del p["w_gate"]
    x = rng.normal(size=(B, 5, 32)).astype(np.float32)
    want = jL.mlp({k: jnp.asarray(v) for k, v in p.items()},
                  jnp.asarray(x), act=act)
    got = tL.mlp({k: torch.from_numpy(v) for k, v in p.items()},
                 torch.from_numpy(x), act=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("shape", [(40,), (40, 3, 2)])
def test_onehot_matmul_matches_repro(shape):
    rng = np.random.default_rng(6)
    idx = rng.integers(0, 7, 40).astype(np.int32)
    values = rng.normal(size=shape).astype(np.float32)
    want = jops.onehot_matmul(jnp.asarray(idx), jnp.asarray(values), 7)
    got = tops.onehot_matmul(torch.from_numpy(idx), torch.from_numpy(values),
                             7)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


if __name__ == "__main__":
    # PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/test_torch_lm.py
    # prints the bfloat16 drift of the smoke configs (PERF.md)
    import json

    for arch in ("qwen3-14b", "minicpm-2b", "mixtral-8x22b", "mamba2-370m"):
        print(arch, json.dumps(bf16_drift(arch)))

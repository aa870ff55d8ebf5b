"""whisper-large-v3 — enc-dec audio transformer backbone.

[arXiv:2212.04356; unverified]  32L d_model=1280 20H (kv=20) d_ff=5120
vocab=51866.  Conv/mel frontend is a STUB: input_specs() supplies 1500
precomputed frame embeddings (B, 1500, d_model).  Full attention (enc
non-causal, dec causal + cross) -> long_500k skipped.
"""
from repro_torch.configs.registry import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3", family="encdec",
    n_layers=32, encoder_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab=51866, head_dim=64,
    act="gelu", rope=False, attn_bias=True,
    frontend="audio", frontend_len=1500,
    sub_quadratic=False,
    source="arXiv:2212.04356 (Whisper); head_dim=1280/20=64; GELU MLP; "
           "sinusoidal positions stand in for Whisper's learned embeddings",
)

SMOKE = ArchConfig(
    name="whisper-large-v3-smoke", family="encdec",
    n_layers=2, encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, head_dim=16,
    act="gelu", rope=False, attn_bias=True,
    frontend="audio", frontend_len=12,
    param_dtype="float32", compute_dtype="float32",
)

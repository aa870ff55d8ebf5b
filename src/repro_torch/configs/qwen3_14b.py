"""qwen3-14b — dense GQA with qk-norm.

[hf:Qwen/Qwen3-14B; hf]  40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936; per-head RMSNorm on q and k (qk_norm), no attn bias.
Full attention -> long_500k skipped.
"""
from repro_torch.configs.registry import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=17408,
    vocab=151936, head_dim=128,
    qk_norm=True, rope_theta=1e6,
    source="hf:Qwen/Qwen3-14B; qk_norm per-head RMSNorm",
)

SMOKE = ArchConfig(
    name="qwen3-14b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    head_dim=16, qk_norm=True,
    param_dtype="float32", compute_dtype="float32",
)

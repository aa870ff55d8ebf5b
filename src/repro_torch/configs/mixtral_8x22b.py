"""mixtral-8x22b — sparse MoE with sliding-window attention.

[arXiv:2401.04088; hf]  56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, 8 experts top-2, SWA (window 4096 per assignment note).
SWA is sub-quadratic -> long_500k RUNS (KV cache bounded by the window).
"""
from repro_torch.configs.registry import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab=32768, head_dim=128,
    sliding_window=4096, rope_theta=1e6,
    n_experts=8, top_k=2,
    param_dtype="bfloat16", fsdp=True,
    sub_quadratic=True,
    source="arXiv:2401.04088; 8 experts/layer top-2; SWA per assignment",
)

SMOKE = ArchConfig(
    name="mixtral-8x22b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    head_dim=16, sliding_window=32, n_experts=4, top_k=2,
    moe_capacity_factor=8.0,
    param_dtype="float32", compute_dtype="float32", sub_quadratic=True,
)

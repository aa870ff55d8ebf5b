"""llama4-maverick-400b-a17b — 128-expert top-1 MoE with early fusion.

[hf:meta-llama/Llama-4-*; unverified]  48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048; MoE 128e top-1 on alternating layers (interleave=2,
matching the a17b active-parameter budget) + shared expert; early-fusion
multimodality is a token-stub.  Full attention in the assigned config ->
long_500k skipped.
"""
from repro_torch.configs.registry import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
    vocab=202048, head_dim=128, rope_theta=5e5,
    n_experts=128, top_k=1, moe_every=2, moe_offset=1, shared_expert=True,
    param_dtype="bfloat16", fsdp=True,
    source="hf Llama-4 family; MoE every other layer + shared expert "
           "(a17b active budget); qk_norm off per Maverick",
)

SMOKE = ArchConfig(
    name="llama4-maverick-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    head_dim=16, n_experts=4, top_k=1, moe_every=2, moe_offset=1,
    moe_capacity_factor=8.0,
    shared_expert=True, param_dtype="float32", compute_dtype="float32",
)

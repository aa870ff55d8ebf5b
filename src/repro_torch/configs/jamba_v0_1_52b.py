"""jamba-v0.1-52b — hybrid Mamba+attention (1:7) with 16-expert MoE.

[arXiv:2403.19887; hf]  32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536; attention at layer i%8==4 (1 attn : 7 mamba), MoE 16e top-2
every other layer; mamba d_state=16, expand=2.  Hybrid/SSM -> long_500k
RUNS (4 full-attention layers hold the 524k KV; mamba layers are O(1)).
"""
from repro_torch.configs.registry import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=65536, head_dim=128,
    rope=False,  # Jamba uses no positional encoding (mamba provides order)
    n_experts=16, top_k=2, moe_every=2, moe_offset=1,
    ssm_state=16, ssm_expand=2, ssm_head_dim=64, ssm_conv=4,
    attn_period=8, attn_period_offset=4,
    param_dtype="bfloat16", fsdp=True,
    sub_quadratic=True,
    source="arXiv:2403.19887 (Jamba); mamba-1 mixer approximated by the "
           "shared mamba-2 SSD mixer (noted in DESIGN.md)",
)

SMOKE = ArchConfig(
    name="jamba-v0.1-smoke", family="hybrid",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    head_dim=16, rope=False, n_experts=4, top_k=2, moe_every=2, moe_offset=1,
    moe_capacity_factor=8.0,
    ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_conv=4, ssm_chunk=8,
    attn_period=8, attn_period_offset=4,
    param_dtype="float32", compute_dtype="float32", sub_quadratic=True,
)

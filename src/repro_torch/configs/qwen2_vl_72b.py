"""qwen2-vl-72b — dense VLM backbone with M-RoPE.

[arXiv:2409.12191; hf]  80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064.  Vision frontend is a STUB: input_specs() supplies
precomputed patch embeddings merged into the token stream; M-RoPE uses
3-section (temporal, h, w) position ids.  Full attention -> long_500k skip.
"""
from repro_torch.configs.registry import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=29568,
    vocab=152064, head_dim=128,
    mrope=True, rope_theta=1e6, attn_bias=True,
    param_dtype="bfloat16", fsdp=True,
    source="hf:Qwen/Qwen2-VL-72B-Instruct; qkv bias per Qwen2; "
           "M-RoPE sections (16,24,24) over head_dim/2=64",
)

SMOKE = ArchConfig(
    name="qwen2-vl-72b-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    head_dim=16, mrope=True, attn_bias=True,
    param_dtype="float32", compute_dtype="float32",
)

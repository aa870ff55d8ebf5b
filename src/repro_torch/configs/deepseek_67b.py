"""deepseek-67b — deep dense llama-arch (95 layers).

[arXiv:2401.02954; hf]  95L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=102400; head_dim=128.  Full attention -> long_500k skipped.
"""
from repro_torch.configs.registry import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22016,
    vocab=102400, head_dim=128,
    param_dtype="bfloat16", fsdp=True,
    source="arXiv:2401.02954 (DeepSeek LLM 67B); llama arch, deepest cell",
)

SMOKE = ArchConfig(
    name="deepseek-67b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    head_dim=16, param_dtype="float32", compute_dtype="float32",
)

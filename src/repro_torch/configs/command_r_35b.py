"""command-r-35b — dense GQA, no biases, 256k vocab.

[hf:CohereForAI/c4ai-command-r-v01; unverified]  40L d_model=8192 64H
(GQA kv=8) d_ff=22528 vocab=256000; head_dim=128, no attention/MLP bias.
Full attention -> long_500k skipped.
"""
from repro_torch.configs.registry import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b", family="dense",
    n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22528,
    vocab=256000, head_dim=128,
    rope_theta=8e6, attn_bias=False,
    param_dtype="bfloat16", fsdp=True,
    source="hf:CohereForAI/c4ai-command-r-v01; sequential-block variant "
           "of Cohere's parallel block (noted in DESIGN.md)",
)

SMOKE = ArchConfig(
    name="command-r-35b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
    head_dim=16, param_dtype="float32", compute_dtype="float32",
)

"""minicpm-2b — dense llama-like with the WSD LR schedule.

[arXiv:2404.06395; hf]  40L d_model=2304 36H (kv=36: MHA) d_ff=5760
vocab=122753; head_dim=64.  WSD (warmup-stable-decay) schedule is a
trainer feature (``repro_torch.models.optim.wsd_schedule``).  Full
attention -> long_500k skipped.
"""
from repro_torch.configs.registry import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36, d_ff=5760,
    vocab=122753, head_dim=64,
    lr_schedule="wsd",
    source="arXiv:2404.06395 (MiniCPM); llama-like, MHA (kv=36)",
)

SMOKE = ArchConfig(
    name="minicpm-2b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
    head_dim=16, lr_schedule="wsd",
    param_dtype="float32", compute_dtype="float32",
)

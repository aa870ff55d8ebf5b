"""mamba2-370m — attention-free SSM (SSD / state-space duality).

[arXiv:2405.21060; unverified]  48L d_model=1024 d_ff=0 vocab=50280
ssm_state=128; expand=2 -> d_inner=2048, 32 heads of head_dim 64.
O(S) scan -> long_500k RUNS (decode state is O(1) per token).
"""
from repro_torch.configs.registry import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=50280, head_dim=0,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_conv=4,
    sub_quadratic=True,
    source="arXiv:2405.21060 (Mamba-2); mixer-only blocks (d_ff=0)",
)

SMOKE = ArchConfig(
    name="mamba2-370m-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=0, n_kv_heads=0, d_ff=0, vocab=256,
    head_dim=0, ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_conv=4,
    ssm_chunk=8, param_dtype="float32", compute_dtype="float32",
    sub_quadratic=True,
)

"""Architecture registry: assigned configs, smoke variants, input shapes.

Every architecture from the assignment is a first-class ``--arch <id>``
config.  ``get_smoke()`` returns a reduced same-family variant for CPU
tests.  A copy of ``repro.configs.registry``: the same fields, defaults and
rules, so a config means the same model in both packages.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    # attention flavor
    qk_norm: bool = False
    attn_bias: bool = False
    sliding_window: Optional[int] = None
    rope: bool = True
    rope_theta: float = 1e4
    mrope: bool = False
    attn_chunk: int = 0          # >0: flash-style chunked attention
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1           # MoE where i % moe_every == moe_offset
    moe_offset: int = 0
    moe_d_ff: int = 0            # 0 -> d_ff
    shared_expert: bool = False
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.0  # >0: Switch-style load-balance aux loss
    moe_ff_fsdp: bool = False    # TP-MoE: shard expert ff over data x model
                                 # (keeps the contracted d dim unsharded)
    # SSM / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    attn_period: int = 0         # hybrid: attention where i % period == offset
    attn_period_offset: int = 0
    # enc-dec / multimodal frontends (stubs provide embeddings)
    encoder_layers: int = 0
    frontend: Optional[str] = None   # "audio" | "vision"
    frontend_len: int = 0
    # numerics / distribution
    act: str = "silu"
    norm_eps: float = 1e-6
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    fsdp: bool = False           # shard params over data axes too (ZeRO-3)
    remat: bool = True
    remat_policy: str = "full"   # full | dots (save matmul outputs: fewer
                                 # bwd FSDP re-gathers, more activation HBM)
    scan_unroll: bool = False    # unroll layer groups (dry-run cost truth:
                                 # XLA cost_analysis counts while bodies once)
    lr_schedule: str = "cosine"  # minicpm: "wsd"
    sub_quadratic: bool = False  # long_500k eligibility
    source: str = ""

    @property
    def vocab_padded(self) -> int:
        """Embedding-table rows padded to 256 so the vocab dim divides any
        production mesh axis (MaxText-style); logits beyond ``vocab`` are
        masked to -inf in the loss."""
        return -(-self.vocab // 256) * 256

    @property
    def d_inner(self) -> int:    # mamba inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def layer_kinds(self) -> List[Tuple[str, str]]:
        """Per-layer (mixer, ffn) kinds for the decoder stack."""
        kinds = []
        for i in range(self.n_layers):
            if self.family == "ssm":
                mixer = "mamba"
            elif self.attn_period:
                mixer = ("attn" if i % self.attn_period
                         == self.attn_period_offset else "mamba")
            else:
                mixer = "attn"
            if self.family == "ssm":
                ffn = "none"     # mamba2 stacks are mixer-only
            elif self.n_experts and i % self.moe_every == self.moe_offset:
                ffn = "moe"
            else:
                ffn = "mlp"
            kinds.append((mixer, ffn))
        return kinds

    def scan_period(self) -> int:
        """Smallest repeating pattern period (for scan-over-layers)."""
        kinds = self.layer_kinds()
        for p in range(1, len(kinds) + 1):
            if len(kinds) % p == 0 and all(
                    kinds[i] == kinds[i % p] for i in range(len(kinds))):
                return p
        return len(kinds)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

_ARCH_MODULES = {
    "whisper-large-v3": "whisper_large_v3",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "mamba2-370m": "mamba2_370m",
    "mixtral-8x22b": "mixtral_8x22b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "minicpm-2b": "minicpm_2b",
    "qwen3-14b": "qwen3_14b",
    "command-r-35b": "command_r_35b",
    "deepseek-67b": "deepseek_67b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
}

ARCH_IDS = list(_ARCH_MODULES)


def get_arch(arch_id: str) -> ArchConfig:
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; available: {ARCH_IDS}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")
    return mod.CONFIG


def get_smoke(arch_id: str) -> ArchConfig:
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")
    return mod.SMOKE


def cell_is_runnable(cfg: ArchConfig, shape: ShapeConfig
                     ) -> Tuple[bool, str]:
    """Dry-run cell applicability (skips recorded in EXPERIMENTS.md)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full O(S²) attention at 524k context — skipped per "
                       "assignment (run only for SSM/hybrid/linear-attn)")
    return True, ""


def all_cells():
    """The 40 assigned (arch x shape) cells, with runnability flags."""
    out = []
    for aid in ARCH_IDS:
        cfg = get_arch(aid)
        for shape in SHAPES.values():
            ok, why = cell_is_runnable(cfg, shape)
            out.append((aid, shape.name, ok, why))
    return out

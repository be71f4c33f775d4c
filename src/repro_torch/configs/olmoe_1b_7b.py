"""olmoe-1b-7b — MoE, 64 experts top-8.

[arXiv:2409.02060] 16L d_model=2048 16H (GQA kv=16) d_ff=1024 (per expert)
vocab=50304, MoE 64e top-8, SwiGLU.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,
    vocab_size=50_304,
    activation="swiglu",
    moe=MoEConfig(num_experts=64, num_experts_per_tok=8),
    source="arXiv:2409.02060",
)


def smoke_config() -> ArchConfig:
    return CONFIG.replace(
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=4, d_ff=64,
        vocab_size=512, moe=MoEConfig(num_experts=4, num_experts_per_tok=2))

"""granite-moe-1b-a400m — MoE, 32 experts top-8.

[hf:ibm-granite/granite-3.0-1b-a400m-base] 24L d_model=1024 16H (GQA kv=8)
d_ff=512 (per expert) vocab=49155, MoE 32e top-8, SwiGLU.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49_155,
    activation="swiglu",
    moe=MoEConfig(num_experts=32, num_experts_per_tok=8),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)


def smoke_config() -> ArchConfig:
    return CONFIG.replace(
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, d_ff=64,
        vocab_size=512, moe=MoEConfig(num_experts=4, num_experts_per_tok=2))

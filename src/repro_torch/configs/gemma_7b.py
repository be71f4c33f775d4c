"""gemma-7b — dense decoder with GeGLU and head_dim=256.

[arXiv:2403.08295] 28L d_model=3072 16H (GQA kv=16) d_ff=24576
vocab=256000, GeGLU, head_dim=256 (the 2b sibling uses MQA).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    d_ff=24_576,
    vocab_size=256_000,
    head_dim=256,
    activation="geglu",
    source="arXiv:2403.08295",
)


def smoke_config() -> ArchConfig:
    return CONFIG.replace(num_layers=2, d_model=128, num_heads=2,
                          num_kv_heads=2, head_dim=64, d_ff=256,
                          vocab_size=512)

"""recurrentgemma-2b — hybrid RG-LRU + local attention, 1 attn : 2 recurrent.

[arXiv:2402.19427] 26L d_model=2560 10H (GQA kv=1 / MQA) d_ff=7680
vocab=256000, head_dim=256, GeGLU, local attention window 2048.
"""
from repro_torch.configs.base import ArchConfig, RGLRUConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    d_ff=7680,
    vocab_size=256_000,
    head_dim=256,
    activation="geglu",
    norm="rmsnorm",
    rglru=RGLRUConfig(lru_width=2560, conv_width=4,
                      pattern=("recurrent", "recurrent", "attention"),
                      attention_window=2048),
    source="arXiv:2402.19427",
)


def smoke_config() -> ArchConfig:
    return CONFIG.replace(
        num_layers=3, d_model=128, num_heads=2, num_kv_heads=1, head_dim=64,
        d_ff=256, vocab_size=512,
        rglru=RGLRUConfig(lru_width=128, conv_width=4,
                          pattern=("recurrent", "recurrent", "attention"),
                          attention_window=32))

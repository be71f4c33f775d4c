"""stablelm-1.6b — dense decoder.

[hf:stabilityai/stablelm-2-1_6b] 24L d_model=2048 32H (GQA kv=32)
d_ff=5632 vocab=100352, SwiGLU, LayerNorm, partial-RoPE source (full RoPE
here), qkv bias.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=5632,
    vocab_size=100_352,
    activation="swiglu",
    norm="layernorm",
    qkv_bias=True,
    source="hf:stabilityai/stablelm-2-1_6b",
)


def smoke_config() -> ArchConfig:
    return CONFIG.replace(num_layers=2, d_model=128, num_heads=4,
                          num_kv_heads=4, d_ff=256, vocab_size=512)

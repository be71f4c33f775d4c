"""qwen1.5-4b — dense decoder with QKV bias.

[hf:Qwen/Qwen1.5-0.5B family] 40L d_model=2560 20H (GQA kv=20) d_ff=6912
vocab=151936, SwiGLU, QKV bias.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-4b",
    family="dense",
    num_layers=40,
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    d_ff=6912,
    vocab_size=151_936,
    activation="swiglu",
    qkv_bias=True,
    source="hf:Qwen/Qwen1.5-0.5B",
)


def smoke_config() -> ArchConfig:
    return CONFIG.replace(num_layers=2, d_model=128, num_heads=4,
                          num_kv_heads=4, d_ff=256, vocab_size=512)

"""mistral-nemo-12b — dense decoder, 128k context.

[hf:mistralai/Mistral-Nemo-Base-2407] 40L d_model=5120 32H (GQA kv=8)
d_ff=14336 vocab=131072, head_dim=128, SwiGLU, rope theta 1e6.

``swa_variant()`` is the sliding-window variant (window 4096); the
faithful CONFIG stays full-attention.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14_336,
    vocab_size=131_072,
    head_dim=128,
    activation="swiglu",
    rope_theta=1_000_000.0,
    source="hf:mistralai/Mistral-Nemo-Base-2407",
)


def swa_variant() -> ArchConfig:
    return CONFIG.replace(name="mistral-nemo-12b-swa", sliding_window=4096)


def smoke_config() -> ArchConfig:
    return CONFIG.replace(num_layers=2, d_model=128, num_heads=4,
                          num_kv_heads=2, head_dim=32, d_ff=256,
                          vocab_size=512)

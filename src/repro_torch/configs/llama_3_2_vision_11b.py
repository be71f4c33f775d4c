"""llama-3.2-vision-11b — VLM: cross-attention image layers every 5th layer.

[hf:meta-llama/Llama-3.2-11B-Vision] 40L d_model=4096 32H (GQA kv=8)
d_ff=14336 vocab=128256. The ViT vision encoder + projector is a STUB:
the caller passes precomputed patch embeddings (B, 1600, d_model) as
``batch["image_embed"]``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14_336,
    vocab_size=128_256,
    activation="swiglu",
    rope_theta=500_000.0,
    cross_attn_every=5,
    encoder_seq_len=1600,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)


def smoke_config() -> ArchConfig:
    return CONFIG.replace(num_layers=5, d_model=128, num_heads=4,
                          num_kv_heads=2, d_ff=256, vocab_size=512,
                          encoder_seq_len=16)

"""whisper-small — encoder-decoder audio backbone.

[arXiv:2212.04356] 12L (decoder; +12L encoder) d_model=768 12H (kv=12)
d_ff=3072 vocab=51865. The mel-spectrogram + conv frontend is a STUB:
the caller passes precomputed frame embeddings (B, 1500, d_model) as
``batch["enc_embed"]``. LayerNorm + GELU + QKV bias as in the source;
positions via RoPE, as in the JAX package (the original uses learned /
sinusoidal embeddings).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51_865,
    activation="gelu",
    norm="layernorm",
    qkv_bias=True,
    encoder_layers=12,
    encoder_seq_len=1500,
    source="arXiv:2212.04356",
)


def smoke_config() -> ArchConfig:
    return CONFIG.replace(num_layers=2, encoder_layers=2, d_model=128,
                          num_heads=4, num_kv_heads=4, d_ff=256,
                          vocab_size=512, encoder_seq_len=24)

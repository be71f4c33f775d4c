"""mamba2-1.3b — attention-free SSM with state-space duality (SSD).

[arXiv:2405.21060] 48L d_model=2048 d_ff=0 vocab=50280, ssm_state=128,
head_dim=64, expand=2 (d_inner=4096, 64 ssd heads).
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    use_rope=False,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk_size=256,
                  conv_width=4),
    source="arXiv:2405.21060",
)


def smoke_config() -> ArchConfig:
    return CONFIG.replace(
        num_layers=2, d_model=128, vocab_size=512,
        ssm=SSMConfig(state_dim=16, head_dim=32, expand=2, chunk_size=16,
                      conv_width=4))

"""The paper's shallow agent (Fig. 3 left): 2 conv layers + LSTM, 1.2M params."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="impala-shallow",
    family="impala_cnn",
    num_layers=2,
    d_model=256,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=0,
    impala_net="shallow",
    image_hw=(72, 96, 3),
    lstm_width=256,
    source="arXiv:1802.01561 Fig.3 (left)",
)


def smoke_config() -> ArchConfig:
    return CONFIG.replace(image_hw=(24, 24, 3), lstm_width=64)

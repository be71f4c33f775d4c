"""The paper's deep agent (Fig. 3 right): 15-conv resnet + LSTM, 1.6M params."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="impala-deep",
    family="impala_cnn",
    num_layers=15,
    d_model=256,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=0,
    impala_net="deep",
    image_hw=(72, 96, 3),
    lstm_width=256,
    source="arXiv:1802.01561 Fig.3 (right)",
)


def smoke_config() -> ArchConfig:
    return CONFIG.replace(image_hw=(24, 24, 3), lstm_width=64)

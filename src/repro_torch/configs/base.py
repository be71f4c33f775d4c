"""Configuration dataclasses (the port's own copy of ``repro.configs.base``).

Both keep only the fields the ported paths read: ``ArchConfig`` those of
the conv-LSTM agents, of the dense token decoders and of the Mamba-2 SSM
stack (the MoE, RG-LRU, enc-dec and VLM fields join with those blocks),
and ``ImpalaConfig`` all but the replay buffer's, which join with the
replay learner.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block configuration."""
    state_dim: int = 128          # N
    head_dim: int = 64            # P
    num_heads: int = 0            # derived: d_inner // head_dim if 0
    expand: int = 2
    chunk_size: int = 256
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # impala_cnn | dense | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 => d_model // num_heads
    # activation: 'gelu' | 'silu' | 'relu' | 'tanh' | 'geglu' | 'swiglu'
    activation: str = "swiglu"
    norm: str = "rmsnorm"         # 'rmsnorm' | 'layernorm'
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    use_rope: bool = True
    sliding_window: int = 0       # 0 = full attention
    ssm: Optional[SSMConfig] = None
    # IMPALA conv nets (paper Fig. 3)
    impala_net: str = ""          # '' | 'shallow' | 'deep'
    image_hw: Tuple[int, int, int] = (72, 96, 3)
    lstm_width: int = 256
    dtype: str = "bfloat16"       # activations of the token backbones
    param_dtype: str = "float32"
    # citation for the source model/paper
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ImpalaConfig:
    num_actions: int = 18                # Atari full action set by default
    unroll_length: int = 100             # n (paper Table D.3)
    discount: float = 0.99
    baseline_cost: float = 0.5
    entropy_cost: float = 0.00025
    rho_bar: Optional[float] = 1.0       # \bar{rho}; None = no clip
    c_bar: Optional[float] = 1.0         # \bar{c}; None = no clip
    lambda_: float = 1.0                 # Remark 2 extension
    correction: str = "vtrace"           # vtrace | onestep_is | eps | none
    # Appendix E.3: q_s = r + gamma*v_{s+1} ('vtrace', default/better) vs
    # q_s = r + gamma*V(x_{s+1}) ('baseline_v', no rollout information)
    pg_q_estimate: str = "vtrace"
    eps_correction: float = 1e-6
    reward_clip: str = "abs_one"         # abs_one | soft_asymmetric | none
    # replay (paper 5.2.2): only 0 is ported (ROADMAP.md, Queue 1 item 11)
    replay_fraction: float = 0.0
    # simulated policy lag (actor params k updates behind learner)
    policy_lag: int = 1
    learning_rate: float = 6e-4
    lr_anneal_steps: int = 0             # 0 = constant
    rmsprop_decay: float = 0.99
    rmsprop_momentum: float = 0.0
    rmsprop_eps: float = 0.1
    grad_clip_norm: float = 40.0

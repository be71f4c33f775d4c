"""Configuration dataclasses (the port's own copy of ``repro.configs.base``).

``ArchConfig`` keeps only the fields the ported paths read: those of the
conv-LSTM agents and of every token backbone (dense, MoE, SSM, RG-LRU
hybrid, enc-dec audio and cross-attention VLM). It leaves out the JAX
package's scan/remat switches, which only shape XLA's program.
``ImpalaConfig`` has every field of the reference but ``seed``, which
no code reads: the runs take their seed as an argument. ``MeshConfig``,
``InputShape`` and ``INPUT_SHAPES`` (the four assigned step shapes) are
the reference's, field for field and value for value.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    num_experts_per_tok: int = 0
    capacity_factor: float = 1.25
    router_aux_loss_coef: float = 0.01
    # 'dense_einsum' (GSPMD auto) or 'shard_map_a2a' (explicit all_to_all)
    dispatch_impl: str = "dense_einsum"


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
class RGLRUConfig:
    """RecurrentGemma RG-LRU block configuration."""
    lru_width: int = 0            # defaults to d_model if 0
    conv_width: int = 4
    # layer pattern: 'rr a' repeated -> 2 recurrent : 1 local attention
    pattern: Tuple[str, ...] = ("recurrent", "recurrent", "attention")
    attention_window: int = 2048


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    # dense | moe | ssm | hybrid | audio | vlm | impala_cnn
    family: str
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
    # encoder-decoder (whisper): encoder layer count; 0 = decoder-only
    encoder_layers: int = 0
    encoder_seq_len: int = 0      # stub frontend's length (frames/patches)
    # VLM: insert a cross-attention layer every k layers (0 = none)
    cross_attn_every: int = 0
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
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
    # replay (paper 5.2.2)
    replay_capacity: int = 10_000
    replay_fraction: float = 0.0         # 0.5 in the replay experiments
    replay_reuse: int = 2                # K: max total consumptions/traj
    replay_priority: str = "pertd"       # pertd | uniform (Ape-X prop.)
    replay_target_period: int = 16       # updates between target syncs
    # learner batch (trajectories per update)
    batch_size: int = 32
    # simulated policy lag (actor params k updates behind learner)
    policy_lag: int = 1
    learning_rate: float = 6e-4
    lr_anneal_steps: int = 0             # 0 = constant
    rmsprop_decay: float = 0.99
    rmsprop_momentum: float = 0.0
    rmsprop_eps: float = 0.1
    grad_clip_norm: float = 40.0


# ---------------------------------------------------------------------------
# Mesh / distribution


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    multi_pod: bool = False
    data_axis: int = 16
    model_axis: int = 16
    pod_axis: int = 2

    @property
    def shape(self):
        if self.multi_pod:
            return (self.pod_axis, self.data_axis, self.model_axis)
        return (self.data_axis, self.model_axis)

    @property
    def axis_names(self):
        if self.multi_pod:
            return ("pod", "data", "model")
        return ("data", "model")


# ---------------------------------------------------------------------------
# Input shapes (assigned)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

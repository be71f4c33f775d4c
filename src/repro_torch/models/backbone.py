"""The paper's conv(+LSTM) agent: specs, heads and the trajectory apply
(``repro.models.backbone`` for ``family == 'impala_cnn'``).

The conv torso is folded over time (B*T images), the LSTM runs over
time with the actor-provided initial state, and the heads give
``AgentOutput(policy_logits, values)``. Token backbones are not ported:
the registry refuses their names.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import convnets, lstm as lstm_lib
from repro_torch.models.common import dense, dense_specs


@dataclasses.dataclass
class AgentOutput:
    policy_logits: torch.Tensor  # (B, T, A) float32
    values: torch.Tensor         # (B, T)   float32
    cache: Optional[Any] = None  # final LSTM state


def head_specs(num_actions: int, d: int = 256) -> Dict:
    return {
        "policy": dense_specs((d,), (num_actions,), bias=True, scale=0.01),
        "value": dense_specs((d,), (1,), bias=True, scale=0.01),
    }


def backbone_specs(cfg: ArchConfig, num_actions: int) -> Dict:
    torso = (convnets.shallow_specs(cfg.image_hw)
             if cfg.impala_net == "shallow"
             else convnets.deep_specs(cfg.image_hw))
    return {
        "torso": torso,
        "lstm": lstm_lib.lstm_specs(256 + num_actions + 1, cfg.lstm_width),
        "post_lstm": dense_specs((cfg.lstm_width,), (256,), bias=True),
        **head_specs(num_actions),
    }


def apply_heads(params, x):
    logits = dense(params["policy"], x)
    values = dense(params["value"], x)[..., 0]
    return logits, values


def apply_train(params, batch: Dict, cfg: ArchConfig,
                num_actions: int) -> AgentOutput:
    """batch: image (B,T,H,W,C) uint8, last_action (B,T) int, last_reward
    (B,T) f32, done (B,T) bool, lstm_state ((B,W),(B,W)) or None."""
    img = batch["image"]
    b, t = img.shape[:2]
    flat = img.reshape((b * t,) + tuple(img.shape[2:]))
    feats = (convnets.shallow_apply(params["torso"], flat)
             if cfg.impala_net == "shallow"
             else convnets.deep_apply(params["torso"], flat))
    feats = feats.reshape(b, t, -1)
    last_a = F.one_hot(batch["last_action"].long(),
                       num_actions).to(feats.dtype)
    last_r = batch["last_reward"][..., None].to(feats.dtype)
    core_in = torch.cat([feats, last_a, last_r], dim=-1)
    lstm_state = batch.get("lstm_state")
    if lstm_state is None:
        lstm_state = lstm_lib.lstm_zero_state(b, cfg.lstm_width,
                                              feats.device)
    ys, state = lstm_lib.lstm_apply(params["lstm"], core_in, lstm_state,
                                    done=batch.get("done"))
    feats = F.relu(dense(params["post_lstm"], ys))
    logits, values = apply_heads(params, feats)
    return AgentOutput(logits, values, cache=state)

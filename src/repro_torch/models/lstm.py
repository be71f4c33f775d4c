"""LSTM core of the paper's agents (``repro.models.lstm``).

A cell loop, not ``nn.LSTM``: a ``done`` flag zeroes the state *before*
step t consumes its input (an episode boundary inside a trajectory), the
gates are ordered i, f, g, o with a +1 forget bias, and only the input
projection has a bias.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models.common import dense, dense_specs


def lstm_specs(d_in: int, width: int) -> Dict:
    return {
        "wx": dense_specs((d_in,), (4 * width,), bias=True),
        "wh": dense_specs((width,), (4 * width,)),
    }


def lstm_step(params, carry, x):
    """carry = (h, c) each (B, W); x (B, d_in)."""
    h, c = carry
    gates = dense(params["wx"], x) + dense(params["wh"], h)
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c_new = (torch.sigmoid(f + 1.0) * c +
             torch.sigmoid(i) * torch.tanh(g))
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def lstm_apply(params, x, initial_state, done=None):
    """x: (B, T, d_in); initial_state = (h0, c0) each (B, W).

    done: optional (B, T) bool — resets state *before* consuming step t.
    Returns (outputs (B, T, W), final_state).
    """
    carry = initial_state
    ys = []
    for t in range(x.shape[1]):
        if done is not None:
            mask = (1.0 - done[:, t].to(torch.float32))[:, None]
            carry = (carry[0] * mask, carry[1] * mask)
        carry = lstm_step(params, carry, x[:, t])
        ys.append(carry[0])
    return torch.stack(ys, dim=1), carry


def lstm_zero_state(batch: int, width: int,
                    device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    z = torch.zeros((batch, width), dtype=torch.float32, device=device)
    return (z, z)

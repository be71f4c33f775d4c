"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427)
(``repro.models.rglru``).

Recurrence (per channel):
    r_t = sigmoid(W_a u_t + b_a)              recurrence gate
    i_t = sigmoid(W_x u_t + b_x)              input gate
    a_t = exp(c * r_t * log sigmoid(Lambda))  (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

The JAX package carries the diagonal recurrence through a chunked
``lax.scan``; here ``rglru_core`` runs it as one ``ops.linear_scan`` over
time-major (T, B*W) inputs (kernel K3 on the card), in the training mode
too, where K3's gradient is K3 on reversed time.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.common import (Spec, activation, dense, dense_specs,
                                       torch_dtype)
from repro_torch.models.ssm import _causal_conv

_C = 8.0


def _width(cfg: ArchConfig) -> int:
    return cfg.rglru.lru_width or cfg.d_model


def rglru_specs(cfg: ArchConfig) -> Dict:
    d = cfg.d_model
    w = _width(cfg)
    cw = cfg.rglru.conv_width
    return {
        # Griffin recurrent block: two input branches + output proj
        "in_gate": dense_specs((d,), (w,)),       # gelu branch
        "in_rec": dense_specs((d,), (w,)),        # recurrent branch
        "conv": {"kernel": Spec((cw, w), init="normal"),
                 "bias": Spec((w,), init="zeros")},
        "gate_a": dense_specs((w,), (w,), bias=True),
        "gate_x": dense_specs((w,), (w,), bias=True),
        "lam": {"w": Spec((w,), init="normal")},
        "out": dense_specs((w,), (d,)),
    }


def _gates(params, u32: torch.Tensor):
    """(log a, i) in float32 for u (..., W) in float32."""
    r = torch.sigmoid(dense(params["gate_a"], u32))
    i = torch.sigmoid(dense(params["gate_x"], u32))
    log_a = _C * r * F.logsigmoid(params["lam"]["w"].to(torch.float32))
    return log_a, i


def rglru_core(params, u: torch.Tensor, h0: Optional[torch.Tensor] = None,
               impl: str = "auto"):
    """u: (B,T,W) -> (h (B,T,W) f32, h_final (B,W) f32). ``impl`` is the
    recurrence's route (``ops.linear_scan``)."""
    bsz, t, w = u.shape
    u32 = u.to(torch.float32)
    log_a, i = _gates(params, u32)
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                   min=1e-12)) * (i * u32)
    # time-major (T, B*W) for the scan, h0 as a (B*W,) vector
    a_scan = a.transpose(0, 1).reshape(t, bsz * w).contiguous()
    b_scan = gated.transpose(0, 1).reshape(t, bsz * w).contiguous()
    del a, gated
    h0v = None if h0 is None else \
        h0.to(torch.float32).reshape(-1).contiguous()
    hs = ops.linear_scan(a_scan, b_scan, h0v, impl=impl)
    del a_scan, b_scan
    # a copy: a view would keep every step's states alive in the cache
    h_final = hs[-1].reshape(bsz, w).clone()
    h = hs.reshape(t, bsz, w).transpose(0, 1)
    return h, h_final


def rglru_core_step(params, u: torch.Tensor, h: torch.Tensor):
    """u: (B,W), h: (B,W) -> (y, h')."""
    u32 = u.to(torch.float32)
    log_a, i = _gates(params, u32)
    a = torch.exp(log_a)
    h_new = a * h + torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * \
        (i * u32)
    return h_new, h_new


def apply_rglru(params, x: torch.Tensor, cfg: ArchConfig, *, mode: str,
                state: Optional[Dict[str, torch.Tensor]] = None,
                impl: str = "auto",
                ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Griffin recurrent block. x: (B,T,d_model).

    state = {'h': (B,W) f32, 'conv': (B, conv_width-1, W)}. Prefill ignores
    any state given (as the JAX function does) and returns a new one;
    train does the same with a gradient, and returns no state (None).
    Decode writes the step's h and conv states into ``state`` in place and
    returns it (the JAX function returns new arrays)."""
    dtype = torch_dtype(cfg.dtype)
    gate_branch = activation("gelu")(dense(params["in_gate"], x,
                                           dtype=dtype))
    conv_in = dense(params["in_rec"], x, dtype=dtype)
    conv_state = state["conv"] if state is not None else None
    rec, new_conv = _causal_conv(conv_in, params["conv"]["kernel"],
                                 params["conv"]["bias"], conv_state)

    if mode == "decode":
        assert state is not None and x.shape[1] == 1
        h_new, y = rglru_core_step(params, rec[:, 0], state["h"])
        y = y[:, None]
        state["h"].copy_(h_new)
        state["conv"].copy_(new_conv)
        new_state = state
    elif mode == "prefill":
        y, h_final = rglru_core(params, rec, impl=impl)
        # the streaming conv state: the raw tail of the conv's inputs (the
        # projection before the conv), left-padded when T is shorter,
        # copied so that the cache does not keep all of them alive
        cw = cfg.rglru.conv_width
        tail = conv_in[:, -(cw - 1):].clone()
        if tail.shape[1] < cw - 1:
            tail = F.pad(tail, (0, 0, cw - 1 - tail.shape[1], 0))
        new_state = {"h": h_final, "conv": tail}
    elif mode == "train":
        y, _ = rglru_core(params, rec, impl=impl)
        new_state = None
    else:
        raise ValueError(f"mode {mode!r}: expected 'train', 'prefill' or "
                         f"'decode'")

    y = y.to(dtype) * gate_branch
    out = dense(params["out"], y, dtype=dtype)
    return out, new_state


def rglru_state_abstract(batch: int, cfg: ArchConfig, dtype
                         ) -> Dict[str, torch.Tensor]:
    """The decode state of one layer as ``meta`` tensors: h in float32,
    the conv state in the activations' dtype."""
    w = _width(cfg)
    cw = cfg.rglru.conv_width
    return {"h": torch.empty((batch, w), dtype=torch.float32, device="meta"),
            "conv": torch.empty((batch, cw - 1, w), dtype=dtype,
                                device="meta")}

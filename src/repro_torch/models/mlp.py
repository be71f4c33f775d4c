"""Feed-forward blocks (``repro.models.mlp``): plain MLP, GeGLU (gemma),
SwiGLU (llama-family)."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ArchConfig
from repro_torch.models import common
from repro_torch.models.common import dense, dense_specs, torch_dtype


def mlp_specs(cfg: ArchConfig, d_ff: int = 0) -> Dict:
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    specs = {
        "up": dense_specs((d,), (ff,)),
        "down": dense_specs((ff,), (d,)),
    }
    if cfg.activation in ("geglu", "swiglu"):
        specs["gate"] = dense_specs((d,), (ff,))
    return specs


def apply_mlp(params, x, cfg: ArchConfig):
    dtype = torch_dtype(cfg.dtype)
    act = cfg.activation
    up = dense(params["up"], x, dtype=dtype)
    if act == "geglu":
        h = common.activation("gelu")(
            dense(params["gate"], x, dtype=dtype)) * up
    elif act == "swiglu":
        h = common.activation("silu")(
            dense(params["gate"], x, dtype=dtype)) * up
    else:
        h = common.activation(act)(up)
    return dense(params["down"], h, dtype=dtype)

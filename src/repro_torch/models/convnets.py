"""The paper's own agent torsos (Figure 3), ``repro.models.convnets``.

Shallow: Conv 8x8/4 x16 -> Conv 4x4/2 x32 -> FC 256 (1.2M params w/ LSTM).
Deep: 3 sections of [conv3x3 + maxpool/2 + 2 residual blocks (2x conv3x3)]
with channels (16, 32, 32), then FC 256 (15 conv layers, 1.6M params).

Inputs are (B, H, W, C) uint8 pixels in [0, 255], as in the JAX package;
the convs run NCHW with OIHW kernels. Three details keep the port equal
to ``lax.conv_general_dilated``/``reduce_window``:

* ``SAME`` padding of a strided conv is asymmetric (the extra row or
  column goes after), so it is an explicit ``F.pad`` before a
  ``padding=0`` conv;
* the max-pool pads with -inf;
* the flatten before the fc layer is in NHWC order.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import Spec, dense, dense_specs


def _conv_spec(kh, kw, cin, cout) -> Dict[str, Spec]:
    # JAX layout (HWIO) in the spec: the bridge makes it OIHW
    return {"kernel": Spec((kh, kw, cin, cout), (None, None, None, None)),
            "bias": Spec((cout,), (None,), init="zeros")}


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding (before, after) for one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pad_same(x, kh: int, kw: int, stride: int, value: float = 0.0):
    top, bottom = same_pads(x.shape[2], kh, stride)
    left, right = same_pads(x.shape[3], kw, stride)
    return F.pad(x, (left, right, top, bottom), value=value)


def _conv(params, x, stride: int):
    """The kernel and bias in x's dtype, as the JAX ``_conv`` casts them
    (bf16 params under mixed precision; f32 ones are passed as they are)."""
    w = params["kernel"].to(x.dtype)           # (O, I, kh, kw)
    x = _pad_same(x, w.shape[2], w.shape[3], stride)
    return F.conv2d(x, w, params["bias"].to(x.dtype), stride=stride)


def _maxpool(x, window: int = 3, stride: int = 2):
    x = _pad_same(x, window, window, stride, value=-math.inf)
    return F.max_pool2d(x, window, stride)


def _flat_dim(hw: Tuple[int, int, int], reductions: int, channels: int) -> int:
    h, w, _ = hw
    for _ in range(reductions):
        h = math.ceil(h / 2)
        w = math.ceil(w / 2)
    return h * w * channels


def _to_nchw(img):
    return (img.to(torch.float32) / 255.0).permute(0, 3, 1, 2)


def _flatten_nhwc(x):
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


# ---------------------------------------------------------------------------
# Shallow


def shallow_specs(image_hw, d_out: int = 256) -> Dict:
    c = image_hw[2]
    flat = _flat_dim(image_hw, 3, 32)  # strides 4 then 2 => /8 total
    return {
        "conv1": _conv_spec(8, 8, c, 16),
        "conv2": _conv_spec(4, 4, 16, 32),
        "fc": dense_specs((flat,), (d_out,), (None,), ("embed",),
                          bias=True),
    }


def shallow_apply(params, img) -> torch.Tensor:
    x = _to_nchw(img)
    x = F.relu(_conv(params["conv1"], x, 4))
    x = F.relu(_conv(params["conv2"], x, 2))
    return F.relu(dense(params["fc"], _flatten_nhwc(x)))


# ---------------------------------------------------------------------------
# Deep residual


_DEEP_CHANNELS = (16, 32, 32)


def deep_specs(image_hw, d_out: int = 256) -> Dict:
    c_in = image_hw[2]
    specs: Dict = {}
    for s, ch in enumerate(_DEEP_CHANNELS):
        sec: Dict = {"conv": _conv_spec(3, 3, c_in, ch)}
        for b in range(2):
            sec[f"res{b}a"] = _conv_spec(3, 3, ch, ch)
            sec[f"res{b}b"] = _conv_spec(3, 3, ch, ch)
        specs[f"section{s}"] = sec
        c_in = ch
    flat = _flat_dim(image_hw, len(_DEEP_CHANNELS), _DEEP_CHANNELS[-1])
    specs["fc"] = dense_specs((flat,), (d_out,), (None,), ("embed",),
                              bias=True)
    return specs


def deep_apply(params, img) -> torch.Tensor:
    x = _to_nchw(img)
    for s in range(len(_DEEP_CHANNELS)):
        sec = params[f"section{s}"]
        x = _maxpool(_conv(sec["conv"], x, 1))
        for b in range(2):
            y = _conv(sec[f"res{b}a"], F.relu(x), 1)
            y = _conv(sec[f"res{b}b"], F.relu(y), 1)
            x = x + y
    x = F.relu(x)
    return F.relu(dense(params["fc"], _flatten_nhwc(x)))

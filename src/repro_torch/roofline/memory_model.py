"""Analytic per-device memory model for the dry run's "fits" proof
(``repro.roofline.memory_model``, number for number).

This is the reference's model of what one TPU device's HBM holds under
its buffer assignment (which reuses sequential layers' buffers), kept as
it is so that the two packages agree; the one change is the fit, which
is against one H100's 80 GB (``HW["hbm_bytes"]``, ``fits_80g``) in place
of 16 GB:

  persistent: param shards (f32) + optimizer state + (train) grad shards
  activations (train): checkpointed block inputs (one (B_loc, T, d) bf16
    per layer group) + the working set of ONE block's fwd+bwd
  caches (decode/prefill): KV/state shards

The port keeps no remat, so its own train step holds more activations
than the "residuals" term; ``chip_smoke.py`` prints this total beside the
card's measured peak.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.launch.mesh import HW
from repro_torch.models import backbone as bb
from repro_torch.params import tree_leaves
from repro_torch.sharding.rules import Rules


def _shard_bytes(specs, rules: Rules) -> int:
    total = 0
    for s in tree_leaves(specs):
        size = math.prod(s.shape) * np.dtype(s.dtype).itemsize
        total += size // rules.shards(s.logical, s.shape)
    return total


def batch_shards(rules: Rules) -> int:
    """Devices the batch axis is split over under ``rules``."""
    n = 1
    ax = rules.table.get("batch")
    if ax:
        axes = (ax,) if isinstance(ax, str) else ax
        for a in axes:
            n *= rules.mesh.shape[a]
    return n


def _model_shards(rules: Rules) -> int:
    out = 1
    for name, size in rules.mesh.shape.items():
        if name not in ("data", "pod"):
            out *= size
    return out


def estimate(arch: ArchConfig, shape: InputShape, rules: Rules,
             num_actions: int = 18) -> Dict[str, float]:
    specs = bb.backbone_specs(arch, num_actions)
    p_bytes = _shard_bytes(specs, rules)            # f32 params per device
    b_loc = max(shape.global_batch // batch_shards(rules), 1)
    d = arch.d_model
    act = 2  # bf16
    out: Dict[str, float] = {"params": float(p_bytes)}

    if shape.kind == "train":
        t = shape.seq_len
        out["opt_state"] = float(p_bytes)           # rmsprop ms
        out["grads"] = float(p_bytes)
        n_blocks = arch.num_layers
        # checkpointed residuals: block input per layer
        out["residuals"] = float(n_blocks * b_loc * t * d * act)
        # one block's live working set (dominated by attention scores f32
        # chunk or MoE dispatch buffers), sharded over model where possible
        h_loc = max(arch.num_heads // _model_shards(rules), 1) \
            if arch.num_heads else 1
        qc = min(t, 4096)
        attn_ws = b_loc * h_loc * qc * min(t, 4096) * 4
        ff_loc = max(arch.d_ff // _model_shards(rules), arch.d_ff and 1)
        mlp_ws = b_loc * t * max(ff_loc, d) * act * 3
        moe_ws = 0
        if arch.moe is not None:
            cap = int(b_loc * t * arch.moe.num_experts_per_tok /
                      arch.moe.num_experts * 1.25)
            e_loc = max(arch.moe.num_experts // _model_shards(rules), 1)
            moe_ws = (e_loc * cap * max(arch.d_ff, d) * act * 3 +
                      b_loc * t * arch.moe.num_experts_per_tok * d * act)
        out["block_workspace"] = float(max(attn_ws + mlp_ws, moe_ws) * 2)
    else:
        # prefill/decode: cache + one block workspace
        cache_abs = bb.cache_abstract(
            shape.global_batch,
            min(arch.sliding_window or shape.seq_len, shape.seq_len), arch)
        axes = bb.cache_logical_axes(arch)
        cache_bytes = 0
        for sd, ax in zip(tree_leaves(cache_abs), tree_leaves(axes)):
            size = math.prod(sd.shape) * sd.dtype.itemsize
            cache_bytes += size // rules.shards(ax, sd.shape)
        out["cache"] = float(cache_bytes)
        t = shape.seq_len if shape.kind == "prefill" else 1
        out["block_workspace"] = float(b_loc * t * max(arch.d_ff, d) * act
                                       * 3)

    out["total"] = float(sum(out.values()))
    out["fits_80g"] = bool(out["total"] < HW["hbm_bytes"])
    return out

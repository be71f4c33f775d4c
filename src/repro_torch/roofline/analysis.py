"""Roofline terms of a step on one H100 (``repro.roofline.analysis``).

Per (arch, shape, mesh), in seconds a step:

  compute    = FLOPs_per_device / peak_FLOP/s
  memory     = bytes_per_device / HBM_bw
  collective = collective_bytes_per_device / link_bw

The reference reads the FLOPs and bytes from XLA's cost analysis of the
compiled program and the collective bytes from its HLO text. The port
has neither: ``eager_cost`` counts a step run eagerly on ``meta``
tensors (PyTorch's flop counter over its operators, plus each kernel's
meta route, ``repro_torch.kernels.meta``; bytes as each operator's
operands plus results). The port runs no collective, so ``analyse``
takes the collective bytes as a dict, which the dry run passes empty:
then there is no collective term, and the bottleneck is the larger of
compute and memory. HLO parsing (``collective_bytes``) is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as pytree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import meta

# allocations move no data: their results are not counted as written
_ALLOCATIONS = {
    torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
    torch.ops.aten.empty_like.default, torch.ops.aten.new_empty.default,
    torch.ops.aten.new_empty_strided.default,
}


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collectives: Dict[str, int]
    compute_s: float
    memory_s: float
    collective_s: Optional[float]
    bottleneck: str
    model_flops: Optional[float] = None
    useful_flops_ratio: Optional[float] = None


class _ByteCount(TorchDispatchMode):
    """Sums the bytes of every operator's tensor operands and results,
    leaving out views and allocations, which move no data."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func not in _ALLOCATIONS:
            self.total += meta.nbytes(
                [x for x in pytree_leaves((args, kwargs, out))
                 if isinstance(x, torch.Tensor)])
        return out


def eager_cost(fn: Callable, *args) -> Dict[str, float]:
    """Run ``fn(*args)`` (on ``meta`` tensors, for a step at full size)
    and count it: ``{"flops": ..., "bytes accessed": ...}``, the keys of
    the reference's cost dict, with ``"kernel_launches"`` the meta
    route's launches among them."""
    flops = FlopCounterMode(display=False)
    byte_count = _ByteCount()
    with meta.counting() as kernels, flops, byte_count:
        fn(*args)
    return {"flops": float(flops.get_total_flops() + kernels["flops"]),
            "bytes accessed": float(byte_count.total + kernels["bytes"]),
            "kernel_launches": kernels["launches"]}


def analyse(cost: Dict[str, float], collectives: Dict[str, int],
            hw: Dict[str, float],
            model_flops: Optional[float] = None) -> Roofline:
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    coll_total = float(sum(collectives.values()))
    compute_s = flops / hw["peak_flops_bf16"]
    memory_s = byts / hw["hbm_bw"]
    terms = {"compute": compute_s, "memory": memory_s}
    collective_s = None
    if collectives:
        collective_s = coll_total / hw["nvlink_bw_one_way"]
        terms["collective"] = collective_s
    bottleneck = max(terms, key=terms.get)
    ratio = None
    if model_flops:
        # model_flops is whole-step; cost flops are per-device
        ratio = model_flops / max(flops, 1.0)
    return Roofline(flops, byts, coll_total, dict(collectives), compute_s,
                    memory_s, collective_s, bottleneck, model_flops, ratio)


# ---------------------------------------------------------------------------
# MODEL_FLOPS: 6*N*D for training (dense), 6*N_active*D (MoE); 2*N per
# decoded token.


def _active_params(arch, n_params: int) -> int:
    if arch.moe is None:
        return n_params
    m = arch.moe
    # expert FFN params scale down by (top_k / E); router+attn+embed stay
    gated = arch.activation in ("geglu", "swiglu")
    per_expert = arch.d_model * arch.d_ff * (3 if gated else 2)
    expert_params = arch.num_layers * m.num_experts * per_expert
    active_expert = expert_params * m.num_experts_per_tok / m.num_experts
    return n_params - expert_params + int(active_expert)


def model_flops(arch, n_params: int, shape, per_device: bool,
                n_devices: int) -> float:
    n_active = _active_params(arch, n_params)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        total = 6.0 * n_active * tokens
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        total = 2.0 * n_active * tokens
    else:  # decode: one token per sequence
        total = 2.0 * n_active * shape.global_batch
    return total / n_devices if per_device else total

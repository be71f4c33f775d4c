"""Mixture-of-Experts (``repro.models.moe``): a token-choice top-k router
with capacity-based dispatch, on one device.

Expert weights are stacked (E, ...). Dispatch is capacity-bounded per
*row* (a row is one sequence in prefill, or the whole batch in decode):
the top-k expert ids are flattened token-major to (R, T*k), a cumulative
sum over that order gives each (token, expert) pair its 1-based slot in
the expert's buffer, and a pair is kept while its slot is within the
capacity. Kept tokens are written to their (row, expert, slot) by
indexing: each has exactly one writer, so the buffers hold the values
the reference's scatter-add of the masked tokens sums to, without
atomics. The expert FFNs are batched matrix products over the expert
axis; the combine gathers each pair's output back, weighted by its gate.

``apply_moe`` returns the combined output and the Switch-style
load-balancing aux loss. Expert parallelism (the JAX package's
``shard_map_a2a`` dispatch under sharding rules) is not ported: this
``apply_moe`` takes no sharding rules and always runs the one-device
path (ROADMAP.md, Queue 1 item 15).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import common
from repro_torch.models.common import Spec, torch_dtype


def moe_specs(cfg: ArchConfig) -> Dict:
    if cfg.moe is None:
        raise ValueError(f"{cfg.name}: an MoE block needs cfg.moe")
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    specs = {
        "router": {"kernel": Spec((d, e))},
        "up": {"kernel": Spec((e, d, ff))},
        "down": {"kernel": Spec((e, ff, d))},
    }
    if cfg.activation in ("geglu", "swiglu"):
        specs["gate"] = {"kernel": Spec((e, d, ff))}
    return specs


def _capacity(tokens_per_row: int, cfg: ArchConfig) -> int:
    m = cfg.moe
    c = int(tokens_per_row * m.num_experts_per_tok / m.num_experts
            * m.capacity_factor)
    return max(c, m.num_experts_per_tok)


def route(params, x: torch.Tensor, cfg: ArchConfig):
    """x: (R, T, d) -> (gates (R, T, k), idx (R, T, k), aux_loss scalar).

    The logits are float32, from float32 casts of x and the router kernel;
    the top-k gates are renormalised to sum to 1."""
    m = cfg.moe
    logits = torch.einsum("rtd,de->rte", x.to(torch.float32),
                          params["router"]["kernel"].to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, m.num_experts_per_tok, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance loss: E * sum_e f_e * p_e
    f = F.one_hot(idx, m.num_experts).to(torch.float32).mean(dim=(0, 1, 2))
    p = probs.mean(dim=(0, 1))
    aux = m.num_experts * torch.sum(f * p)
    return gates, idx, aux


def apply_moe(params, x: torch.Tensor, cfg: ArchConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, d). Returns (y (B, T, d) in ``cfg.dtype``, aux_loss f32).

    T == 1 is decode: the whole batch is one dispatch row, with twice the
    capacity (decode rows are tiny)."""
    m = cfg.moe
    dtype = torch_dtype(cfg.dtype)
    b, t, d = x.shape
    decode = t == 1
    xr = x.reshape(1, b, d) if decode else x
    r, tok, _ = xr.shape
    k, e = m.num_experts_per_tok, m.num_experts
    cap = _capacity(tok, cfg) * (2 if decode else 1)

    gates, idx, aux = route(params, xr, cfg)

    # --- dispatch bookkeeping, in the reference's token-major order -----
    flat_e = idx.reshape(r, tok * k)                       # (R, N)
    onehot = F.one_hot(flat_e, e)
    pos = (torch.cumsum(onehot, dim=1) * onehot).sum(-1)   # 1-based
    keep = pos <= cap
    slot = torch.clamp(pos - 1, 0, cap - 1)

    # kept pairs write their own slot; dropped ones a spare slot ``cap``
    # that is cut off, so no kept slot has a second writer
    x_rep = torch.repeat_interleave(xr.to(dtype), k, dim=1)   # (R, N, d)
    r_idx = torch.arange(r, device=x.device)[:, None].expand(r, tok * k)
    dispatch = x_rep.new_zeros((r, e, cap + 1, d))
    dispatch[r_idx, flat_e, torch.where(keep, slot, cap)] = x_rep
    dispatch = dispatch[:, :, :cap]

    # --- expert FFN ------------------------------------------------------
    def w(name):
        return params[name]["kernel"].to(dtype)

    up = torch.einsum("recd,edf->recf", dispatch, w("up"))
    if cfg.activation in ("geglu", "swiglu"):
        act = "gelu" if cfg.activation == "geglu" else "silu"
        g = torch.einsum("recd,edf->recf", dispatch, w("gate"))
        h = common.activation(act)(g) * up
    else:
        h = common.activation(cfg.activation)(up)
    out = torch.einsum("recf,efd->recd", h, w("down"))

    # --- combine ----------------------------------------------------------
    gathered = out[r_idx, flat_e, slot]                    # (R, N, d)
    gathered = gathered * (gates.reshape(r, tok * k)[..., None].to(dtype)
                           * keep[..., None].to(dtype))
    y = gathered.reshape(r, tok, k, d).sum(dim=2)
    if decode:
        y = y.reshape(b, t, d)
    return y, aux.to(torch.float32)

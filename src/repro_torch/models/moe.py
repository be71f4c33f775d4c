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
load-balancing aux loss.

Expert parallelism (``dispatch_impl == "shard_map_a2a"`` under sharding
rules, ``_apply_moe_shard_map``): the reference's ``shard_map`` becomes
the ranks of a ``torch.distributed`` group, the rules' mesh's DeviceMesh
(``launch.mesh.Mesh.device_mesh``). Each rank holds its batch shard's
tokens and its E/n experts (its coordinate on the ``experts`` axis),
routes the tokens with the replicated router, dispatches and computes
only its experts (``_dispatch_compute_combine``), and the partial outputs
are summed over the expert axis's subgroup (the reference's ``psum``);
the aux loss is averaged over the batch axis's. It is forward only: no
executed path of the reference trains through it, and its backward needs
the all-reduce pair around the shard, so grad-requiring inputs are
refused (ROADMAP.md, Queue 1 item 15E).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

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
        "router": {"kernel": Spec((d, e), ("embed", "experts"))},
        "up": {"kernel": Spec((e, d, ff), ("experts", "embed", "ff"))},
        "down": {"kernel": Spec((e, ff, d), ("experts", "ff", "embed"))},
    }
    if cfg.activation in ("geglu", "swiglu"):
        specs["gate"] = {"kernel": Spec((e, d, ff),
                                        ("experts", "embed", "ff"))}
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
    capacity (decode rows are tiny). With ``dispatch_impl ==
    "shard_map_a2a"`` under sharding rules (``use_rules``) the experts are
    split over the rules' mesh (``_apply_moe_shard_map``)."""
    from repro_torch.sharding.rules import get_rules

    rules = get_rules()
    if cfg.moe.dispatch_impl == "shard_map_a2a" and rules is not None:
        return _apply_moe_shard_map(params, x, cfg, rules)
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


def _dispatch_compute_combine(local_w, xr: torch.Tensor, gates, idx,
                              cap: int, cfg: ArchConfig, e_base: int,
                              e_local: int) -> torch.Tensor:
    """Capacity dispatch, expert FFN and combine for experts [e_base,
    e_base + e_local): ``local_w`` holds those experts' weights {up,
    down[, gate]}, each (e_local, ...); xr: (R, T, d). Pairs routed to
    other experts go to an overflow bucket, as the reference's; kept pairs
    write their own (expert, slot), the others a spare one that is cut
    off. Returns this shard's part of the output, (R, T, d)."""
    m = cfg.moe
    dtype = torch_dtype(cfg.dtype)
    r, tok, d = xr.shape
    k = m.num_experts_per_tok

    flat_e = idx.reshape(r, tok * k)                       # global ids
    local_e = flat_e - e_base
    is_local = (local_e >= 0) & (local_e < e_local)
    local_e = torch.where(is_local, local_e, e_local)      # overflow
    onehot = F.one_hot(local_e, e_local + 1)
    pos = (torch.cumsum(onehot, dim=1) * onehot).sum(-1)
    keep = is_local & (pos <= cap)
    slot = torch.clamp(pos - 1, 0, cap - 1)
    local_e = torch.where(keep, local_e, e_local)          # to the bucket

    x_rep = torch.repeat_interleave(xr.to(dtype), k, dim=1)
    r_idx = torch.arange(r, device=xr.device)[:, None].expand(r, tok * k)
    dispatch = x_rep.new_zeros((r, e_local + 1, cap + 1, d))
    dispatch[r_idx, local_e, torch.where(keep, slot, cap)] = x_rep
    dispatch = dispatch[:, :e_local, :cap]

    def w(name):
        return local_w[name].to(dtype)

    up = torch.einsum("recd,edf->recf", dispatch, w("up"))
    if cfg.activation in ("geglu", "swiglu"):
        act = "gelu" if cfg.activation == "geglu" else "silu"
        h = common.activation(act)(
            torch.einsum("recd,edf->recf", dispatch, w("gate"))) * up
    else:
        h = common.activation(cfg.activation)(up)
    out = torch.einsum("recf,efd->recd", h, w("down"))

    out = torch.cat([out, out.new_zeros((r, 1, cap, d))], dim=1)
    gathered = out[r_idx, local_e, slot]                   # (R, N, d)
    gathered = gathered * (gates.reshape(r, tok * k)[..., None].to(dtype)
                           * keep[..., None].to(dtype))
    return gathered.reshape(r, tok, k, d).sum(dim=2)


def expert_axis(rules) -> Optional[str]:
    """The mesh axis the expert-parallel MoE splits its experts over: the
    first mesh axis of the rules' ``experts`` entry (None: no split)."""
    ax = rules.table.get("experts")
    if isinstance(ax, tuple):
        return ax[0] if ax else None
    return ax


def expert_shards(rules) -> int:
    """n of the expert-parallel MoE: the size of its expert axis, so a
    rank holds E / n experts (1 without an expert axis)."""
    ax = expert_axis(rules)
    return rules.mesh.shape[ax] if ax else 1


def _local_experts(leaf: torch.Tensor, e_base: int, e_local: int,
                   num_experts: int) -> torch.Tensor:
    """A rank's experts of an expert leaf (E, ...): the slice on its
    ``experts`` axis, or the leaf itself where the rank already holds only
    its slice (e_local, ...), as ``Rules.placements`` assigns it."""
    if leaf.shape[0] == e_local:
        return leaf
    if leaf.shape[0] == num_experts:
        return leaf[e_base:e_base + e_local]
    raise ValueError(f"an expert leaf of shape {tuple(leaf.shape)} is "
                     f"neither all {num_experts} experts nor a rank's "
                     f"{e_local}")


def _apply_moe_shard_map(params, x: torch.Tensor, cfg: ArchConfig, rules
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE on this rank: experts split over the mesh's
    ``experts`` axis (``rules.table["experts"]``, its first mesh axis),
    tokens over its ``batch`` axis. ``x`` is this rank's batch shard
    (B_local, T, d); the result is its (B_local, T, d) and the aux loss
    averaged over the batch axis. The mesh's process group must be up
    (``Mesh.device_mesh``), except on ``meta`` tensors, where the route
    counts one expert rank's work (coordinate 0, no collective), and on a
    mesh of one device, where no collective is needed."""
    import torch.distributed as dist

    m = cfg.moe
    mesh = rules.mesh
    expert_ax = expert_axis(rules)
    batch_ax = rules.table.get("batch")
    n = expert_shards(rules)
    b, t, d = x.shape
    decode = t == 1
    names = ("up", "down", "gate") if "gate" in params else ("up", "down")
    if torch.is_grad_enabled() and (x.requires_grad or any(
            params[k]["kernel"].requires_grad
            for k in names + ("router",))):
        raise NotImplementedError(
            "the expert-parallel MoE (dispatch_impl 'shard_map_a2a') is "
            "forward only: its backward is not ported yet (ROADMAP.md, "
            "Queue 1 item 15E: the all-reduce pair around the shard and "
            "the router's gradient summed over the expert axis); run it "
            "under torch.no_grad(), or train with 'dense_einsum'")
    dm = mesh.group_mesh() if hasattr(mesh, "group_mesh") else None
    if dm is None and x.device.type != "meta" and \
            n * _shards(mesh, batch_ax) > 1:
        raise RuntimeError(
            f"the expert-parallel MoE on a {dict(mesh.shape)} mesh runs "
            f"over its process group: bring it up and build the mesh's "
            f"DeviceMesh (Mesh.device_mesh) first")
    coord = dm.get_local_rank(expert_ax) if dm is not None and expert_ax \
        else 0
    e_local = m.num_experts // n
    e_base = coord * e_local
    local_w = {k: _local_experts(params[k]["kernel"], e_base, e_local,
                                 m.num_experts) for k in names}
    xr = x.reshape(1, -1, d) if decode else x
    tok = xr.shape[1]
    gates, idx, aux = route(params, xr, cfg)
    cap = _capacity(tok, cfg) * (2 if decode else 1)
    y = _dispatch_compute_combine(local_w, xr, gates, idx, cap, cfg,
                                  e_base, e_local)
    if dm is not None and n > 1:
        # the reference's psum over the expert axis, summed in f32
        total = y.to(torch.float32)
        dist.all_reduce(total, group=dm.get_group(expert_ax))
        y = total.to(y.dtype)
    if decode:
        y = y.reshape(b, 1, d)
    aux = aux.to(torch.float32)
    axes = () if batch_ax is None else (
        (batch_ax,) if isinstance(batch_ax, str) else batch_ax)
    for a in axes:
        if dm is not None and mesh.shape[a] > 1:
            aux = aux.clone()
            dist.all_reduce(aux, group=dm.get_group(a))
            aux = aux / mesh.shape[a]
    return y, aux


def rank_expert_keep(rules, coord: int):
    """``common.init_params``' ``keep`` hook for the rank at ``coord`` on
    the rules' ``experts`` axis: each expert FFN leaf (``up``, ``gate``,
    ``down``) is cut to the rank's slice of the dimension
    ``Rules.placements`` shards on that axis, as soon as it is drawn;
    every other leaf (the router included, replicated in the reference's
    ``shard_map``) is kept whole."""
    ax = expert_axis(rules)

    def keep(path, spec, leaf):
        if ax is None or len(path) < 2 or \
                path[-2] not in ("up", "gate", "down") or \
                "experts" not in spec.logical:
            return leaf
        place = rules.placements(spec.logical, spec.shape)[
            rules.mesh.axis_names.index(ax)]
        if not place.is_shard():
            return leaf
        size = spec.shape[place.dim] // expert_shards(rules)
        return leaf.narrow(place.dim, coord * size, size).clone()
    return keep


def _shards(mesh, ax) -> int:
    if ax is None:
        return 1
    axes = (ax,) if isinstance(ax, str) else ax
    out = 1
    for a in axes:
        out *= mesh.shape[a]
    return out

"""Decoder stacks (``repro.models.transformer``): block kinds, the
groups they are stacked in, and the enc-dec and VLM wiring.

A *block* is a temporal mixer + (optionally) an FFN with pre-norms:
  attn       full causal self-attention + MLP
  local      sliding-window self-attention + MLP
  recurrent  RG-LRU + MLP (recurrentgemma)
  ssm        Mamba-2 SSD (no separate FFN; d_ff = 0)
  moe        full causal self-attention + MoE FFN
  cross      cross-attention (VLM image layers) + MLP
  enc_dec    self-attn + cross-attn + MLP (whisper decoder)
  enc        bidirectional self-attention + MLP (whisper encoder)

Layers are grouped into the minimal repeating pattern, and each leaf of
the group's params and caches carries a leading group axis, as the JAX
package stacks them for ``lax.scan``; what the pattern leaves over (the
hybrid's 26 layers are 8 groups of three and 2 more) are unrolled
``tail<i>`` blocks of their own. ``apply_stack`` walks the groups in a
Python loop over each group's params and caches (views, no copies), then
the tail. The params are split into their groups once, by ``unbind``,
whose backward stacks the groups' gradients in one pass; indexing each
group (``a[gi]``) would give each group's gradient its own zero-filled
copy of the whole stacked leaf, L fills and L adds of it in all. Three modes, as in JAX: ``train`` (the whole trajectory,
with a gradient, no caches), ``prefill`` (the whole context, building
the caches) and ``decode`` (one step against them).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import mlp as mlp_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.common import Spec, make_norm
from repro_torch.params import tree_map

Tree = Any

KINDS = ("attn", "local", "recurrent", "ssm", "moe", "cross", "enc_dec",
         "enc")
CROSS_KINDS = ("cross", "enc_dec")       # the kinds with a cross_kv cache


def layer_plan(cfg: ArchConfig) -> Tuple[List[str], List[str]]:
    """(scanned group kinds, unrolled leftover kinds)."""
    fam = cfg.family
    if fam == "dense":
        return ["local" if cfg.sliding_window else "attn"], []
    if fam == "moe":
        return ["moe"], []
    if fam == "ssm":
        return ["ssm"], []
    if fam == "hybrid":
        pattern = ["recurrent" if p == "recurrent" else "local"
                   for p in cfg.rglru.pattern]
        n_groups = cfg.num_layers // len(pattern)
        leftover = cfg.num_layers - n_groups * len(pattern)
        return pattern, pattern[:leftover]
    if fam == "vlm":
        k = cfg.cross_attn_every
        if k < 1 or cfg.num_layers % k:
            raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not "
                             f"groups of cross_attn_every = {k}")
        return ["attn"] * (k - 1) + ["cross"], []
    if fam == "audio":
        return ["enc_dec"], []
    raise ValueError(f"family {fam!r}")


def num_groups(cfg: ArchConfig) -> int:
    group, leftover = layer_plan(cfg)
    return (cfg.num_layers - len(leftover)) // len(group)


def block_specs(cfg: ArchConfig, kind: str) -> Dict:
    norm_specs, _ = make_norm(cfg.norm, cfg.d_model)
    if kind == "ssm":
        return {"norm1": norm_specs, "ssm": ssm_lib.ssm_specs(cfg)}
    if kind in ("attn", "local", "enc", "moe"):
        mixer = {"attn": attn_lib.attention_specs(cfg)}
    elif kind == "recurrent":
        mixer = {"rglru": rglru_lib.rglru_specs(cfg)}
    elif kind == "cross":
        mixer = {"xattn": attn_lib.attention_specs(cfg, cross=True)}
    elif kind == "enc_dec":
        mixer = {"attn": attn_lib.attention_specs(cfg), "normx": norm_specs,
                 "xattn": attn_lib.attention_specs(cfg, cross=True)}
    else:
        raise ValueError(f"block kind {kind!r}")
    ffn = (moe_lib.moe_specs(cfg) if kind == "moe"
           else mlp_lib.mlp_specs(cfg))
    return {"norm1": norm_specs, **mixer, "norm2": norm_specs, "ffn": ffn}


def _cross_attention(params, h, positions, cfg: ArchConfig, mode: str,
                     cache: Optional[Tree], cross_ctx, impl: str):
    """(y, cache of the cross-attention). A decode step whose cache holds
    ``cross_kv`` attends to it (K5), as in JAX; otherwise the step
    attends to ``cross_ctx`` (K4), and prefill keeps the projected keys
    and values as ``cross_kv``."""
    if mode == "decode" and cache is not None and "cross_kv" in cache:
        y = attn_lib.apply_cross_attention_cached(params, h,
                                                  cache["cross_kv"], cfg,
                                                  impl)
        return y, {"cross_kv": cache["cross_kv"]}
    if cross_ctx is None:
        raise ValueError("cross-attention needs cross_ctx (the stub "
                         "frontend's embeddings) or a decode cache holding "
                         "cross_kv")
    y, kv = attn_lib.apply_attention(params, h, positions, cfg,
                                     kv_x=cross_ctx, mode=mode, impl=impl)
    return y, ({"cross_kv": kv} if mode == "prefill" else {})


def apply_block(params, x: torch.Tensor, positions: torch.Tensor,
                cfg: ArchConfig, kind: str, *, mode: str,
                cache: Optional[Tree],
                cross_ctx: Optional[torch.Tensor] = None,
                impl: str = "auto"):
    """Returns (x, new_cache, aux). ``cache`` is ``{"kv": {...}, "index":
    i}`` (attention; ``enc_dec`` adds ``"cross_kv"``), ``{"cross_kv":
    {...}}``, ``{"rglru": {...}}`` or ``{"ssm": {...}}`` in decode and None
    in prefill and train (whose new cache is of no use: ``apply_stack``
    drops it). ``aux`` is the MoE router's load-balancing loss, and None
    for the other kinds (where the JAX function returns a zero)."""
    if kind not in KINDS:
        raise ValueError(f"block kind {kind!r}")
    _, norm = make_norm(cfg.norm, cfg.d_model)
    h = norm(params["norm1"], x)
    if kind == "ssm":
        y, st = ssm_lib.apply_ssm(
            params["ssm"], h, cfg, mode=mode,
            state=None if cache is None else cache.get("ssm"), impl=impl)
        return x + y, {"ssm": st}, None
    if kind == "recurrent":
        y, st = rglru_lib.apply_rglru(
            params["rglru"], h, cfg, mode=mode,
            state=None if cache is None else cache.get("rglru"), impl=impl)
        new_cache = {"rglru": st}
    elif kind == "cross":
        y, new_cache = _cross_attention(params["xattn"], h, positions, cfg,
                                        mode, cache, cross_ctx, impl)
    else:
        window = cfg.sliding_window if kind == "local" else 0
        if kind == "local" and cfg.rglru is not None:
            window = cfg.rglru.attention_window
        y, kv = attn_lib.apply_attention(
            params["attn"], h, positions, cfg, causal=(kind != "enc"),
            window=window, mode=mode,
            cache=None if cache is None else cache.get("kv"),
            cache_index=None if cache is None else cache.get("index"),
            impl=impl)
        new_cache = {"kv": kv}
        if kind == "enc_dec":
            x = x + y
            h = norm(params["normx"], x)
            y, cross_cache = _cross_attention(params["xattn"], h, positions,
                                              cfg, mode, cache, cross_ctx,
                                              impl)
            new_cache.update(cross_cache)
    x = x + y
    h = norm(params["norm2"], x)
    aux = None
    if kind == "moe":
        y, aux = moe_lib.apply_moe(params["ffn"], h, cfg)
    else:
        y = mlp_lib.apply_mlp(params["ffn"], h, cfg)
    return x + y, new_cache, aux


def stack_specs(specs: Tree, n: int) -> Tree:
    return tree_map(lambda s: Spec((n,) + s.shape, init=s.init,
                                   scale=s.scale), specs)


def group_specs(cfg: ArchConfig) -> Dict:
    """The stacked group, then one ``tail<i>`` block per leftover layer."""
    group, leftover = layer_plan(cfg)
    one_group = {f"l{i}": block_specs(cfg, k) for i, k in enumerate(group)}
    specs = {"scan": stack_specs(one_group, num_groups(cfg))}
    for i, k in enumerate(leftover):
        specs[f"tail{i}"] = block_specs(cfg, k)
    return specs


def apply_stack(params, x: torch.Tensor, positions: torch.Tensor,
                cfg: ArchConfig, *, mode: str, caches: Optional[Tree] = None,
                cache_index: Optional[int] = None,
                cross_ctx: Optional[torch.Tensor] = None,
                impl: str = "auto"):
    """Run the full layer stack; returns (x, caches, total_aux).

    caches: ``{'scan': per-group caches stacked on a leading group axis,
    'tail<i>': the leftover layers' own}``. Prefill builds them (stacking
    each group's); decode writes each layer's new key and value, or its
    new recurrent, SSM and conv states, into ``caches`` in place and
    returns it. ``cross_ctx`` (B, S, d) is what the cross-attention layers
    attend to: the encoder's output or the image embeddings. total_aux is
    the sum of the MoE layers' aux losses, a float32 scalar (0 without
    MoE layers). ``mode='train'`` returns no caches (None)."""
    group, leftover = layer_plan(cfg)
    per_group, auxes = [], []
    groups = tree_map(torch.unbind, params["scan"])
    for gi in range(num_groups(cfg)):
        p_g = tree_map(lambda a: a[gi], groups)
        c_g = None if caches is None else \
            tree_map(lambda a: a[gi], caches["scan"])
        new = {}
        for i, kind in enumerate(group):
            key = f"l{i}"
            ci = None if c_g is None else dict(c_g[key], index=cache_index)
            x, new[key], aux = apply_block(
                p_g[key], x, positions, cfg, kind, mode=mode, cache=ci,
                cross_ctx=cross_ctx, impl=impl)
            auxes += [] if aux is None else [aux]
        per_group.append(new)
    tails = {}
    for i, kind in enumerate(leftover):
        key = f"tail{i}"
        ci = None if caches is None else dict(caches[key], index=cache_index)
        x, tails[key], aux = apply_block(
            params[key], x, positions, cfg, kind, mode=mode, cache=ci,
            cross_ctx=cross_ctx, impl=impl)
        auxes += [] if aux is None else [aux]
    aux = (torch.stack(auxes).sum() if auxes else
           torch.zeros((), dtype=torch.float32, device=x.device))
    if mode == "decode":
        return x, caches, aux
    if mode == "train":
        return x, None, aux
    return x, {"scan": tree_map(lambda *xs: torch.stack(xs), *per_group),
               **tails}, aux


# ---------------------------------------------------------------------------
# Whisper-style encoder (bidirectional)


def encoder_specs(cfg: ArchConfig) -> Dict:
    return {"scan": stack_specs(block_specs(cfg, "enc"), cfg.encoder_layers)}


def apply_encoder(params, embeds: torch.Tensor, cfg: ArchConfig,
                  impl: str = "auto", mode: str = "prefill") -> torch.Tensor:
    """embeds: (B, T_enc, d), the stub frontend's output. Each layer is an
    ``enc`` block over the whole sequence. Serving runs it in the prefill
    mode (K4, ``causal=False``), whose cache is dropped: JAX runs it in
    its train mode, which computes the same function. ``mode='train'``
    is that train mode, with a gradient (the dense path, every key
    valid). No final norm."""
    b, t, _ = embeds.shape
    positions = torch.arange(t, device=embeds.device).expand(b, t)
    x = embeds
    layers = tree_map(torch.unbind, params["scan"])
    for gi in range(cfg.encoder_layers):
        p = tree_map(lambda a: a[gi], layers)
        x, _, _ = apply_block(p, x, positions, cfg, "enc", mode=mode,
                              cache=None, impl=impl)
    return x

"""Decoder stacks (``repro.models.transformer``) for the ``attn``,
``local``, ``recurrent`` and ``ssm`` block kinds: pre-norm self-attention
+ MLP, full or within a sliding window; the pre-norm RG-LRU + MLP
(recurrentgemma); and the pre-norm Mamba-2 SSD block (no FFN).

Layers are grouped into the minimal repeating pattern, and each leaf of
the group's params and caches carries a leading group axis, as the JAX
package stacks them for ``lax.scan``; what the pattern leaves over (the
hybrid's 26 layers are 8 groups of three and 2 more) are unrolled
``tail<i>`` blocks of their own. ``apply_stack`` walks the groups in a
Python loop, indexing each group's params and caches (views, no copies),
then the tail. The other block kinds (moe, cross, enc_dec) raise and name
the roadmap item that ports them.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import mlp as mlp_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.common import Spec, make_norm
from repro_torch.params import tree_map

Tree = Any

NOT_PORTED = ("not ported yet (ROADMAP.md, Queue 1 item 14: MoE, "
              "cross-attention and enc-dec blocks)")
KINDS = ("attn", "local", "recurrent", "ssm")


def layer_plan(cfg: ArchConfig) -> Tuple[List[str], List[str]]:
    """(scanned group kinds, unrolled leftover kinds)."""
    if cfg.family == "dense":
        return ["local" if cfg.sliding_window else "attn"], []
    if cfg.family == "ssm":
        return ["ssm"], []
    if cfg.family == "hybrid":
        pattern = ["recurrent" if p == "recurrent" else "local"
                   for p in cfg.rglru.pattern]
        n_groups = cfg.num_layers // len(pattern)
        leftover = cfg.num_layers - n_groups * len(pattern)
        return pattern, pattern[:leftover]
    raise NotImplementedError(f"family {cfg.family!r}: {NOT_PORTED}")


def num_groups(cfg: ArchConfig) -> int:
    group, leftover = layer_plan(cfg)
    return (cfg.num_layers - len(leftover)) // len(group)


def block_specs(cfg: ArchConfig, kind: str) -> Dict:
    if kind not in KINDS:
        raise NotImplementedError(f"block kind {kind!r}: {NOT_PORTED}")
    norm_specs, _ = make_norm(cfg.norm, cfg.d_model)
    if kind == "ssm":
        return {"norm1": norm_specs, "ssm": ssm_lib.ssm_specs(cfg)}
    mixer = ({"rglru": rglru_lib.rglru_specs(cfg)} if kind == "recurrent"
             else {"attn": attn_lib.attention_specs(cfg)})
    return {"norm1": norm_specs, **mixer, "norm2": norm_specs,
            "ffn": mlp_lib.mlp_specs(cfg)}


def apply_block(params, x: torch.Tensor, positions: torch.Tensor,
                cfg: ArchConfig, kind: str, *, mode: str,
                cache: Optional[Tree], impl: str = "auto"):
    """Returns (x, new_cache). ``cache`` is ``{"kv": {...}, "index": i}``
    (attention), ``{"rglru": {...}}`` or ``{"ssm": {...}}`` in decode and
    None in prefill. (The JAX function also returns an aux loss, always 0 for
    these kinds.)"""
    if kind not in KINDS:
        raise NotImplementedError(f"block kind {kind!r}: {NOT_PORTED}")
    _, norm = make_norm(cfg.norm, cfg.d_model)
    h = norm(params["norm1"], x)
    if kind == "ssm":
        y, st = ssm_lib.apply_ssm(
            params["ssm"], h, cfg, mode=mode,
            state=None if cache is None else cache.get("ssm"), impl=impl)
        return x + y, {"ssm": st}
    if kind == "recurrent":
        y, st = rglru_lib.apply_rglru(
            params["rglru"], h, cfg, mode=mode,
            state=None if cache is None else cache.get("rglru"), impl=impl)
        new_cache = {"rglru": st}
    else:
        window = cfg.sliding_window if kind == "local" else 0
        if kind == "local" and cfg.rglru is not None:
            window = cfg.rglru.attention_window
        y, kv = attn_lib.apply_attention(
            params["attn"], h, positions, cfg, causal=True, window=window,
            mode=mode, cache=None if cache is None else cache.get("kv"),
            cache_index=None if cache is None else cache.get("index"),
            impl=impl)
        new_cache = {"kv": kv}
    x = x + y
    h = norm(params["norm2"], x)
    x = x + mlp_lib.apply_mlp(params["ffn"], h, cfg)
    return x, new_cache


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
                cache_index: Optional[int] = None, impl: str = "auto"):
    """Run the full layer stack; returns (x, caches).

    caches: ``{'scan': per-group caches stacked on a leading group axis,
    'tail<i>': the leftover layers' own}``. Prefill builds them (stacking
    each group's); decode writes each layer's new key and value, or its
    new recurrent, SSM and conv states, into ``caches`` in place and
    returns it."""
    group, leftover = layer_plan(cfg)
    per_group = []
    for gi in range(num_groups(cfg)):
        p_g = tree_map(lambda a: a[gi], params["scan"])
        c_g = None if caches is None else \
            tree_map(lambda a: a[gi], caches["scan"])
        new = {}
        for i, kind in enumerate(group):
            key = f"l{i}"
            ci = None if c_g is None else dict(c_g[key], index=cache_index)
            x, new[key] = apply_block(p_g[key], x, positions, cfg, kind,
                                      mode=mode, cache=ci, impl=impl)
        per_group.append(new)
    tails = {}
    for i, kind in enumerate(leftover):
        key = f"tail{i}"
        ci = None if caches is None else dict(caches[key], index=cache_index)
        x, tails[key] = apply_block(params[key], x, positions, cfg, kind,
                                    mode=mode, cache=ci, impl=impl)
    if mode == "decode":
        return x, caches
    return x, {"scan": tree_map(lambda *xs: torch.stack(xs), *per_group),
               **tails}

"""Attention (``repro.models.attention``, prefill and decode): GQA
self-attention with RoPE, sliding windows and a KV cache, and
cross-attention to an encoder's output or an image's patch embeddings.

Layouts, as the JAX package keeps them:
  activations  (B, T, d_model)
  q            (B, T, H, Dh)
  k/v          (B, T, K, Dh)          K = num_kv_heads, group G = H // K
  kv cache     (B, S_cache, K, Dh)    ring buffer under a sliding window

Prefill sends the attention itself through ``ops.flash_attention`` (K4 on
the card) and decode through ``ops.decode_attention`` (K5), with the
cache's validity mask as an additive bias. Both compute the masked
softmax the JAX dense path computes, over the same keys.
Cross-attention and the bidirectional encoder send their unmasked
softmax through K4 with ``causal=False``; a decode step's cross-attention
sends its one query through K5 against the cached encoder keys and
values, with an all-zero bias. The training mode waits for token
training (ROADMAP.md, Queue 1 item 14).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.common import dense, dense_specs, rope, torch_dtype

NEG_INF = -1e30


def attention_specs(cfg: ArchConfig, cross: bool = False) -> Dict:
    """q/k/v/o projections; ``cross`` changes nothing, as in JAX."""
    del cross
    d, h, k = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    dh = cfg.resolved_head_dim
    bias = cfg.qkv_bias
    return {
        "q": dense_specs((d,), (h, dh), bias=bias),
        "k": dense_specs((d,), (k, dh), bias=bias),
        "v": dense_specs((d,), (k, dh), bias=bias),
        "o": dense_specs((h, dh), (d,)),
    }


@dataclasses.dataclass(frozen=True)
class CacheSpec:
    """Static description of a layer's KV cache."""
    length: int          # S_cache (== window for sliding-window archs)
    kv_heads: int
    head_dim: int


def init_cache_arrays(batch: int, spec: CacheSpec, dtype,
                      device="cpu") -> Dict[str, torch.Tensor]:
    shape = (batch, spec.length, spec.kv_heads, spec.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_bias(cache_index: int, s_cache: int, window: int, batch: int,
                device) -> torch.Tensor:
    """The (B, S_cache) float32 bias of the slots a decode step at absolute
    position ``cache_index`` may attend to: 0 where valid, NEG_INF where
    not. Without a window slot i holds position i; under a window the cache
    is a ring buffer and slot i holds ``idx - ((idx - i) mod S)``."""
    slots = torch.arange(s_cache, device=device)
    if window:
        kv_pos = cache_index - torch.remainder(cache_index - slots, s_cache)
        valid = kv_pos >= max(cache_index - s_cache + 1, 0)
        valid &= kv_pos > cache_index - window
    else:
        valid = slots <= cache_index
    bias = torch.where(valid, 0.0, NEG_INF).to(torch.float32)
    return bias.expand(batch, s_cache).contiguous()


def apply_attention(params, x: torch.Tensor, positions: torch.Tensor,
                    cfg: ArchConfig, *, causal: bool = True, window: int = 0,
                    mode: str = "prefill",
                    cache: Optional[Dict[str, torch.Tensor]] = None,
                    cache_index: Optional[int] = None,
                    kv_x: Optional[torch.Tensor] = None,
                    kv_positions: Optional[torch.Tensor] = None,
                    use_rope: Optional[bool] = None,
                    impl: str = "auto",
                    ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Self- or cross-attention; returns (output (B, T, d_model), cache).

    ``mode='prefill'``: x is the whole context and ``positions`` is
    ``arange(T)`` per row (what ``apply_prefill`` passes, and what K4's
    masks assume). The cache returned holds the last ``min(window, T)``
    (or all T) keys and values.

    ``mode='decode'``: x is one step (B, 1, d) at absolute position
    ``cache_index`` (a host int). Its key and value are written into
    ``cache`` IN PLACE, in the slot the JAX package picks: ``index mod S``
    under a window (a ring buffer), else ``min(index, S - 1)``; the JAX
    function returns a new cache instead. The returned cache is ``cache``.

    ``kv_x`` (B, S, d) makes it cross-attention, in either mode: no RoPE
    on q, keys and values projected from ``kv_x``, no mask. The cache
    returned is those projected keys and values
    (``precompute_cross_cache``'s), where the JAX function returns None
    and its block projects them a second time; the values are the same.
    ``kv_positions`` is accepted and unused, as in JAX. ``use_rope``
    overrides ``cfg.use_rope``.

    ``impl`` goes to ``ops``: 'auto' (the kernels on the card, the plain
    versions on the CPU), 'pallas' or 'ref'."""
    del kv_positions
    if mode not in ("prefill", "decode"):
        raise ValueError(f"mode {mode!r}: the port serves ('prefill', "
                         f"'decode'); token training is not ported yet "
                         f"(ROADMAP.md, Queue 1 item 14)")
    dtype = torch_dtype(cfg.dtype)
    use_rope = cfg.use_rope if use_rope is None else use_rope
    q = dense(params["q"], x, dtype=dtype)
    if kv_x is not None:
        new_cache = precompute_cross_cache(params, kv_x, cfg)
        out = ops.flash_attention(q, new_cache["k"], new_cache["v"], False,
                                  0, impl=impl)
        return dense(params["o"], out, contract=2, dtype=dtype), new_cache

    k = dense(params["k"], x, dtype=dtype)
    v = dense(params["v"], x, dtype=dtype)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    if mode == "decode":
        if cache is None or cache_index is None:
            raise ValueError("decode needs a cache and a cache_index")
        kc, vc = cache["k"], cache["v"]
        s_cache = kc.shape[1]
        index = int(cache_index)
        slot = index % s_cache if window else min(index, s_cache - 1)
        kc[:, slot] = k[:, 0].to(kc.dtype)
        vc[:, slot] = v[:, 0].to(vc.dtype)
        bias = decode_bias(index, s_cache, window, x.shape[0], x.device)
        out = ops.decode_attention(q[:, 0], kc, vc, bias,
                                   impl=impl)[:, None]
        new_cache = cache
    else:
        t = x.shape[1]
        s_cache = min(window, t) if window else t
        new_cache = {"k": k[:, -s_cache:], "v": v[:, -s_cache:]}
        out = ops.flash_attention(q, k, v, causal, window, impl=impl)
    y = dense(params["o"], out, contract=2, dtype=dtype)
    return y, new_cache


def precompute_cross_cache(params, enc_out: torch.Tensor,
                           cfg: ArchConfig) -> Dict[str, torch.Tensor]:
    """Project the encoder output (or image embeddings) to k/v once, for
    decode-time cross-attention: each (B, S, K, Dh)."""
    dtype = torch_dtype(cfg.dtype)
    return {"k": dense(params["k"], enc_out, dtype=dtype),
            "v": dense(params["v"], enc_out, dtype=dtype)}


def apply_cross_attention_cached(params, x: torch.Tensor, cross_cache,
                                 cfg: ArchConfig, impl: str = "auto"
                                 ) -> torch.Tensor:
    """Decode-time cross-attention of one step x (B, 1, d) against the
    precomputed encoder k/v: its query goes through
    ``ops.decode_attention`` (K5 on the card) with an all-zero (B, S)
    bias, every key valid. Returns (B, 1, d_model)."""
    dtype = torch_dtype(cfg.dtype)
    q = dense(params["q"], x, dtype=dtype)
    if q.shape[1] != 1:
        raise ValueError(f"cached cross-attention takes one step; x has "
                         f"{q.shape[1]}")
    k, v = cross_cache["k"], cross_cache["v"]
    bias = torch.zeros(k.shape[:2], dtype=torch.float32, device=x.device)
    out = ops.decode_attention(q[:, 0], k, v, bias, impl=impl)[:, None]
    return dense(params["o"], out, contract=2, dtype=dtype)

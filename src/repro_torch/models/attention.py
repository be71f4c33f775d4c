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
values, with an all-zero bias.

The training mode (``mode='train'``) is the JAX package's own train
branch, plain PyTorch that autograd differentiates: the masked-dense
softmax (``_dense_attention``) up to ``DENSE_SEQ_THRESHOLD`` keys, the
chunked online softmax (``_chunked_causal_attention``) above it, and the
dense path with every key valid for cross-attention and the
bidirectional encoder. K4 and K5 have no backward, so training never
reaches them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.common import dense, dense_specs, rope, torch_dtype

NEG_INF = -1e30

# Dense (materialized-scores) attention is used up to this many kv positions
# in the training mode; beyond it the chunked online softmax keeps memory
# bounded
DENSE_SEQ_THRESHOLD = 4096
Q_CHUNK = 512
KV_CHUNK = 1024


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


def _dense_attention(q, k, v, mask, scale: float) -> torch.Tensor:
    """q (B,Tq,H,D), k/v (B,Tk,K,D), mask broadcastable to
    (B,K,G,Tq,Tk). The scores in q's dtype, then the softmax in float32,
    the probabilities cast back to q's dtype, as JAX computes them."""
    b, tq, h, d = q.shape
    kh = k.shape[2]
    qg = q.reshape(b, tq, kh, h // kh, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).to(torch.float32) \
        * scale
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(b, tq, h, d)


def _chunked_causal_attention(q, k, v, q_positions, kv_positions,
                              scale: float, window: int = 0,
                              q_chunk: int = Q_CHUNK,
                              kv_chunk: int = KV_CHUNK) -> torch.Tensor:
    """Online-softmax attention, O(q_chunk * kv_chunk) live scores;
    causal in the absolute positions, with an optional sliding window.
    q (B,Tq,H,D), k/v (B,Tk,K,D), positions (B,T*). Padded keys get
    position -1 and are never valid."""
    b, tq, h, d = q.shape
    tk, kh = k.shape[1], k.shape[2]
    g = h // kh
    q_chunk, kv_chunk = min(q_chunk, tq), min(kv_chunk, tk)

    def pad_to(x, mult, value=0):
        rem = (-x.shape[1]) % mult
        if not rem:
            return x
        shape = (x.shape[0], rem) + tuple(x.shape[2:])
        return torch.cat([x, x.new_full(shape, value)], dim=1)

    qp = pad_to(q, q_chunk)
    qpos = pad_to(q_positions, q_chunk)
    kp, vp = pad_to(k, kv_chunk), pad_to(v, kv_chunk)
    kpos = pad_to(kv_positions, kv_chunk, -1)
    nq, nk = qp.shape[1] // q_chunk, kp.shape[1] // kv_chunk
    qp = qp.reshape(b, nq, q_chunk, kh, g, d)
    kp = kp.reshape(b, nk, kv_chunk, kh, d)
    vp = vp.reshape(b, nk, kv_chunk, kh, d)
    qpos = qpos.reshape(b, nq, q_chunk)
    kpos = kpos.reshape(b, nk, kv_chunk)

    outs = []
    for qi in range(nq):
        qc, qcpos = qp[:, qi], qpos[:, qi]
        m = q.new_full((b, kh, g, q_chunk), NEG_INF, dtype=torch.float32)
        l = q.new_zeros((b, kh, g, q_chunk), dtype=torch.float32)
        acc = q.new_zeros((b, q_chunk, kh, g, d), dtype=torch.float32)
        for ki in range(nk):
            kc, vc, kcpos = kp[:, ki], vp[:, ki], kpos[:, ki]
            s = torch.einsum("bqkgd,bskd->bkgqs", qc, kc).to(torch.float32) \
                * scale
            kk = kcpos[:, None, None, None, :]
            qq = qcpos[:, None, None, :, None]
            valid = (kk <= qq) & (kk >= 0)
            if window:
                valid &= kk > qq - window
            s = torch.where(valid, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqs,bskd->bqkgd", p.to(qc.dtype), vc)
            acc = acc * torch.movedim(corr, 3, 1)[..., None] + pv
            m = m_new
        l = torch.clamp(l, min=1e-30)
        outs.append((acc / torch.movedim(l, 3, 1)[..., None]).to(q.dtype))
    out = torch.stack(outs, dim=1).reshape(b, nq * q_chunk, h, d)
    return out[:, :tq]


def _train_attention(q, k, v, positions, causal: bool,
                     window: int) -> torch.Tensor:
    """JAX's train branch over the whole sequence: dense up to
    DENSE_SEQ_THRESHOLD keys, else chunked (bidirectional stays dense)."""
    scale = q.shape[-1] ** -0.5
    t = q.shape[1]
    if t > DENSE_SEQ_THRESHOLD and causal:
        return _chunked_causal_attention(q, k, v, positions, positions,
                                         scale, window=window)
    if not causal:
        mask = torch.ones((1, 1, 1, t, t), dtype=torch.bool,
                          device=q.device)
    else:
        kpos = positions[:, None, None, None, :]
        qpos = positions[:, None, None, :, None]
        mask = kpos <= qpos
        if window:
            mask &= kpos > qpos - window
    return _dense_attention(q, k, v, mask, scale)


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

    ``mode='train'``: x is the whole trajectory, ``positions`` (B, T) its
    absolute positions; the attention is JAX's train branch
    (``_train_attention``), with a gradient, and no cache is returned
    (None). Cross-attention in train mode is the dense path with every
    key valid.

    ``impl`` goes to ``ops``: 'auto' (the kernels on the card, the plain
    versions on the CPU), 'pallas' or 'ref'."""
    del kv_positions
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode {mode!r}: expected 'train', 'prefill' or "
                         f"'decode'")
    dtype = torch_dtype(cfg.dtype)
    use_rope = cfg.use_rope if use_rope is None else use_rope
    q = dense(params["q"], x, dtype=dtype)
    if kv_x is not None:
        new_cache = precompute_cross_cache(params, kv_x, cfg)
        if mode == "train":
            ones = torch.ones((1, 1, 1, 1, 1), dtype=torch.bool,
                              device=x.device)
            out = _dense_attention(q, new_cache["k"], new_cache["v"], ones,
                                   cfg.resolved_head_dim ** -0.5)
            return dense(params["o"], out, contract=2, dtype=dtype), None
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
    elif mode == "train":
        out = _train_attention(q, k, v, positions, causal, window)
        new_cache = None
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

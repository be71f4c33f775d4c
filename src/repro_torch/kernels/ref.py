"""Plain-PyTorch oracles of the ported kernels (``repro.kernels.ref``):
V-trace (K1), the linear scan (K3), flash attention (K4) and decode
attention (K5).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def vtrace_ref(rho, c, discounts, rewards, values, values_tp1
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All inputs (T, B) float32 (time-major, matching the kernel layout).

    acc_s = delta_s + disc_s * c_s * acc_{s+1};  vs_s = v_s + acc_s
    pg_adv_s = rho_s * (r_s + disc_s * (v_tp1_s + acc_{s+1}) - v_s)
    Returns (vs, pg_adv), each (T, B).
    """
    t = rho.shape[0]
    acc = torch.zeros_like(rho[0])
    vs = [None] * t
    pg = [None] * t
    for s in reversed(range(t)):
        pg[s] = rho[s] * (rewards[s] + discounts[s] * (values_tp1[s] + acc)
                          - values[s])
        delta = rho[s] * (rewards[s] + discounts[s] * values_tp1[s]
                          - values[s])
        acc = delta + discounts[s] * c[s] * acc
        vs[s] = values[s] + acc
    return torch.stack(vs, dim=0), torch.stack(pg, dim=0)


def linear_scan_ref(a, b, h0: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Diagonal linear recurrence h_t = a_t * h_{t-1} + b_t.

    a, b: (T, N) float32; h0: (N,) or None (zeros). Returns h (T, N). Each
    step is a multiply and then an add, each rounded (no fused
    multiply-add), as the kernel rounds them."""
    h = torch.zeros_like(a[0]) if h0 is None else h0
    out = torch.empty_like(a)
    for t in range(a.shape[0]):
        h = a[t] * h + b[t]
        out[t] = h
    return out


def flash_attention_ref(q, k, v, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    """Full (masked-dense) GQA attention, softmax in float32.

    q: (B,T,H,D); k/v: (B,S,K,D), H % K == 0, positions 0.. on both
    sides. Returns (B,T,H,D) in q's dtype."""
    b, t, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    g = h // kh
    qg = q.reshape(b, t, kh, g, d).to(torch.float32)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg,
                          k.to(torch.float32)) * (d ** -0.5)
    qpos = torch.arange(t, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((t, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(torch.float32))
    return out.reshape(b, t, h, d).to(q.dtype)


def decode_attention_ref(q, k, v, bias) -> torch.Tensor:
    """One query token per sequence against a KV cache, softmax in f32.

    q: (B,H,D); k/v: (B,S,K,D); bias: (B,S) additive (0 or -1e30).
    Returns (B,H,D) in q's dtype."""
    b, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    qg = q.reshape(b, kh, g, d).to(torch.float32)
    scores = torch.einsum("bkgd,bskd->bkgs", qg,
                          k.to(torch.float32)) * (d ** -0.5)
    scores = scores + bias.to(torch.float32)[:, None, None, :]
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v.to(torch.float32))
    return out.reshape(b, h, d).to(q.dtype)

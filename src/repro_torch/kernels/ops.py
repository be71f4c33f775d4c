"""Dispatching wrappers over the ported kernels (``repro.kernels.ops``):
V-trace (K1), the linear scan (K3), flash attention (K4) and decode
attention (K5).

``impl='auto'`` picks the hand-written kernel for CUDA tensors, the
kernel route's ``meta`` outputs for meta tensors (the dry run traces
what the card runs, ``kernels.meta``) and the plain oracle for CPU
tensors. ``'pallas'`` keeps the reference's name for the kernel route: on
CUDA it launches the kernel; on the CPU the kernel's wrapper runs its
plain version. ``'ref'`` is the oracle on any device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import decode_attention as decode_k
from repro_torch.kernels import flash_attention as flash_k
from repro_torch.kernels import linear_scan as linear_scan_k
from repro_torch.kernels import ref
from repro_torch.kernels import vtrace as vtrace_k


def _resolve(impl: str, device: torch.device) -> str:
    if impl == "auto":
        return "pallas" if device.type in ("cuda", "meta") else "ref"
    return impl


def vtrace(log_rhos, discounts, rewards, values, bootstrap_value,
           rho_bar: Optional[float] = 1.0, c_bar: Optional[float] = 1.0,
           lambda_: float = 1.0, impl: str = "auto"
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch-major (B, T) inputs, like ``repro_torch.core.vtrace``.

    Returns (vs, pg_advantages) each (B, T) f32.
    """
    impl_r = _resolve(impl, log_rhos.device)
    rhos = torch.exp(log_rhos.to(torch.float32))
    rho = torch.clamp(rhos, max=rho_bar) if rho_bar is not None else rhos
    c = lambda_ * (torch.clamp(rhos, max=c_bar) if c_bar is not None
                   else rhos)
    v = values.to(torch.float32)
    vtp1 = torch.cat([v[:, 1:], bootstrap_value.to(torch.float32)[:, None]],
                     dim=1)
    args = tuple(x.t().contiguous()
                 for x in (rho, c, discounts.to(torch.float32),
                           rewards.to(torch.float32), v, vtp1))
    if impl_r == "ref":
        vs, pg = ref.vtrace_ref(*args)
    elif impl_r == "pallas":
        vs, pg = vtrace_k.vtrace(*args)
    else:
        raise ValueError(impl)
    return vs.t(), pg.t()


def linear_scan(a, b, h0: Optional[torch.Tensor] = None,
                impl: str = "auto") -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t. a, b: (T, N), cast to f32; h0: (N,) or
    None (zeros)."""
    impl_r = _resolve(impl, a.device)
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    h0 = None if h0 is None else h0.to(torch.float32)
    if impl_r == "ref":
        return ref.linear_scan_ref(a, b, h0)
    if impl_r == "pallas":
        return linear_scan_k.linear_scan(a, b, h0)
    raise ValueError(impl)


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    impl: str = "auto") -> torch.Tensor:
    """Prefill GQA attention. q (B,T,H,D), k/v (B,S,K,D)."""
    impl_r = _resolve(impl, q.device)
    if impl_r == "ref":
        return ref.flash_attention_ref(q, k, v, causal, window)
    if impl_r == "pallas":
        return flash_k.flash_attention(q, k, v, causal, window)
    raise ValueError(impl)


def decode_attention(q, k, v, bias, impl: str = "auto") -> torch.Tensor:
    """q (B,H,D), k/v (B,S,K,D), bias (B,S) additive. Returns (B,H,D)."""
    impl_r = _resolve(impl, q.device)
    if impl_r == "ref":
        return ref.decode_attention_ref(q, k, v, bias)
    if impl_r == "pallas":
        return decode_k.decode_attention(q, k, v, bias)
    raise ValueError(impl)

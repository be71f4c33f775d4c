"""The diagonal linear recurrence (K3, ``repro.kernels.linear_scan``),
ported to CUDA, with its gradient.

``linear_scan`` replaces ``linear_scan_pallas``: ``h_t = a_t * h_{t-1} +
b_t`` over time-major (T, N) float32 inputs, with an optional (N,) h0
(None means zeros); it returns h (T, N). It carries the Mamba-2 state
across chunks (``models/ssm.py``, ``ssd_chunked``) and the RG-LRU state
over time (``models/rglru.py``).

Where grad mode is on and an input requires grad, the wrapper goes
through ``LinearScanFn``, whose backward is the same recurrence on
reversed time. With g_t = dL/dh_t, the adjoint lambda_t = dL/dh_t in
total obeys lambda_{T-1} = g_{T-1} and lambda_t = g_t + a_{t+1}
lambda_{t+1}, that is lambda = flip(scan(flip(cat(a[1:], 0)), flip(g))).
Then db = lambda, da_t = lambda_t h_{t-1} (h_{-1} = h0, or 0) and dh0 =
a_0 lambda_0. The forward saves a, h and h0.

The kernel is CUDA C++ in ``repro_torch/csrc/linear_scan.cu`` (built by
``repro_torch.kernels.build``). The wrapper takes the plain PyTorch
version (``linear_scan_plain``, the oracle's loop) only because the
tensors it was given lie on the CPU, in both directions; on CUDA tensors
it launches the kernel or raises; on ``meta`` tensors it returns h as a
meta tensor and reports the kernel's cost (``kernels.meta``), with no
loop over T. ``linear_scan.launches`` counts the kernel's launches, the
backward's included, and nothing else;
``linear_scan.shapes`` is the set of (T, N, with h0) the forward launched
at and (T, N, False, "bwd") the backward's, which ``reset_launch_counts``
leaves as it is.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, meta
from repro_torch.kernels.ref import linear_scan_ref

# K3's plain version is the oracle itself: the same loop over T
linear_scan_plain = linear_scan_ref


def _scan(a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor],
          tag: str = "") -> torch.Tensor:
    """One pass of the recurrence with no graph, on checked inputs (every
    launch, the backward's too): the kernel on the card (its launch
    counted, under ``tag`` in ``shapes``), the plain loop on the CPU."""
    t, n = a.shape
    build.check_f32("a", a, (t, n), a.device)
    build.check_f32("b", b, (t, n), a.device)
    if h0 is not None:
        build.check_f32("h0", h0, (n,), a.device)
    if a.device.type == "meta":
        h = torch.empty((t, n), device="meta")
        meta.report(0, (a, b, h0), (h,))
        return h
    if not build.on_cuda(a.device, "linear scan"):
        with torch.no_grad():
            return linear_scan_plain(a, b, h0)
    h = torch.empty_like(a)
    code = build.call_on(
        a.device, build.load().repro_linear_scan,
        a.data_ptr(), b.data_ptr(), None if h0 is None else h0.data_ptr(),
        h.data_ptr(), t, n, build.stream(a.device))
    build.raise_on(code, "repro_linear_scan")
    linear_scan.launches += 1
    linear_scan.shapes.add((t, n, h0 is not None) + ((tag,) if tag else ()))
    return h


class LinearScanFn(torch.autograd.Function):
    """K3 forward, and K3 again on reversed time for the gradient."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h = _scan(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h, h0 = ctx.saved_tensors
        a_next = torch.cat([a[1:], torch.zeros_like(a[:1])]).flip(0)
        lam = _scan(a_next.contiguous(), g.flip(0).contiguous(), None,
                    "bwd").flip(0)
        first = torch.zeros_like(a[:1]) if h0 is None else h0[None]
        da = lam * torch.cat([first, h[:-1]])
        dh0 = None if h0 is None else a[0] * lam[0]
        return da, lam, dh0


def linear_scan(a: torch.Tensor, b: torch.Tensor,
                h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """a, b (T, N) float32, h0 (N,) float32 or None; contiguous, on one
    device. Returns h (T, N), with a gradient where an input needs one."""
    if a.dim() != 2 or a.shape[0] < 1 or a.shape[1] < 1:
        raise ValueError(f"linear_scan: a must be a non-empty (T, N), got "
                         f"{tuple(a.shape)}")
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in (a, b, h0)):
        return LinearScanFn.apply(a, b, h0)
    return _scan(a, b, h0)


linear_scan.launches = 0
linear_scan.shapes = set()


def reset_launch_counts() -> None:
    linear_scan.launches = 0

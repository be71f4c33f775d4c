"""The diagonal linear recurrence (K3, ``repro.kernels.linear_scan``),
ported to CUDA.

``linear_scan`` replaces ``linear_scan_pallas``: ``h_t = a_t * h_{t-1} +
b_t`` over time-major (T, N) float32 inputs, with an optional (N,) h0
(None means zeros); it returns h (T, N). On the serving path it carries
the Mamba-2 state across chunks (``models/ssm.py``, ``ssd_chunked``).

The kernel is CUDA C++ in ``repro_torch/csrc/linear_scan.cu`` (built by
``repro_torch.kernels.build``). The wrapper takes the plain PyTorch
version (``linear_scan_plain``, the oracle's loop) only because the
tensors it was given lie on the CPU; on CUDA tensors it launches the
kernel or raises. ``linear_scan.launches`` counts the kernel's launches,
and nothing else; ``linear_scan.shapes`` is the set of (T, N, with h0)
it launched at, which ``reset_launch_counts`` leaves as it is.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import linear_scan_ref

# K3's plain version is the oracle itself: the same loop over T
linear_scan_plain = linear_scan_ref


def linear_scan(a: torch.Tensor, b: torch.Tensor,
                h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """a, b (T, N) float32, h0 (N,) float32 or None; contiguous, on one
    device. Returns h (T, N)."""
    if a.dim() != 2 or a.shape[0] < 1 or a.shape[1] < 1:
        raise ValueError(f"linear_scan: a must be a non-empty (T, N), got "
                         f"{tuple(a.shape)}")
    t, n = a.shape
    build.check_f32("a", a, (t, n), a.device)
    build.check_f32("b", b, (t, n), a.device)
    if h0 is not None:
        build.check_f32("h0", h0, (n,), a.device)
    if not build.on_cuda(a.device, "linear scan"):
        return linear_scan_plain(a, b, h0)
    h = torch.empty_like(a)
    code = build.call_on(
        a.device, build.load().repro_linear_scan,
        a.data_ptr(), b.data_ptr(), None if h0 is None else h0.data_ptr(),
        h.data_ptr(), t, n, build.stream(a.device))
    build.raise_on(code, "repro_linear_scan")
    linear_scan.launches += 1
    linear_scan.shapes.add((t, n, h0 is not None))
    return h


linear_scan.launches = 0
linear_scan.shapes = set()


def reset_launch_counts() -> None:
    linear_scan.launches = 0

"""Flash attention forward (K4, ``repro.kernels.flash_attention``), ported
to CUDA.

``flash_attention`` replaces ``flash_attention_pallas``: GQA attention of
q (B, T, H, D) over k/v (B, S, K, D), causal or not, with an optional
sliding window, positions counted from 0 on both sides; softmax online in
float32; the output in q's dtype. The kernel is CUDA C++ in
``repro_torch/csrc/flash_attention.cu`` (built by
``repro_torch.kernels.build``). The wrapper takes the plain PyTorch
version (``flash_attention_plain``, the masked-dense oracle) only because
the tensors it was given lie on the CPU; on CUDA tensors it launches the
kernel or raises. ``flash_attention.launches`` counts the kernel's
launches, and nothing else; ``flash_attention.shapes`` is the set of
(B, T, S, H, K, D, causal, window, dtype) it launched at, which
``reset_launch_counts`` leaves as it is. The kernel has no backward: the
wrapper raises, on every device, where grad mode is on and q, k or v
requires grad (``refuse_grad``), so that no route cuts a graph on the
card that its plain version keeps on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref

# K4's plain version is the oracle itself: masked-dense softmax in f32
flash_attention_plain = flash_attention_ref

DTYPES = (torch.bfloat16, torch.float32)
HEAD_DIMS = (32, 64, 128, 256)      # the kernel's instantiations


def check_attention_inputs(name: str, q, k, v, q_dims: int) -> None:
    """Shared checks of K4 and K5: q has ``q_dims`` dims with the head dim
    last, k and v are (B, S, K, D) with H % K == 0, one dtype (bf16 or
    f32), one device, contiguous."""
    if q.dim() != q_dims or k.dim() != 4 or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: expected q with {q_dims} "
                         f"dims and k, v of one (B, S, K, D) shape")
    b, h, d = q.shape[0], q.shape[-2], q.shape[-1]
    kb, s, kh, kd = k.shape
    if kb != b or kd != d or kh < 1 or h % kh or min(q.shape) < 1 or s < 1:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree (batch, head dim, "
                         f"H % K == 0) or are empty")
    for tname, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype not in DTYPES or x.dtype != q.dtype:
            raise TypeError(f"{name}: {tname} is {x.dtype}; expected q, k "
                            f"and v all bfloat16 or all float32")
        if x.device != q.device:
            raise ValueError(f"{name}: {tname} on {x.device}, q on "
                             f"{q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")


def refuse_grad(name: str, *tensors) -> None:
    """Raise where autograd would need a backward of the kernel: grad mode
    on and an input requiring grad. The kernels write their output through
    a raw pointer, which a graph cannot see through."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in tensors):
        raise RuntimeError(
            f"{name}: the kernel has no backward, and an input requires "
            f"grad; run it under torch.no_grad(), or train through the "
            f"models' plain attention (mode='train')")


def check_kernel_layout(name: str, tensors, d: int) -> None:
    """What only the CUDA kernel needs: an instantiated head dim, and
    16-byte aligned rows (it reads 16 bytes a thread)."""
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {HEAD_DIMS}")
    for x in tensors:
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")


def flash_attention(q, k, v, causal: bool = True,
                    window: int = 0) -> torch.Tensor:
    """q (B, T, H, D), k/v (B, S, K, D); ``window`` 0 means none.
    Returns (B, T, H, D) in q's dtype."""
    check_attention_inputs("flash_attention", q, k, v, 4)
    refuse_grad("flash_attention", q, k, v)
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    if not build.on_cuda(q.device, "flash attention"):
        return flash_attention_plain(q, k, v, causal, window)
    b, t, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    check_kernel_layout("flash_attention", (q, k, v, out), d)
    code = build.call_on(
        q.device, build.load().repro_flash_attention,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, t, s, h, kh, d, int(bool(causal)), int(window), d ** -0.5,
        int(q.dtype == torch.bfloat16), build.stream(q.device))
    build.raise_on(code, "repro_flash_attention")
    flash_attention.launches += 1
    flash_attention.shapes.add((b, t, s, h, kh, d, bool(causal), int(window),
                                q.dtype))
    return out


flash_attention.launches = 0
flash_attention.shapes = set()


def reset_launch_counts() -> None:
    flash_attention.launches = 0

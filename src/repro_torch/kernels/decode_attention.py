"""Decode attention (K5, ``repro.kernels.decode_attention``), ported to
CUDA.

``decode_attention`` replaces ``decode_attention_pallas``: one query token
per sequence, q (B, H, D), against a KV cache k/v (B, S, K, D), with an
additive float32 bias (B, S) (0 valid, -1e30 masked); softmax online in
float32; the output in q's dtype. The kernel is CUDA C++ in
``repro_torch/csrc/decode_attention.cu`` (built by
``repro_torch.kernels.build``). The wrapper takes the plain PyTorch
version (``decode_attention_plain``, the dense oracle) only because the
tensors it was given lie on the CPU; on CUDA tensors it launches the
kernel or raises; on ``meta`` tensors it returns the output as a meta
tensor and reports the kernel's cost (``kernels.meta``).
``decode_attention.launches`` counts the kernel's launches, and nothing
else; ``decode_attention.shapes`` is the set of
(B, H, K, S, D, dtype) it launched at, which ``reset_launch_counts``
leaves as it is. Like K4 it has no backward, and raises on inputs that
require grad while grad mode is on (``refuse_grad``).
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.kernels import build, meta
from repro_torch.kernels.flash_attention import (check_attention_inputs,
                                                 check_kernel_layout,
                                                 refuse_grad)
from repro_torch.kernels.ref import decode_attention_ref

# K5's plain version is the oracle itself: dense softmax in f32
decode_attention_plain = decode_attention_ref

MAX_GROUP = 16      # query heads per kv head the kernel serves
CHUNK = 64          # a split's keys are a multiple of this (of any tile)
MIN_SPLIT = 512     # the fewest keys worth a block of their own
WARPS = 8           # warps a block; warp w owns tiles w, w + 8, ... of S


def tile_keys(d: int, itemsize: int) -> int:
    """Keys in one warp's tile: 2 KB of K (and of V) rows of ``d``
    elements of ``itemsize`` bytes, 4 to 32 keys; always divides CHUNK."""
    return max(4, min(32, 2048 // (d * itemsize)))


def plan_splits(b: int, kh: int, s: int, sms: int) -> Tuple[int, int]:
    """(splits, keys per split) of S for ``b * kh`` (batch, kv head)
    blocks on ``sms`` SMs: enough splits for about eight blocks an SM (four
    waves of the two blocks that fit an SM at D = 128 in bf16, so the last
    wave's idle SMs cost little), none shorter than MIN_SPLIT keys unless
    S is, each a multiple of CHUNK keys (the last may be short). One split
    when ``b * kh`` already fills the card."""
    n = max(1, min(-(-8 * sms // (b * kh)), -(-s // MIN_SPLIT)))
    split_len = -(-s // (n * CHUNK)) * CHUNK
    return -(-s // split_len), split_len


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_attention(q, k, v, bias) -> torch.Tensor:
    """q (B, H, D), k/v (B, S, K, D), bias (B, S) float32.
    Returns (B, H, D) in q's dtype."""
    check_attention_inputs("decode_attention", q, k, v, 3)
    refuse_grad("decode_attention", q, k, v)
    b, s = k.shape[0], k.shape[1]
    if bias.dtype != torch.float32 or tuple(bias.shape) != (b, s) or \
            bias.device != q.device or not bias.is_contiguous():
        raise ValueError(f"decode_attention: bias {tuple(bias.shape)} "
                         f"{bias.dtype} on {bias.device}; expected a "
                         f"contiguous float32 ({b}, {s}) on {q.device}")
    if q.device.type == "meta":
        out = torch.empty_like(q)
        meta.report(meta.attention_flops(b, q.shape[1], 1, s, q.shape[2]),
                    (q, k, v, bias), (out,))
        return out
    if not build.on_cuda(q.device, "decode attention"):
        return decode_attention_plain(q, k, v, bias)
    h, d = q.shape[1], q.shape[2]
    kh = k.shape[2]
    if h // kh > MAX_GROUP:
        raise ValueError(f"decode_attention: {h // kh} query heads per kv "
                         f"head; the kernel serves at most {MAX_GROUP}")
    out = torch.empty_like(q)
    check_kernel_layout("decode_attention", (q, k, v, out), d)
    nsplit, split_len = plan_splits(b, kh, s, _sm_count(q.device.index))
    # scratch of the splits' (m, l, acc), read by the combine pass: one
    # allocation, and none with one split (every launch of the serving path)
    parts = b * kh * nsplit * (h // kh) if nsplit > 1 else 0
    part_m = part_l = part_acc = None
    if parts:
        scratch = torch.empty(parts * (2 + d), dtype=torch.float32,
                              device=q.device)
        part_m = scratch.data_ptr()
        part_l, part_acc = part_m + 4 * parts, part_m + 8 * parts
    code = build.call_on(
        q.device, build.load().repro_decode_attention,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        out.data_ptr(), part_m, part_l, part_acc, b, s, h, kh, d, nsplit,
        split_len, d ** -0.5, int(q.dtype == torch.bfloat16),
        build.stream(q.device))
    build.raise_on(code, "repro_decode_attention")
    decode_attention.launches += 1
    decode_attention.shapes.add((b, h, kh, s, d, q.dtype))
    return out


decode_attention.launches = 0
decode_attention.shapes = set()


def reset_launch_counts() -> None:
    decode_attention.launches = 0

"""Analytic, *mesh-aware* per-device FLOPs/bytes model per (arch x shape)
(``repro.roofline.flops_model``, number for number).

This is the reference's model of its TPU program, kept as it is so that
the two packages' bounds agree. The port has no remat (no recompute in
its backward), so the port's own train step does 3/4 of ``TRAIN_MULT``'s
count: ``eager_cost`` of a meta train step reads 0.75 x ``step_cost``.

Why this exists:
  * XLA's ``cost_analysis()`` counts a while-loop body once regardless of
    trip count, so inner chunk scans (SSD, RG-LRU, chunked long-context
    attention) are invisible to it.
  * GSPMD replicates any op whose parallel dim is not divisible by the
    model axis (e.g. whisper's 12 heads or recurrentgemma's 10 heads on a
    16-way model axis): per-device FLOPs are then NOT total/M. The model
    accounts for that replication explicitly — the dry-run HLO numbers
    cross-validate it for shapes without inner scans.

Conventions: every matmul in the implementation is accounted with its
actual shapes (capacity-padded MoE, masked-dense causal attention).
fwd = 1x; train = 4x fwd (backward 2x + remat recompute 1x). Bytes count
operand+result traffic per op, bf16 activations, f32 scores.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.configs.base import ArchConfig, InputShape

TRAIN_MULT = 4.0  # fwd + bwd(2x) + remat recompute(1x)


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0

    def mm(self, m: float, k: float, n: float, batch: float = 1.0,
           dt_in: int = 2, dt_out: int = 2, shards: int = 1) -> "Cost":
        self.flops += 2.0 * m * k * n * batch / shards
        self.bytes += batch * (m * k * dt_in + k * n * dt_in +
                               m * n * dt_out) / shards
        return self

    def ew(self, n_elems: float, reads: int = 2, writes: int = 1,
           dt: int = 2, flops_per: float = 1.0, shards: int = 1) -> "Cost":
        self.flops += n_elems * flops_per / shards
        self.bytes += n_elems * (reads + writes) * dt / shards
        return self

    def add(self, other: "Cost") -> "Cost":
        self.flops += other.flops
        self.bytes += other.bytes
        return self

    def scale(self, f: float) -> "Cost":
        self.flops *= f
        self.bytes *= f
        return self


def _div(dim: int, m: int) -> int:
    """Shard count on the model axis for a dim: m if divisible else 1
    (GSPMD replication fallback — same rule as sharding/rules.py)."""
    return m if dim and dim % m == 0 else 1


def _attention_layer(arch: ArchConfig, b: float, s_q: int, s_kv: int, m: int,
                     window: int = 0, cross: bool = False,
                     kv_proj: bool = True) -> Cost:
    c = Cost()
    d, h, kh = arch.d_model, arch.num_heads, arch.num_kv_heads
    dh = arch.resolved_head_dim
    mh = _div(h, m)
    mkh = _div(kh, m)
    c.mm(s_q, d, h * dh, batch=b, shards=mh)               # q proj
    kv_tokens = s_kv if cross else s_q
    if kv_proj:
        c.mm(kv_tokens, d, 2 * kh * dh, batch=b, shards=mkh)  # k, v proj
    c.mm(s_q, h * dh, d, batch=b, shards=mh)               # o proj
    w = min(window or s_kv, s_kv)
    c.mm(s_q, dh, w, batch=b * h, dt_out=4, shards=mh)     # qk^T (f32)
    c.ew(b * h * s_q * w, reads=1, writes=1, dt=4, flops_per=5, shards=mh)
    c.mm(s_q, w, dh, batch=b * h, shards=mh)               # pv
    return c


def _mlp_layer(arch: ArchConfig, b: float, s: int, m: int) -> Cost:
    c = Cost()
    d, ff = arch.d_model, arch.d_ff
    mf = _div(ff, m)
    gated = arch.activation in ("geglu", "swiglu")
    c.mm(s, d, ff, batch=b * (2 if gated else 1), shards=mf)
    c.mm(s, ff, d, batch=b, shards=mf)
    return c


def _moe_layer(arch: ArchConfig, b: float, s: int, m: int) -> Cost:
    c = Cost()
    mo = arch.moe
    d = arch.d_model
    me = _div(mo.num_experts, m)
    c.mm(s, d, mo.num_experts, batch=b, dt_out=4)          # router (repl.)
    eff = b * s * mo.num_experts_per_tok * mo.capacity_factor
    gated = arch.activation in ("geglu", "swiglu")
    c.mm(eff, d, arch.d_ff, batch=(2 if gated else 1), shards=me)
    c.mm(eff, arch.d_ff, d, shards=me)
    # dispatch bookkeeping (cumsum/one-hot/scatter) runs on every shard
    c.ew(b * s * mo.num_experts_per_tok * d * 2, reads=1, writes=1)
    return c


def _ssm_layer(arch: ArchConfig, b: float, s: int, m: int) -> Cost:
    c = Cost()
    ss = arch.ssm
    d = arch.d_model
    di = ss.expand * d
    h = di // ss.head_dim
    p, n = ss.head_dim, ss.state_dim
    mh = _div(h, m)
    l = min(ss.chunk_size, s)
    nc = max(s // l, 1)
    c.mm(s, d, 2 * di + 2 * n + h, batch=b, shards=_div(di, m))
    c.ew(b * s * (di + 2 * n) * ss.conv_width, shards=_div(di, m))
    c.mm(l, n, l, batch=b * nc, dt_out=4)                  # C.B (h-independent)
    c.flops += 2.0 * b * nc * l * l * h * p / mh           # y_intra
    c.bytes += b * nc * (l * l * h * 4 + l * h * p * 4) / mh
    c.flops += 4.0 * b * s * h * p * n / mh                # inter + state
    c.bytes += b * nc * h * p * n * 4 * 3 / mh
    c.mm(s, di, d, batch=b, shards=_div(di, m))
    return c


def _rglru_layer(arch: ArchConfig, b: float, s: int, m: int) -> Cost:
    c = Cost()
    d = arch.d_model
    w = arch.rglru.lru_width or d
    mw = _div(w, m)
    c.mm(s, d, 2 * w, batch=b, shards=mw)
    c.ew(b * s * w * arch.rglru.conv_width, shards=mw)
    # gates contract over the (sharded) w input dim -> compute shards by mw
    c.mm(s, w, 2 * w, batch=b, dt_in=4, dt_out=4, shards=mw)
    c.ew(b * s * w, reads=3, writes=2, dt=4, flops_per=8, shards=mw)
    c.mm(s, w, d, batch=b, shards=mw)
    return c


def _layer_counts(arch: ArchConfig) -> Dict[str, int]:
    from repro_torch.models.transformer import layer_plan, num_groups
    group, leftover = layer_plan(arch)
    kinds = group * num_groups(arch) + leftover
    out: Dict[str, int] = {}
    for k in kinds:
        out[k] = out.get(k, 0) + 1
    return out


def forward_cost(arch: ArchConfig, b: float, s: int, kv_len: int, m: int,
                 num_actions: int = 18, decode: bool = False) -> Cost:
    """One forward over b (per-device) sequences of s new tokens attending
    to kv_len context; m = model-axis size."""
    total = Cost()
    counts = _layer_counts(arch)
    for kind, n in counts.items():
        if kind in ("attn", "moe"):
            c = _attention_layer(arch, b, s, kv_len, m)
            c.add(_moe_layer(arch, b, s, m) if kind == "moe"
                  else _mlp_layer(arch, b, s, m))
        elif kind == "local":
            window = (arch.rglru.attention_window if arch.rglru
                      else arch.sliding_window)
            c = _attention_layer(arch, b, s, kv_len, m, window=window)
            c.add(_mlp_layer(arch, b, s, m))
        elif kind == "recurrent":
            c = _rglru_layer(arch, b, s, m)
            c.add(_mlp_layer(arch, b, s, m))
        elif kind == "ssm":
            if decode:
                ss = arch.ssm
                di = ss.expand * arch.d_model
                h = di // ss.head_dim
                mh = _div(h, m)
                c = Cost()
                c.mm(s, arch.d_model, 2 * di + 2 * ss.state_dim + h,
                     batch=b, shards=_div(di, m))
                c.flops += 4.0 * b * h * ss.head_dim * ss.state_dim / mh
                c.bytes += b * h * ss.head_dim * ss.state_dim * 4 * 3 / mh
                c.mm(s, di, arch.d_model, batch=b, shards=_div(di, m))
            else:
                c = _ssm_layer(arch, b, s, m)
        elif kind == "cross":
            c = _attention_layer(arch, b, s, arch.encoder_seq_len, m,
                                 cross=True, kv_proj=not decode)
            c.add(_mlp_layer(arch, b, s, m))
        elif kind == "enc_dec":
            c = _attention_layer(arch, b, s, kv_len, m)
            c.add(_attention_layer(arch, b, s, arch.encoder_seq_len, m,
                                   cross=True, kv_proj=not decode))
            c.add(_mlp_layer(arch, b, s, m))
        else:
            raise ValueError(kind)
        total.add(c.scale(n))
    # decode reads cached encoder projections; the encoder itself ran at
    # prefill time
    if arch.encoder_layers and not decode:
        enc = Cost()
        enc.add(_attention_layer(arch, b, arch.encoder_seq_len,
                                 arch.encoder_seq_len, m))
        enc.add(_mlp_layer(arch, b, arch.encoder_seq_len, m))
        total.add(enc.scale(arch.encoder_layers))
    total.ew(b * s * arch.d_model, reads=1, writes=1)      # embed gather
    total.mm(s, arch.d_model, num_actions + 1, batch=b, dt_out=4)
    return total


def step_cost(arch: ArchConfig, shape: InputShape, n_devices: int,
              model_axis: int = 16) -> Tuple[float, float]:
    """(flops, bytes) per device for the step this shape lowers."""
    b, s = shape.global_batch, shape.seq_len
    data_shards = n_devices // model_axis
    b_loc = max(b / data_shards, 1.0)   # < data_shards batch => replication
    m = model_axis
    if shape.kind == "train":
        c = forward_cost(arch, b_loc, s, s, m).scale(TRAIN_MULT)
    elif shape.kind == "prefill":
        c = forward_cost(arch, b_loc, s, s, m)
    else:
        kv = s if arch.family == "ssm" else min(arch.sliding_window or s, s)
        c = forward_cost(arch, b_loc, 1, kv, m, decode=True)
        if arch.family != "ssm":
            dh = arch.resolved_head_dim
            counts = _layer_counts(arch)
            n_attn = sum(v for k, v in counts.items()
                         if k in ("attn", "local", "moe", "enc_dec"))
            window = arch.rglru.attention_window if arch.rglru else \
                (arch.sliding_window or s)
            mkh = _div(arch.num_kv_heads, m)
            c.bytes += (n_attn * b_loc * min(window, s) *
                        arch.num_kv_heads * dh * 2 * 2) / mkh
    return c.flops, c.bytes

"""Mamba-2 (state-space duality, arXiv:2405.21060) block
(``repro.models.ssm``).

Chunked SSD: within a chunk the quadratic "attention" form, across chunks
a diagonal linear recurrence on the (H, P, N) state. The JAX package
carries that recurrence through a ``lax.scan`` over chunks; here
``ssd_chunked`` computes every chunk's decay and own state contribution
at once and runs the whole cross-chunk pass as one ``ops.linear_scan``
(kernel K3 on the card). The training mode runs the same function with
a gradient: the decay tensor is masked before its ``exp`` rather than
filled in place after it, and K3's gradient is K3 on reversed time
(``kernels/linear_scan.py``).

Layouts, as in the JAX package: x (B, T, H, P); dt (B, T, H); B/C
(B, T, N) (single group); the SSM state (B, H, P, N); the conv state
(B, W-1, C) with C = d_inner + 2N.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.common import (Spec, dense, dense_specs, rmsnorm,
                                       rmsnorm_specs, torch_dtype)


def _dims(cfg: ArchConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    heads = s.num_heads or d_inner // s.head_dim
    return d_inner, heads, s.head_dim, s.state_dim


def ssm_specs(cfg: ArchConfig) -> Dict:
    s = cfg.ssm
    d = cfg.d_model
    d_inner, h, _, n = _dims(cfg)
    conv_ch = d_inner + 2 * n  # conv over x, B, C as in mamba2
    return {
        "in_zx": dense_specs((d,), (2 * d_inner,), ("embed",), ("ff",)),
        "in_bc": dense_specs((d,), (2 * n,), ("embed",), (None,)),
        "in_dt": dense_specs((d,), (h,), ("embed",), ("ssm_heads",)),
        "conv": {"kernel": Spec((s.conv_width, conv_ch), ("conv", "ff"),
                                init="normal"),
                 "bias": Spec((conv_ch,), ("ff",), init="zeros")},
        "dt_bias": {"w": Spec((h,), ("ssm_heads",), init="zeros")},
        "a_log": {"w": Spec((h,), ("ssm_heads",), init="ones")},
        "d_skip": {"w": Spec((h,), ("ssm_heads",), init="ones")},
        "out_norm": rmsnorm_specs(d_inner, "ff"),
        "out": dense_specs((d_inner,), (d,), ("ff",), ("embed",)),
    }


def _causal_conv(x, kernel, bias, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x:(B,T,C) kernel:(W,C). If state (B,W-1,C) is
    given, runs in streaming mode and returns (y, new_state)."""
    w = kernel.shape[0]
    if state is not None:
        xin = torch.cat([state.to(x.dtype), x], dim=1)
        new_state = xin[:, -(w - 1):]
    else:
        xin = F.pad(x, (0, 0, w - 1, 0))
        new_state = None
    y = sum(xin[:, i:i + x.shape[1]] * kernel[i].to(x.dtype)
            for i in range(w))
    y = y + bias.to(x.dtype)
    return F.silu(y), new_state


def ssd_chunked(x, dt, a_log, b, c, d_skip, chunk: int,
                init_state: Optional[torch.Tensor] = None,
                impl: str = "auto"):
    """Chunked SSD scan.

    x: (B,T,H,P) f32; dt: (B,T,H) f32 (softplus'ed); a_log: (H,) (A = -exp);
    b, c: (B,T,N) f32; d_skip: (H,). ``impl`` is the cross-chunk pass's
    route (``ops.linear_scan``).
    Returns (y (B,T,H,P), final_state (B,H,P,N)).
    """
    bsz, t, h, p = x.shape
    n = b.shape[-1]
    pad = (-t) % chunk
    if pad:
        # zero dt: decay 1 and no contribution, the final state unchanged
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    nc = (t + pad) // chunk
    a = -torch.exp(a_log.to(torch.float32))           # (H,) negative
    log_a = dt * a                                     # (B,T,H) <= 0
    xdt = x * dt[..., None]

    # chunks, heads ahead of time: (B, nc, H, L, ...)
    xc = xdt.reshape(bsz, nc, chunk, h, p).permute(0, 1, 3, 2, 4)
    bc_ = b.reshape(bsz, nc, chunk, n)
    cc = c.reshape(bsz, nc, chunk, n)
    cum = torch.cumsum(log_a.reshape(bsz, nc, chunk, h), dim=2)
    cum = cum.permute(0, 1, 3, 2)                      # (B,nc,H,L)

    # intra-chunk: y_i += sum_{j<=i} (C_i.B_j) exp(cum_i - cum_j) x_j.
    # Above the diagonal exp may overflow to inf: masked by a fill, never
    # by a product (inf * 0 is NaN)
    decay = cum[..., :, None] - cum[..., None, :]      # (B,nc,H,i,j)
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                 device=x.device))
    scores = torch.einsum("bcin,bcjn->bcij", cc, bc_)[:, :, None]
    if torch.is_grad_enabled() and decay.requires_grad:
        # training: out of place, masked before the exp (0 there, with a
        # zero gradient, where exp(decay) itself might be inf)
        gamma = torch.exp(decay.masked_fill(~mask, float("-inf"))) * scores
    else:
        gamma = decay.exp_()
        gamma.masked_fill_(~mask, 0.0)
        gamma.mul_(scores)
    del decay
    y = torch.matmul(gamma, xc)                        # (B,nc,H,L,P)
    # the large transients go as soon as they are read (gamma is 2.1 GB a
    # layer at batch 16, ctx 2048 at mamba2-1.3b's widths)
    del gamma

    # each chunk's own state contribution and decay, then the cross-chunk
    # pass S_c = exp(cum_L) S_{c-1} + sum_j exp(cum_L - cum_j) x_j B_j as
    # one linear scan over (nc, B*H*P*N)
    seg = torch.exp(cum[..., -1:] - cum)               # (B,nc,H,L)
    contrib = torch.matmul((xc * seg[..., None]).transpose(-1, -2),
                           bc_[:, :, None])            # (B,nc,H,P,N)
    b_scan = contrib.transpose(0, 1).reshape(nc, -1).contiguous()
    del contrib
    a_scan = torch.exp(cum[..., -1]).transpose(0, 1)   # (nc,B,H)
    a_scan = a_scan[..., None, None].expand(nc, bsz, h, p, n) \
        .reshape(nc, -1).contiguous()
    h0 = (None if init_state is None else
          init_state.to(torch.float32).reshape(-1).contiguous())
    states = ops.linear_scan(a_scan, b_scan, h0, impl=impl)
    del a_scan, b_scan
    states = states.reshape(nc, bsz, h, p, n)
    # a copy: a view would keep every chunk's states alive in the cache
    final_state = states[-1].clone()
    # the state entering chunk c: h0 for c = 0, else the row of chunk c-1
    first = (torch.zeros_like(states[:1]) if h0 is None
             else h0.reshape(1, bsz, h, p, n))
    s_in = torch.cat([first, states[:-1]], dim=0).transpose(0, 1)

    # inter-chunk: y_i += C_i . (exp(cum_i) * S_in)
    cs = torch.matmul(cc[:, :, None], s_in.transpose(-1, -2))  # (B,nc,H,L,P)
    y = y + cs * torch.exp(cum)[..., None]
    y = y.permute(0, 1, 3, 2, 4).reshape(bsz, nc * chunk, h, p)[:, :t]
    y = y + d_skip.to(torch.float32)[None, None, :, None] * x[:, :t]
    return y, final_state


def ssd_step(state, x, dt, a_log, b, c, d_skip):
    """Single decode step. x:(B,H,P) dt:(B,H) b/c:(B,N). Returns (y, state')."""
    a = -torch.exp(a_log.to(torch.float32))
    la = dt * a                                        # (B,H)
    decay = torch.exp(la)[:, :, None, None]
    xdt = x * dt[..., None]
    new_state = decay * state + torch.einsum("bhp,bn->bhpn", xdt, b)
    y = torch.einsum("bhpn,bn->bhp", new_state, c)
    y = y + d_skip[None, :, None] * x
    return y, new_state


def apply_ssm(params, x, cfg: ArchConfig, *, mode: str,
              state: Optional[Dict[str, torch.Tensor]] = None,
              impl: str = "auto",
              ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """x: (B,T,d_model). state = {'ssm': (B,H,P,N), 'conv': (B,W-1,C)}.

    Prefill returns a new state. Decode writes the step's SSM and conv
    states into ``state`` in place and returns it (the JAX function returns
    new arrays). Train runs over the whole sequence from a zero state
    with a gradient and returns no state (None). Where T is shorter than
    ``chunk_size`` it runs one chunk of length T: JAX pads the sequence
    to one chunk with dt = 0, which changes neither the first T outputs
    nor the final state, so the function is the same and the decay tensor
    is (T/chunk)^2 of the padded one's size."""
    dtype = torch_dtype(cfg.dtype)
    s = cfg.ssm
    d_inner, h, p, n = _dims(cfg)
    bsz, t, _ = x.shape

    zx = dense(params["in_zx"], x, dtype=dtype)
    z, xi = zx[..., :d_inner], zx[..., d_inner:]
    bc = dense(params["in_bc"], x, dtype=dtype)
    dt_raw = dense(params["in_dt"], x, dtype=dtype)
    dt = F.softplus(dt_raw.to(torch.float32)
                    + params["dt_bias"]["w"].to(torch.float32))

    conv_in = torch.cat([xi, bc], dim=-1)
    conv_state = state["conv"] if state is not None else None
    conv_out, new_conv_state = _causal_conv(
        conv_in, params["conv"]["kernel"], params["conv"]["bias"], conv_state)
    xi = conv_out[..., :d_inner]
    b_ = conv_out[..., d_inner:d_inner + n].to(torch.float32)
    c_ = conv_out[..., d_inner + n:].to(torch.float32)
    xh = xi.reshape(bsz, t, h, p).to(torch.float32)

    if mode == "decode":
        assert state is not None and t == 1
        y, new_ssm = ssd_step(state["ssm"].to(torch.float32), xh[:, 0],
                              dt[:, 0], params["a_log"]["w"], b_[:, 0],
                              c_[:, 0], params["d_skip"]["w"])
        y = y[:, None]
        state["ssm"].copy_(new_ssm)
        state["conv"].copy_(new_conv_state)
        new_state = state
    elif mode == "prefill":
        init = state["ssm"].to(torch.float32) if state is not None else None
        y, final = ssd_chunked(xh, dt, params["a_log"]["w"], b_, c_,
                               params["d_skip"]["w"], s.chunk_size, init,
                               impl=impl)
        if new_conv_state is None:
            # the streaming conv state: the raw tail of the conv's inputs,
            # copied so that the cache does not keep all of them alive
            w = s.conv_width
            new_conv_state = conv_in[:, -(w - 1):].clone()
            if new_conv_state.shape[1] < w - 1:
                new_conv_state = F.pad(
                    new_conv_state,
                    (0, 0, w - 1 - new_conv_state.shape[1], 0))
        new_state = {"ssm": final, "conv": new_conv_state}
    elif mode == "train":
        y, _ = ssd_chunked(xh, dt, params["a_log"]["w"], b_, c_,
                           params["d_skip"]["w"], min(s.chunk_size, t),
                           impl=impl)
        new_state = None
    else:
        raise ValueError(f"mode {mode!r}: expected 'train', 'prefill' or "
                         f"'decode'")

    y = y.reshape(bsz, t, d_inner).to(dtype)
    y = y * F.silu(z)
    y = rmsnorm(params["out_norm"], y)
    out = dense(params["out"], y, dtype=dtype)
    return out, new_state


def ssm_state_abstract(batch: int, cfg: ArchConfig, dtype
                       ) -> Dict[str, torch.Tensor]:
    """The decode state of one layer as ``meta`` tensors: the SSM state in
    float32, the conv state in the activations' dtype."""
    s = cfg.ssm
    d_inner, h, p, n = _dims(cfg)
    conv_ch = d_inner + 2 * n
    return {
        "ssm": torch.empty((batch, h, p, n), dtype=torch.float32,
                           device="meta"),
        "conv": torch.empty((batch, s.conv_width - 1, conv_ch), dtype=dtype,
                            device="meta"),
    }


def ssm_state_init(batch: int, cfg: ArchConfig, dtype, device="cpu"
                   ) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
            for k, v in ssm_state_abstract(batch, cfg, dtype).items()}

"""The two V-trace kernels (``repro.kernels.vtrace``), ported to CUDA.

* ``vtrace`` (K1) replaces ``vtrace_pallas``: the V-trace reverse
  recurrence on time-major (T, B) float32 inputs, returning (vs, pg_adv).
* ``loss_vtrace`` (K2) replaces ``loss_vtrace_pallas``: log-softmax,
  target log-prob, per-step negative entropy and the clipped importance
  weights from (T, B, A) logits, then the same recurrence, returning
  (tlp, neg_entropy, vs, pg_adv).
* ``fused_loss_vtrace`` replaces the ``custom_vjp`` around K2 with a
  ``torch.autograd.Function`` whose backward is the closed form.

The kernels are CUDA C++ in ``repro_torch/csrc/vtrace.cu`` (built by
``repro_torch.kernels.build``). Each wrapper takes its plain PyTorch
version (``vtrace_plain``, ``loss_vtrace_plain``) only because the
tensors it was given lie on the CPU; on CUDA tensors it launches the
kernel or raises. ``launches`` on each wrapper counts its kernel's
launches, and nothing else.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import vtrace_ref

# K1's plain version is the oracle itself: the same reverse loop
vtrace_plain = vtrace_ref


def reset_launch_counts() -> None:
    vtrace.launches = 0
    loss_vtrace.launches = 0


# ---------------------------------------------------------------------------
# K1: the V-trace recurrence


def vtrace(rho, c, discounts, rewards, values, values_tp1
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All inputs (T, B) float32, contiguous, on one device.
    Returns (vs, pg_adv), each (T, B)."""
    t, b = rho.shape
    if t < 1 or b < 1:
        raise ValueError(f"vtrace: empty input {tuple(rho.shape)}")
    args = (rho, c, discounts, rewards, values, values_tp1)
    for name, x in zip(("rho", "c", "discounts", "rewards", "values",
                        "values_tp1"), args):
        build.check_f32(name, x, (t, b), rho.device)
    if not build.on_cuda(rho.device, "V-trace"):
        return vtrace_plain(*args)
    lib = build.load()
    vs = torch.empty_like(rho)
    pg = torch.empty_like(rho)
    with torch.cuda.device(rho.device):
        code = lib.repro_vtrace(*(x.data_ptr() for x in args),
                                vs.data_ptr(), pg.data_ptr(), t, b,
                                build.stream(rho.device))
    build.raise_on(code, "repro_vtrace")
    vtrace.launches += 1
    return vs, pg


vtrace.launches = 0


# ---------------------------------------------------------------------------
# K2: fused loss + V-trace


def _sum_actions(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last (action) axis from left to right, the order of
    the kernel's loop, so both round alike."""
    total = x[..., 0]
    for a in range(1, x.shape[-1]):
        total = total + x[..., a]
    return total


def loss_vtrace_plain(logits, onehot, behaviour_logprob, discounts, rewards,
                      values, values_tp1, rho_bar: Optional[float] = 1.0,
                      c_bar: Optional[float] = 1.0, lambda_: float = 1.0):
    """K2's arithmetic in PyTorch ops, in the kernel's order.
    Differentiable in ``logits`` through tlp and neg_entropy; the clipped
    weights read a detached tlp, so vs/pg_adv are targets."""
    m = torch.amax(logits, dim=-1, keepdim=True)
    logp = logits - m - torch.log(
        _sum_actions(torch.exp(logits - m)))[..., None]
    tlp = _sum_actions(logp * onehot)
    p = torch.exp(logp)
    ne = _sum_actions(p * logp)
    rho_raw = torch.exp(tlp.detach() - behaviour_logprob)
    rho = rho_raw if rho_bar is None else torch.clamp(rho_raw, max=rho_bar)
    c = lambda_ * (rho_raw if c_bar is None
                   else torch.clamp(rho_raw, max=c_bar))
    vs, pg = vtrace_ref(rho, c, discounts, rewards, values, values_tp1)
    return tlp, ne, vs, pg


def loss_vtrace(logits, onehot, behaviour_logprob, discounts, rewards,
                values, values_tp1, rho_bar: Optional[float] = 1.0,
                c_bar: Optional[float] = 1.0, lambda_: float = 1.0):
    """Forward-only fused pass, with ``loss_vtrace_pallas``'s signature.
    ``logits``/``onehot`` are (T, B, A) float32, everything else (T, B)
    float32. Returns (target_logprob, neg_entropy, vs, pg_adv), each
    (T, B). ``None`` for ``rho_bar``/``c_bar`` means no clip."""
    t, b, a = logits.shape
    if t < 1 or b < 1 or a < 1:
        raise ValueError(f"loss_vtrace: empty input {tuple(logits.shape)}")
    dev = logits.device
    build.check_f32("logits", logits, (t, b, a), dev)
    build.check_f32("onehot", onehot, (t, b, a), dev)
    flat = (behaviour_logprob, discounts, rewards, values, values_tp1)
    for name, x in zip(("behaviour_logprob", "discounts", "rewards",
                        "values", "values_tp1"), flat):
        build.check_f32(name, x, (t, b), dev)
    if not build.on_cuda(dev, "V-trace"):
        return loss_vtrace_plain(logits, onehot, *flat, rho_bar=rho_bar,
                                 c_bar=c_bar, lambda_=lambda_)
    lib = build.load()
    outs = tuple(torch.empty((t, b), dtype=torch.float32, device=dev)
                 for _ in range(4))
    with torch.cuda.device(dev):
        code = lib.repro_loss_vtrace(
            logits.data_ptr(), onehot.data_ptr(),
            *(x.data_ptr() for x in flat), *(o.data_ptr() for o in outs),
            t, b, a,
            0.0 if rho_bar is None else float(rho_bar), rho_bar is not None,
            0.0 if c_bar is None else float(c_bar), c_bar is not None,
            float(lambda_), build.stream(dev))
    build.raise_on(code, "repro_loss_vtrace")
    loss_vtrace.launches += 1
    return outs


loss_vtrace.launches = 0


class _FusedLossVtrace(torch.autograd.Function):
    """Gradients flow ONLY into ``logits``, through tlp and neg_entropy,
    in closed form (no scan in the backward): d tlp / d logits =
    onehot - p and d ne / d logits = p (logp - ne). vs/pg_adv are V-trace
    targets and carry no gradient."""

    @staticmethod
    def forward(ctx, logits, onehot, behaviour_logprob, discounts, rewards,
                values, values_tp1, rho_bar, c_bar, lambda_):
        tlp, ne, vs, pg = loss_vtrace(logits, onehot, behaviour_logprob,
                                      discounts, rewards, values,
                                      values_tp1, rho_bar, c_bar, lambda_)
        ctx.save_for_backward(logits, onehot, ne)
        ctx.mark_non_differentiable(vs, pg)
        return tlp, ne, vs, pg

    @staticmethod
    def backward(ctx, g_tlp, g_ne, _g_vs, _g_pg):
        logits, onehot, ne = ctx.saved_tensors
        logp = torch.log_softmax(logits, dim=-1)
        p = torch.exp(logp)
        d_logits = (g_tlp[..., None] * (onehot - p) +
                    g_ne[..., None] * p * (logp - ne[..., None]))
        return (d_logits,) + (None,) * 9


def fused_loss_vtrace(logits, onehot, behaviour_logprob, discounts, rewards,
                      values, values_tp1, rho_bar: Optional[float] = 1.0,
                      c_bar: Optional[float] = 1.0, lambda_: float = 1.0):
    """Differentiable wrapper over ``loss_vtrace`` (one K2 launch)."""
    return _FusedLossVtrace.apply(logits, onehot, behaviour_logprob,
                                  discounts, rewards, values, values_tp1,
                                  rho_bar, c_bar, lambda_)

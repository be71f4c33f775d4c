"""V-trace (paper §4, Eq. 1), ``repro.core.vtrace`` in PyTorch.

    v_s = V(x_s) + sum_{t=s}^{s+n-1} gamma^{t-s} (prod_{i=s}^{t-1} c_i) delta_t V
    delta_t V = rho_t (r_t + gamma V(x_{t+1}) - V(x_t))
    rho_t = min(rho_bar, pi(a_t|x_t)/mu(a_t|x_t)),  c_i = lambda * min(c_bar, ...)

All tensors are batch-major (B, T); ``bootstrap_value`` is V(x_{s+n}) (B,).
Three implementations:
  * ``vtrace_reference``  — O(T^2) literal Eq. (1), the test oracle;
  * ``vtrace_scan``       — a reverse Python loop (the CPU path);
  * ``impl='pallas'``     — the hand-written CUDA kernel K1 through
    ``repro_torch.kernels.ops`` (the reference's name for the kernel route).

The results are targets: they are computed without autograd, so no
gradient flows through ``vs``/``pg_advantages`` (paper §4.2).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class VTraceReturns:
    vs: torch.Tensor              # (B, T) V-trace value targets
    pg_advantages: torch.Tensor   # (B, T) rho_s (r_s + gamma v_{s+1} - V(x_s))


def _f32(*xs):
    return tuple(x.to(torch.float32) for x in xs)


def _clipped_weights(log_rhos, rho_bar, c_bar, lambda_):
    rhos = torch.exp(log_rhos)
    rho_t = torch.clamp(rhos, max=rho_bar) if rho_bar is not None else rhos
    c_t = torch.clamp(rhos, max=c_bar) if c_bar is not None else rhos
    return rho_t, lambda_ * c_t


def _with_bootstrap(x, bootstrap_value):
    return torch.cat([x[:, 1:], bootstrap_value[:, None]], dim=1)


@torch.no_grad()
def vtrace_scan(log_rhos, discounts, rewards, values, bootstrap_value,
                rho_bar: Optional[float] = 1.0, c_bar: Optional[float] = 1.0,
                lambda_: float = 1.0) -> VTraceReturns:
    """Reverse-loop V-trace. All (B, T) except bootstrap_value (B,)."""
    log_rhos, discounts, rewards, values, bootstrap_value = _f32(
        log_rhos, discounts, rewards, values, bootstrap_value)
    rho_t, c_t = _clipped_weights(log_rhos, rho_bar, c_bar, lambda_)
    values_tp1 = _with_bootstrap(values, bootstrap_value)
    deltas = rho_t * (rewards + discounts * values_tp1 - values)

    t = deltas.shape[1]
    acc = torch.zeros_like(bootstrap_value)
    accs = [None] * t
    for s in reversed(range(t)):
        acc = deltas[:, s] + discounts[:, s] * c_t[:, s] * acc
        accs[s] = acc
    vs = values + torch.stack(accs, dim=1)

    vs_tp1 = _with_bootstrap(vs, bootstrap_value)
    # pg uses its own (possibly different) clipping; paper uses rho_bar too
    pg_adv = rho_t * (rewards + discounts * vs_tp1 - values)
    return VTraceReturns(vs, pg_adv)


@torch.no_grad()
def vtrace_reference(log_rhos, discounts, rewards, values, bootstrap_value,
                     rho_bar: Optional[float] = 1.0,
                     c_bar: Optional[float] = 1.0,
                     lambda_: float = 1.0) -> VTraceReturns:
    """Literal O(T^2) Eq. (1) — used as the oracle in tests."""
    log_rhos, discounts, rewards, values, bootstrap_value = _f32(
        log_rhos, discounts, rewards, values, bootstrap_value)
    b, t = log_rhos.shape
    rho_t, c_t = _clipped_weights(log_rhos, rho_bar, c_bar, lambda_)
    values_tp1 = _with_bootstrap(values, bootstrap_value)
    deltas = rho_t * (rewards + discounts * values_tp1 - values)

    vs = []
    for s in range(t):
        # direct product form: sum_t gamma^{t-s} (prod c_i) delta_t
        total = torch.zeros_like(bootstrap_value)
        coef = torch.ones_like(bootstrap_value)
        for u in range(s, t):
            total = total + coef * deltas[:, u]
            coef = coef * discounts[:, u] * c_t[:, u]
        vs.append(values[:, s] + total)
    vs = torch.stack(vs, dim=1)
    vs_tp1 = _with_bootstrap(vs, bootstrap_value)
    pg_adv = rho_t * (rewards + discounts * vs_tp1 - values)
    return VTraceReturns(vs, pg_adv)


@torch.no_grad()
def vtrace(log_rhos, discounts, rewards, values, bootstrap_value,
           rho_bar: Optional[float] = 1.0, c_bar: Optional[float] = 1.0,
           lambda_: float = 1.0, impl: str = "scan") -> VTraceReturns:
    """Dispatching entry point. impl: 'scan' | 'pallas' | 'reference'."""
    if impl == "scan":
        return vtrace_scan(log_rhos, discounts, rewards, values,
                           bootstrap_value, rho_bar, c_bar, lambda_)
    if impl == "reference":
        return vtrace_reference(log_rhos, discounts, rewards, values,
                                bootstrap_value, rho_bar, c_bar, lambda_)
    if impl == "pallas":
        from repro_torch.kernels import ops
        vs, pg = ops.vtrace(log_rhos, discounts, rewards, values,
                            bootstrap_value, rho_bar=rho_bar, c_bar=c_bar,
                            lambda_=lambda_, impl="pallas")
        return VTraceReturns(vs, pg)
    raise ValueError(impl)


@torch.no_grad()
def vtrace_from_logits(behaviour_logprob, target_logits, actions, discounts,
                       rewards, values, bootstrap_value,
                       rho_bar: Optional[float] = 1.0,
                       c_bar: Optional[float] = 1.0,
                       lambda_: float = 1.0,
                       impl: str = "scan") -> VTraceReturns:
    """Log importance ratios from the learner's logits and the behaviour
    log-probability shipped in the trajectory (paper §3)."""
    log_rhos = action_log_probs(target_logits, actions) - behaviour_logprob
    return vtrace(log_rhos, discounts, rewards, values, bootstrap_value,
                  rho_bar, c_bar, lambda_, impl=impl)


def action_log_probs(logits, actions):
    """logits (B,T,A) f32, actions (B,T) int -> (B,T) log pi(a|x)."""
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    return torch.gather(logp, -1, actions.long()[..., None])[..., 0]

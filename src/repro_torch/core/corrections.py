"""The four off-policy correction variants of paper §5.2.2
(``repro.core.corrections``):

  1. 'none'       — no correction (on-policy n-step Bellman targets and
                    plain advantages, even though the data is off-policy).
  2. 'eps'        — like 'none', but log pi is computed as log(pi + eps)
                    in the policy-gradient loss (GA3C-style stabilizer).
  3. 'onestep_is' — no correction of V targets; the policy gradient
                    advantage is multiplied by the 1-step truncated IS
                    weight rho_s ("V-trace without traces").
  4. 'vtrace'     — full V-trace (Eq. 1).

Each returns (vs, pg_advantages) as (B, T) tensors without gradient.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ImpalaConfig
from repro_torch.core import vtrace as vtrace_lib


@torch.no_grad()
def replay_baseline_mix(values, target_values, replay_mask):
    """IMPACT-style mixed correction baseline: rows flagged by
    ``replay_mask`` (B,) take the target network's values as the V-trace
    recursion's V(x_s), online rows keep the learner's own values. No
    gradient: correction outputs are targets either way."""
    m = replay_mask.to(torch.float32)
    m = m.reshape(m.shape + (1,) * (values.dim() - 1))
    return (m * target_values.to(torch.float32) +
            (1.0 - m) * values.to(torch.float32))


@torch.no_grad()
def nstep_returns(discounts, rewards, values, bootstrap_value):
    """On-policy n-step Bellman targets (Eq. 2): reverse loop of
    G_s = r_s + gamma_s G_{s+1}, G_n = bootstrap."""
    del values
    rewards = rewards.to(torch.float32)
    discounts = discounts.to(torch.float32)
    acc = bootstrap_value.to(torch.float32)
    gs = [None] * rewards.shape[1]
    for s in reversed(range(rewards.shape[1])):
        acc = rewards[:, s] + discounts[:, s] * acc
        gs[s] = acc
    return torch.stack(gs, dim=1)


def _clipped_rho(cfg, target_logits, actions, behaviour_logprob):
    logp = vtrace_lib.action_log_probs(target_logits, actions)
    rho = torch.exp(logp - behaviour_logprob)
    if cfg.rho_bar is not None:
        rho = torch.clamp(rho, max=cfg.rho_bar)
    return rho


@torch.no_grad()
def compute_correction(cfg: ImpalaConfig, behaviour_logprob, target_logits,
                       actions, discounts, rewards, values, bootstrap_value,
                       impl: str = "scan"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch on cfg.correction. Returns (vs, pg_advantages)."""
    mode = cfg.correction
    if mode == "vtrace":
        ret = vtrace_lib.vtrace_from_logits(
            behaviour_logprob, target_logits, actions, discounts, rewards,
            values, bootstrap_value, rho_bar=cfg.rho_bar, c_bar=cfg.c_bar,
            lambda_=cfg.lambda_, impl=impl)
        pg_adv = ret.pg_advantages
        if cfg.pg_q_estimate == "baseline_v":
            # Appendix E.3 variant: q_s = r_s + gamma V(x_{s+1})
            rho = _clipped_rho(cfg, target_logits, actions,
                               behaviour_logprob)
            v_tp1 = torch.cat(
                [values[:, 1:].to(torch.float32),
                 bootstrap_value.to(torch.float32)[:, None]], dim=1)
            pg_adv = rho * (rewards.to(torch.float32) +
                            discounts.to(torch.float32) * v_tp1 -
                            values.to(torch.float32))
        return ret.vs, pg_adv

    vs = nstep_returns(discounts, rewards, values, bootstrap_value)
    vs_tp1 = torch.cat(
        [vs[:, 1:], bootstrap_value.to(torch.float32)[:, None]], dim=1)
    adv = (rewards.to(torch.float32) + discounts.to(torch.float32) *
           vs_tp1 - values.to(torch.float32))
    if mode == "onestep_is":
        adv = _clipped_rho(cfg, target_logits, actions,
                           behaviour_logprob) * adv
    elif mode not in ("none", "eps"):
        raise ValueError(mode)  # 'eps' only changes the log-prob in the loss
    return vs, adv

"""V-trace actor-critic losses (paper §4.2), ``repro.core.losses``.

Total = pg_loss + baseline_cost * baseline_loss + entropy_cost * entropy_loss,
*summed* over batch and time (paper Table D.1 note: "the loss is summed
across the batch and time dimensions").
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ImpalaConfig
from repro_torch.core import corrections, vtrace as vtrace_lib
from repro_torch.kernels import vtrace as vtrace_kernels


def resolve_vtrace_impl(impl: str, device: torch.device) -> str:
    """Map ``auto`` to a concrete implementation from the tensors' device:
    the fused loss/V-trace kernel (K2) on CUDA tensors and on the dry
    run's ``meta`` tensors, the reverse loop (``scan``) on CPU tensors.
    Explicit choices pass through."""
    if impl != "auto":
        return impl
    return "fused" if device.type in ("cuda", "meta") else "scan"


def reward_clip(rewards: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "abs_one":
        return torch.clamp(rewards, -1.0, 1.0)
    if mode == "soft_asymmetric":
        # Optimistic Asymmetric Clipping (Fig. D.1):
        # 0.3 * min(tanh(r), 0) + 5.0 * max(tanh(r), 0)
        t = torch.tanh(rewards)
        return 0.3 * torch.clamp(t, max=0.0) + 5.0 * torch.clamp(t, min=0.0)
    if mode == "none":
        return rewards
    raise ValueError(mode)


def policy_gradient_loss(logits, actions, advantages, eps: float = 0.0):
    """-(sum) adv * log pi(a|x); advantages carry no gradient."""
    if eps:
        probs = F.softmax(logits.to(torch.float32), dim=-1)
        logp_all = torch.log(probs + eps)
        logp = torch.gather(logp_all, -1, actions.long()[..., None])[..., 0]
    else:
        logp = vtrace_lib.action_log_probs(logits, actions)
    return -torch.sum(advantages.detach() * logp)


def baseline_loss(values, vs):
    """0.5 * sum (v_s - V(x_s))^2."""
    return 0.5 * torch.sum(torch.square(vs.detach() -
                                        values.to(torch.float32)))


def entropy_loss(logits):
    """Negative entropy summed (so that adding it *with positive coef*
    maximizes entropy): sum_s sum_a pi log pi."""
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    return torch.sum(torch.exp(logp) * logp)


def _metrics(total, pg, bl, ent, vs, pg_adv) -> Dict[str, torch.Tensor]:
    return {
        "loss/total": total,
        "loss/pg": pg,
        "loss/baseline": bl,
        "loss/entropy": ent,
        "vtrace/mean_vs": torch.mean(vs),
        "vtrace/mean_pg_adv": torch.mean(pg_adv),
    }


def impala_loss(cfg: ImpalaConfig, target_logits, values, batch: Dict,
                impl: str = "auto", corr_values=None, corr_bootstrap=None,
                per_traj: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The full IMPALA learner loss on a batch of trajectories.

    batch: actions (B,T) int, rewards (B,T) f32, discounts (B,T) f32,
    behaviour_logprob (B,T) f32, bootstrap_value (B,) = V(x_T).
    target_logits: (B,T,A) f32; values: (B,T) f32.

    ``corr_values``/``corr_bootstrap`` (replay path) substitute the V(x_s)
    the V-trace recursion reads (``corrections.replay_baseline_mix``'s
    target-network baseline on replayed rows), while the baseline loss
    keeps training the online ``values`` toward the resulting vs.
    ``per_traj=True`` adds ``vtrace/traj_adv_mag`` (B,), the
    per-trajectory mean |pg advantage|: the replay priority signal.

    The fused kernel computes V-trace with its own pg advantages from the
    trained values, so the ablation variants (other corrections,
    ``pg_q_estimate='baseline_v'``) and the replay path take the plain
    V-trace kernel on CUDA (``pallas``) and the reverse loop on the CPU.
    """
    device = target_logits.device
    impl = resolve_vtrace_impl(impl, device)
    rewards = reward_clip(batch["rewards"], cfg.reward_clip)
    replay = (corr_values is not None or corr_bootstrap is not None
              or per_traj)
    if impl == "fused":
        if (cfg.correction == "vtrace" and cfg.pg_q_estimate != "baseline_v"
                and not replay):
            return _impala_loss_fused(cfg, target_logits, values, batch,
                                      rewards)
        impl = "pallas" if device.type in ("cuda", "meta") else "scan"
    vs, pg_adv = corrections.compute_correction(
        cfg, batch["behaviour_logprob"], target_logits, batch["actions"],
        batch["discounts"], rewards,
        values if corr_values is None else corr_values,
        (batch["bootstrap_value"] if corr_bootstrap is None
         else corr_bootstrap),
        impl=impl)
    eps = cfg.eps_correction if cfg.correction == "eps" else 0.0
    pg = policy_gradient_loss(target_logits, batch["actions"], pg_adv, eps)
    bl = baseline_loss(values, vs)
    ent = entropy_loss(target_logits)
    total = pg + cfg.baseline_cost * bl + cfg.entropy_cost * ent
    metrics = _metrics(total, pg, bl, ent, vs, pg_adv)
    if per_traj:
        metrics["vtrace/traj_adv_mag"] = torch.mean(torch.abs(pg_adv), dim=1)
    return total, metrics


def _impala_loss_fused(cfg: ImpalaConfig, target_logits, values, batch,
                       rewards
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The same total from one K2 launch: target log-probs, per-step
    negative entropy, v_s targets and pg advantages; only the final
    reductions stay outside. Batch-major inputs are transposed to the
    kernel's time-major layout here."""
    def tm(x):
        return x.to(torch.float32).transpose(0, 1).contiguous()

    num_actions = target_logits.shape[-1]
    logits = tm(target_logits)
    # contiguous already, but for meta tensors (the dry run), whose
    # one_hot keeps the transposed strides
    onehot = F.one_hot(batch["actions"].long().transpose(0, 1),
                       num_actions).to(torch.float32).contiguous()
    values_f = values.to(torch.float32)
    v_tp1 = torch.cat(
        [values_f[:, 1:],
         batch["bootstrap_value"].to(torch.float32)[:, None]], dim=1)
    tlp, ne, vs, pg_adv = vtrace_kernels.fused_loss_vtrace(
        logits, onehot, tm(batch["behaviour_logprob"]),
        tm(batch["discounts"]), tm(rewards), tm(values_f.detach()),
        tm(v_tp1.detach()), cfg.rho_bar, cfg.c_bar, cfg.lambda_)
    pg = -torch.sum(pg_adv * tlp)
    bl = 0.5 * torch.sum(torch.square(vs - values_f.transpose(0, 1)))
    ent = torch.sum(ne)
    total = pg + cfg.baseline_cost * bl + cfg.entropy_cost * ent
    return total, _metrics(total, pg, bl, ent, vs, pg_adv)

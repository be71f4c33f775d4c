"""The IMPALA learner: batched V-trace actor-critic updates (paper §3, §4.2),
``repro.core.learner`` for the f32 conv-LSTM agents.

``build_train_step`` returns ``train_step(params, opt_state, step, batch)``
and ``build_replay_train_step`` its replay-path twin, which also takes the
target network's params. Both run eagerly: PyTorch needs no ``jit``. The
parameters are updated in place (``optim.apply_updates``); mixed
precision and the grad/apply split of learner groups are not ported yet
(ROADMAP.md, Queue 1 items 15 and 12).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ImpalaConfig
from repro_torch.core import corrections
from repro_torch.core import losses as losses_lib
from repro_torch.models import backbone as bb
from repro_torch.optim import optimizer as opt_lib
from repro_torch.params import tree_leaves, tree_unflatten_like

Tree = Any


def forward_trajectory(params, batch: Dict, arch_cfg: ArchConfig,
                       num_actions: int):
    """Run the backbone over the T+1 trajectory observations.

    Returns (logits (B,T+1,A), values (B,T+1))."""
    model_batch = {
        "image": batch["obs_image"],
        "last_action": batch["last_action"],
        "last_reward": batch["last_reward"],
        "done": batch["done_in"],
        "lstm_state": batch.get("lstm_state"),
    }
    out = bb.apply_train(params, model_batch, arch_cfg, num_actions)
    return out.policy_logits, out.values


def build_loss_fn(arch_cfg: ArchConfig, cfg: ImpalaConfig,
                  num_actions: int, vtrace_impl: str = "auto"):
    def loss_fn(params, batch):
        logits, values = forward_trajectory(params, batch, arch_cfg,
                                            num_actions)
        loss_batch = {
            "actions": batch["actions"],
            "rewards": batch["rewards"],
            "discounts": batch["discounts"],
            "behaviour_logprob": batch["behaviour_logprob"],
            "bootstrap_value": values[:, -1],
        }
        return losses_lib.impala_loss(cfg, logits[:, :-1], values[:, :-1],
                                      loss_batch, impl=vtrace_impl)

    return loss_fn


def _rmsprop(cfg: ImpalaConfig, optimizer):
    if optimizer is not None:
        return optimizer
    return opt_lib.rmsprop(decay=cfg.rmsprop_decay, eps=cfg.rmsprop_eps,
                           momentum=cfg.rmsprop_momentum)


def _step_fn(cfg: ImpalaConfig, optimizer, loss_fn):
    """``step_fn(params, opt_state, step, *loss_args)``: the gradient of
    ``loss_fn(params, *loss_args)`` through ``params`` only, clipped,
    applied in place."""
    lr_fn = opt_lib.linear_schedule(cfg.learning_rate, 0.0,
                                    cfg.lr_anneal_steps)

    def step_fn(params, opt_state, step, *loss_args):
        loss, metrics = loss_fn(params, *loss_args)
        grads = tree_unflatten_like(params, torch.autograd.grad(
            loss, tree_leaves(params)))
        lr = lr_fn(step)
        grads, grad_norm = opt_lib.clip_by_global_norm(
            grads, cfg.grad_clip_norm)
        updates, opt_state = optimizer.update(grads, opt_state, params, lr)
        params = opt_lib.apply_updates(params, updates)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["opt/grad_norm"] = grad_norm
        metrics["opt/lr"] = lr
        return params, opt_state, metrics

    return step_fn


def build_train_step(arch_cfg: ArchConfig, cfg: ImpalaConfig,
                     num_actions: int,
                     optimizer: opt_lib.Optimizer = None,
                     vtrace_impl: str = "auto",
                     ) -> Tuple[Callable[..., Tuple[Tree, Tree, Dict]],
                                opt_lib.Optimizer]:
    """vtrace_impl: 'auto' picks the fused kernel (K2) for CUDA params and
    the reverse loop for CPU params (``losses.resolve_vtrace_impl``);
    'fused' / 'pallas' / 'scan' / 'reference' pin an implementation."""
    optimizer = _rmsprop(cfg, optimizer)
    loss_fn = build_loss_fn(arch_cfg, cfg, num_actions, vtrace_impl)
    return _step_fn(cfg, optimizer, loss_fn), optimizer


def build_replay_loss_fn(arch_cfg: ArchConfig, cfg: ImpalaConfig,
                         num_actions: int, vtrace_impl: str = "auto"):
    """Replay-aware loss: ``loss_fn(params, target_params, batch)``.

    ``batch['replay_mask']`` (B,) flags replayed rows. The IMPACT recipe:
    replayed rows take the *target network's* values as the V-trace
    correction baseline (``corrections.replay_baseline_mix``), so K
    repeated consumptions chase a fixed target; online rows are the exact
    standard loss. The per-trajectory |pg advantage| metric
    (``vtrace/traj_adv_mag``) doubles as the replay priority signal. The
    target's forward runs without autograd: gradients flow only through
    ``params``. With ``auto`` the V-trace kernel (K1) runs on the card:
    the fused one (K2) assumes the correction baseline is the trained
    values."""
    def loss_fn(params, target_params, batch):
        logits, values = forward_trajectory(params, batch, arch_cfg,
                                            num_actions)
        with torch.no_grad():
            _, tvalues = forward_trajectory(target_params, batch, arch_cfg,
                                            num_actions)
        mask = batch["replay_mask"]
        corr_values = corrections.replay_baseline_mix(
            values[:, :-1], tvalues[:, :-1], mask)
        corr_bootstrap = corrections.replay_baseline_mix(
            values[:, -1], tvalues[:, -1], mask)
        loss_batch = {
            "actions": batch["actions"],
            "rewards": batch["rewards"],
            "discounts": batch["discounts"],
            "behaviour_logprob": batch["behaviour_logprob"],
            "bootstrap_value": values[:, -1],
        }
        return losses_lib.impala_loss(
            cfg, logits[:, :-1], values[:, :-1], loss_batch,
            impl=vtrace_impl, corr_values=corr_values,
            corr_bootstrap=corr_bootstrap, per_traj=True)

    return loss_fn


def build_replay_train_step(arch_cfg: ArchConfig, cfg: ImpalaConfig,
                            num_actions: int,
                            optimizer: opt_lib.Optimizer = None,
                            vtrace_impl: str = "auto",
                            ) -> Tuple[Callable[..., Tuple[Tree, Tree, Dict]],
                                       opt_lib.Optimizer]:
    """``train_step(params, target_params, opt_state, step, batch)``: the
    update of the replay path. Gradients flow only through ``params``,
    updated in place; ``target_params`` is a read-only periodic snapshot
    that no update writes."""
    optimizer = _rmsprop(cfg, optimizer)
    step_fn = _step_fn(cfg, optimizer, build_replay_loss_fn(
        arch_cfg, cfg, num_actions, vtrace_impl))

    def train_step(params, target_params, opt_state, step, batch):
        return step_fn(params, opt_state, step, target_params, batch)

    return train_step, optimizer

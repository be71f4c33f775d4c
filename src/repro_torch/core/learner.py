"""The IMPALA learner: batched V-trace actor-critic updates (paper §3, §4.2),
``repro.core.learner``, for the f32 conv-LSTM agents and the token
backbones. For an MoE backbone the loss adds ``aux_coef`` times the
routers' load-balancing loss times B*T (``loss/moe_aux``).

``build_train_step`` returns ``train_step(params, opt_state, step, batch)``
and ``build_replay_train_step`` its replay-path twin, which also takes the
target network's params. Both run eagerly: PyTorch needs no ``jit``. The
parameters are updated in place (``optim.apply_updates``).
``build_grad_apply_steps`` and ``build_replay_grad_apply_steps`` split the
same update at the gradient, for a learner group's exchange: the fused
step is the two halves composed. Mixed precision is not ported yet
(ROADMAP.md, Queue 1 item 15).
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
                       num_actions: int, impl: str = "auto"):
    """Run the backbone over the T+1 trajectory observations: the images
    and the LSTM's inputs, or the tokens ``obs_token`` (B, T+1) with the
    stub frontend's ``enc_embed``/``image_embed`` where the batch has
    them. ``impl`` is the route of the backbone's kernels (``ops``).

    Returns (logits (B,T+1,A), values (B,T+1), aux)."""
    if arch_cfg.family == "impala_cnn":
        model_batch = {
            "image": batch["obs_image"],
            "last_action": batch["last_action"],
            "last_reward": batch["last_reward"],
            "done": batch["done_in"],
            "lstm_state": batch.get("lstm_state"),
        }
    else:
        model_batch = {"tokens": batch["obs_token"]}
        for k in ("enc_embed", "image_embed"):
            if k in batch:
                model_batch[k] = batch[k]
    out = bb.apply_train(params, model_batch, arch_cfg, num_actions, impl)
    return out.policy_logits, out.values, out.aux_loss


def _add_moe_aux(arch_cfg: ArchConfig, aux_coef: float, total, metrics,
                 aux, batch):
    """The MoE backbones' loss: ``aux_coef * aux * B * T`` added to the
    summed V-trace loss, and ``loss/moe_aux`` reported."""
    if arch_cfg.moe is None:
        return total
    b, t = batch["actions"].shape[:2]
    metrics["loss/moe_aux"] = aux
    return total + aux_coef * aux * (b * t)


def build_loss_fn(arch_cfg: ArchConfig, cfg: ImpalaConfig,
                  num_actions: int, vtrace_impl: str = "auto",
                  aux_coef: float = 0.01, impl: str = "auto"):
    def loss_fn(params, batch):
        logits, values, aux = forward_trajectory(params, batch, arch_cfg,
                                                 num_actions, impl)
        loss_batch = {
            "actions": batch["actions"],
            "rewards": batch["rewards"],
            "discounts": batch["discounts"],
            "behaviour_logprob": batch["behaviour_logprob"],
            "bootstrap_value": values[:, -1],
        }
        total, metrics = losses_lib.impala_loss(
            cfg, logits[:, :-1], values[:, :-1], loss_batch,
            impl=vtrace_impl)
        return _add_moe_aux(arch_cfg, aux_coef, total, metrics, aux,
                            batch), metrics

    return loss_fn


def _rmsprop(cfg: ImpalaConfig, optimizer):
    if optimizer is not None:
        return optimizer
    return opt_lib.rmsprop(decay=cfg.rmsprop_decay, eps=cfg.rmsprop_eps,
                           momentum=cfg.rmsprop_momentum)


def _grad_fn(loss_fn):
    """``grad_step(params, *loss_args) -> (grad leaves, metrics)``: the
    gradient of ``loss_fn(params, *loss_args)`` through ``params`` only,
    as a list in the tree's flatten order (``tree_leaves``). A leaf the
    loss does not reach gets zeros, as ``jax.grad`` gives."""
    def grad_step(params, *loss_args):
        loss, metrics = loss_fn(params, *loss_args)
        leaves = tree_leaves(params)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return grads, {k: v.detach() for k, v in metrics.items()}

    return grad_step


def _apply_fn(cfg: ImpalaConfig, optimizer):
    """``apply_step(params, opt_state, step, grads) -> (params, opt_state,
    metrics)``: clip ``grads`` (leaves in flatten order, or a tree like
    ``params``) by their global norm and apply the optimizer in place."""
    lr_fn = opt_lib.linear_schedule(cfg.learning_rate, 0.0,
                                    cfg.lr_anneal_steps)

    def apply_step(params, opt_state, step, grads):
        if isinstance(grads, (list, tuple)):
            grads = tree_unflatten_like(params, grads)
        lr = lr_fn(step)
        grads, grad_norm = opt_lib.clip_by_global_norm(
            grads, cfg.grad_clip_norm)
        updates, opt_state = optimizer.update(grads, opt_state, params, lr)
        params = opt_lib.apply_updates(params, updates)
        return params, opt_state, {"opt/grad_norm": grad_norm, "opt/lr": lr}

    return apply_step


def _step_fn(cfg: ImpalaConfig, optimizer, loss_fn):
    """``step_fn(params, opt_state, step, *loss_args)``: ``_grad_fn``'s
    half, then ``_apply_fn``'s, on the same tensors."""
    grad_step = _grad_fn(loss_fn)
    apply_step = _apply_fn(cfg, optimizer)

    def step_fn(params, opt_state, step, *loss_args):
        grads, metrics = grad_step(params, *loss_args)
        params, opt_state, ametrics = apply_step(params, opt_state, step,
                                                 grads)
        metrics.update(ametrics)
        return params, opt_state, metrics

    return step_fn


def build_train_step(arch_cfg: ArchConfig, cfg: ImpalaConfig,
                     num_actions: int,
                     optimizer: opt_lib.Optimizer = None,
                     vtrace_impl: str = "auto", impl: str = "auto",
                     ) -> Tuple[Callable[..., Tuple[Tree, Tree, Dict]],
                                opt_lib.Optimizer]:
    """vtrace_impl: 'auto' picks the fused kernel (K2) for CUDA params and
    the reverse loop for CPU params (``losses.resolve_vtrace_impl``);
    'fused' / 'pallas' / 'scan' / 'reference' pin an implementation.
    ``impl`` is the route of the backbone's kernels (K3's, ``ops``)."""
    optimizer = _rmsprop(cfg, optimizer)
    loss_fn = build_loss_fn(arch_cfg, cfg, num_actions, vtrace_impl,
                            impl=impl)
    return _step_fn(cfg, optimizer, loss_fn), optimizer


def build_replay_loss_fn(arch_cfg: ArchConfig, cfg: ImpalaConfig,
                         num_actions: int, vtrace_impl: str = "auto",
                         aux_coef: float = 0.01):
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
        logits, values, aux = forward_trajectory(params, batch, arch_cfg,
                                                 num_actions)
        with torch.no_grad():
            _, tvalues, _ = forward_trajectory(target_params, batch,
                                               arch_cfg, num_actions)
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
        total, metrics = losses_lib.impala_loss(
            cfg, logits[:, :-1], values[:, :-1], loss_batch,
            impl=vtrace_impl, corr_values=corr_values,
            corr_bootstrap=corr_bootstrap, per_traj=True)
        return _add_moe_aux(arch_cfg, aux_coef, total, metrics, aux,
                            batch), metrics

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


def build_grad_apply_steps(arch_cfg: ArchConfig, cfg: ImpalaConfig,
                           num_actions: int,
                           optimizer: opt_lib.Optimizer = None,
                           vtrace_impl: str = "auto"):
    """``train_step`` split at the gradient, for a learner group:
    ``grad_step(params, batch) -> (grad leaves, metrics)`` and
    ``apply_step(params, opt_state, step, grads) -> (params, opt_state,
    metrics)``, with the group's mean between the two halves.

    Clipping happens in ``apply_step``, on the exchanged mean, so every
    replica clips the same broadcast values and applies the same update.
    ``apply_step`` updates ``params`` and ``opt_state`` in place.
    Composing the halves locally is ``build_train_step``'s step, bit for
    bit: it is built from them."""
    optimizer = _rmsprop(cfg, optimizer)
    grad_step = _grad_fn(build_loss_fn(arch_cfg, cfg, num_actions,
                                       vtrace_impl))
    return grad_step, _apply_fn(cfg, optimizer), optimizer


def build_replay_grad_apply_steps(arch_cfg: ArchConfig, cfg: ImpalaConfig,
                                  num_actions: int,
                                  optimizer: opt_lib.Optimizer = None,
                                  vtrace_impl: str = "auto"):
    """The replay path's split: ``grad_step(params, target_params, batch)``
    and the same ``apply_step`` as ``build_grad_apply_steps``."""
    optimizer = _rmsprop(cfg, optimizer)
    grad_step = _grad_fn(build_replay_loss_fn(arch_cfg, cfg, num_actions,
                                              vtrace_impl))
    return grad_step, _apply_fn(cfg, optimizer), optimizer

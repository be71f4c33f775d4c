"""The IMPALA learner: batched V-trace actor-critic updates (paper §3, §4.2),
``repro.core.learner``, for the f32 conv-LSTM agents and the token
backbones. For an MoE backbone the loss adds ``aux_coef`` times the
routers' load-balancing loss times B*T (``loss/moe_aux``).

``build_train_step`` returns ``train_step(params, opt_state, step, batch)``
and ``build_replay_train_step`` its replay-path twin, which also takes the
target network's params. Both run eagerly: PyTorch needs no ``jit``. The
parameters are updated in place, one leaf at a time (``_apply_fn``).
``build_grad_apply_steps`` and ``build_replay_grad_apply_steps`` split the
same update at the gradient, for a learner group's exchange: the fused
step is the two halves composed. ``build_spmd_train_step`` and
``build_spmd_replay_train_step`` are the SPMD learner's step: run on every
rank of a ``torch.distributed`` group, each on its rows of the batch, with
the gradients' mean all-reduced inside the step.

``build_train_step(..., mixed_precision=True)`` is JAX's mixed-precision
step: bf16 live params, ``opt_state = {"opt": <optimizer state>,
"master": <f32 params>}``, the bf16 gradients cast to f32 and clipped by
their global norm, the optimizer run on the master, and the live leaves
set to ``bf16(master)``. Every step's apply half runs leaf by leaf
(``_apply_fn``), so no whole f32 tree of clipped gradients or updates is
held: that is what fits qwen1.5-4b's mixed step on one 80 GB card. The
optimizer's state must therefore mirror the params (``_optimizer``).
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


def _optimizer(cfg: ImpalaConfig, optimizer):
    """``optimizer``, or the paper's RMSProp from ``cfg`` where it is
    None. The apply step runs the optimizer one leaf at a time
    (``_apply_fn``), so its state must be trees that mirror the params,
    as RMSProp's is: one with other state, as Adam's step count, is
    refused here, where JAX's learner takes any optimizer."""
    if optimizer is None:
        return opt_lib.rmsprop(decay=cfg.rmsprop_decay, eps=cfg.rmsprop_eps,
                               momentum=cfg.rmsprop_momentum)
    probe = {"a": torch.zeros(1), "b": torch.zeros(2)}
    shapes = [x.shape for x in tree_leaves(probe)]
    state = optimizer.init(probe)
    odd = ([k for k, v in state.items() if not isinstance(v, dict)
            or [x.shape for x in tree_leaves(v)] != shapes]
           if isinstance(state, dict) else [type(state).__name__])
    if odd:
        raise ValueError(f"the learner applies the optimizer one leaf at a "
                         f"time: its state must be trees that mirror the "
                         f"params, as RMSProp's is; {odd} do not")
    return optimizer


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


def _leaf_slots(tree: Tree) -> list:
    """(dict, key) of each leaf of a nested dict, in flatten order: where
    a leaf can be replaced in the tree itself."""
    return [slot for k in sorted(tree)
            for slot in (_leaf_slots(tree[k]) if isinstance(tree[k], dict)
                         else [(tree, k)])]


def _apply_fn(cfg: ImpalaConfig, optimizer, mixed: bool = False,
              grad_norm: Callable = None):
    """``apply_step(params, opt_state, step, grads) -> (params, opt_state,
    metrics)``: clip ``grads`` (leaves in flatten order, or a tree like
    ``params``) by their global norm and apply the optimizer, in place.

    The global norm is taken over every gradient first (in f32, in
    flatten order). Then one leaf at a time: its gradient cast to f32 and
    scaled by the clip, the optimizer's state and update of that leaf, and
    ``master += update``. The new state leaves replace the old ones in
    the state's dicts, and each gradient leaves a ``grads`` list once
    used, so no whole tree of clipped gradients, state or updates is held
    beside the old one. ``mixed``: ``params`` is the bf16 live tree,
    ``opt_state = {"opt": <optimizer state>, "master": <f32 tree>}``, and
    each live leaf is then set to ``bf16(master)``; otherwise the master
    is ``params`` and the state is ``opt_state``. ``grad_norm(params,
    grads)`` gives the global norm where the gradients of a rank are not
    the whole tree's (the expert-parallel step's); by default, theirs."""
    lr_fn = opt_lib.linear_schedule(cfg.learning_rate, 0.0,
                                    cfg.lr_anneal_steps)

    def apply_step(params, opt_state, step, grads):
        lr = lr_fn(step)
        if isinstance(grads, tuple):
            grads = list(grads)
        elif not isinstance(grads, list):
            grads = tree_leaves(grads)
        live = tree_leaves(params)
        master = tree_leaves(opt_state["master"]) if mixed else live
        state = opt_state["opt"] if mixed else opt_state
        slots = {k: _leaf_slots(v) for k, v in state.items()}
        norm = opt_lib.global_norm(tree_unflatten_like(params, grads)) \
            if grad_norm is None else grad_norm(params, grads)
        scale = opt_lib.clip_scale(norm, cfg.grad_clip_norm)
        for i, (p, m) in enumerate(zip(live, master)):
            at = {k: s[i] for k, s in slots.items()}
            g = grads[i].to(torch.float32) * scale
            grads[i] = None
            update, new = optimizer.update(
                g, {k: d[key] for k, (d, key) in at.items()}, m, lr)
            for k, (d, key) in at.items():
                d[key] = new[k]
            with torch.no_grad():
                m.add_(update.to(m.dtype))
                if mixed:
                    p.copy_(m)
        return params, opt_state, {"opt/grad_norm": norm, "opt/lr": lr}

    return apply_step


def _step_fn(grad_step, apply_step):
    """``step_fn(params, opt_state, step, *loss_args)``: ``grad_step``,
    then ``apply_step``, on the same tensors."""
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
                     mixed_precision: bool = False,
                     grad_norm: Callable = None,
                     ) -> Tuple[Callable[..., Tuple[Tree, Tree, Dict]],
                                opt_lib.Optimizer]:
    """vtrace_impl: 'auto' picks the fused kernel (K2) for CUDA params and
    the reverse loop for CPU params (``losses.resolve_vtrace_impl``);
    'fused' / 'pallas' / 'scan' / 'reference' pin an implementation.
    ``impl`` is the route of the backbone's kernels (K3's, ``ops``).

    mixed_precision: ``train_step`` takes bf16 live ``params`` and
    ``opt_state = {"opt": optimizer.init(master), "master": master}``
    with the f32 ``master``, and returns them in that form: the live and
    master leaves updated in place, the state's leaves replaced in its
    dicts (``_apply_fn``). The live tree is
    ``common.cast(master, torch.bfloat16)`` of a master whose leaves
    require grad, as ``params.from_jax`` gives them.

    grad_norm: the clip's global norm where a rank holds part of the
    tree (``_apply_fn``)."""
    optimizer = _optimizer(cfg, optimizer)
    grad_step = _grad_fn(build_loss_fn(arch_cfg, cfg, num_actions,
                                       vtrace_impl, impl=impl))
    return _step_fn(grad_step, _apply_fn(cfg, optimizer, mixed_precision,
                                         grad_norm)), optimizer


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
    optimizer = _optimizer(cfg, optimizer)
    grad_step = _grad_fn(build_replay_loss_fn(arch_cfg, cfg, num_actions,
                                              vtrace_impl))
    step_fn = _step_fn(grad_step, _apply_fn(cfg, optimizer))

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
    optimizer = _optimizer(cfg, optimizer)
    grad_step = _grad_fn(build_loss_fn(arch_cfg, cfg, num_actions,
                                       vtrace_impl))
    return grad_step, _apply_fn(cfg, optimizer), optimizer


def build_replay_grad_apply_steps(arch_cfg: ArchConfig, cfg: ImpalaConfig,
                                  num_actions: int,
                                  optimizer: opt_lib.Optimizer = None,
                                  vtrace_impl: str = "auto"):
    """The replay path's split: ``grad_step(params, target_params, batch)``
    and the same ``apply_step`` as ``build_grad_apply_steps``."""
    optimizer = _optimizer(cfg, optimizer)
    grad_step = _grad_fn(build_replay_loss_fn(arch_cfg, cfg, num_actions,
                                              vtrace_impl))
    return grad_step, _apply_fn(cfg, optimizer), optimizer


def _data_group(mesh):
    """The process group of the SPMD step's ``data`` axis (or only axis)
    of ``mesh``: a ``DeviceMesh``, or a ``launch.mesh.Mesh`` whose group
    is up."""
    from torch.distributed.device_mesh import DeviceMesh

    dm = mesh if isinstance(mesh, DeviceMesh) else mesh.group_mesh()
    if dm is None:
        raise RuntimeError(f"the SPMD step runs over a process group: bring "
                           f"it up and build the mesh's DeviceMesh "
                           f"(Mesh.device_mesh) first; {mesh} has none")
    names = dm.mesh_dim_names or ()
    return dm.get_group("data" if "data" in names else 0)


def _shapes(tree) -> Tuple:
    """The nesting and leaf shapes of a batch, hashable."""
    if isinstance(tree, dict):
        return tuple((k, _shapes(tree[k])) for k in sorted(tree))
    if isinstance(tree, (tuple, list)):
        return tuple(_shapes(x) for x in tree)
    return tuple(getattr(tree, "shape", ()))


def _spmd_step(grad_step, apply_step, mesh, batch_replicated: bool,
               per_traj: bool = False):
    """``step(params, opt_state, step, *loss_args)``: the rank's gradient
    and metrics, their mean over the group, and ``apply_step`` of the mean
    on every rank.

    One flat f32 buffer holds the gradient leaves (flatten order), the
    scalar metrics (sorted by name) and, with ``per_traj``, the rank's
    ``vtrace/traj_adv_mag`` rows written at their place in the global
    (B,) vector, zeros elsewhere. Sharded, one ``all_reduce`` sums it
    over the ranks; the gradients and metrics are then divided by N (the
    reference's ``_mean_leaves``: the sum, then one division) and the
    vector is the concatenation of the ranks' rows, in row order.
    ``batch_replicated``: every rank has the whole batch, so every
    gradient is the same and their mean is any one of them: rank 0's is
    broadcast, which keeps the replicas bit identical whatever the card's
    reduction order. The other ranks skip the backward pass: they
    receive into a buffer of the size their first call on a batch of
    that shape measured (the metrics' names and the vector's rows are
    the loss's, not the data's)."""
    import torch.distributed as dist

    pg = _data_group(mesh)
    n = dist.get_world_size(pg)
    rank = dist.get_rank(pg)
    src = dist.get_global_rank(pg, 0)
    # receive-only ranks of the replicated step: batch shapes -> (metric
    # names, vector rows), from the first call that computed them
    seen: Dict[Tuple, Tuple[list, int]] = {}

    def apply_mean(params, opt_state, step, flat, keys, rows):
        leaves = tree_leaves(params)
        pieces = flat.split([p.numel() for p in leaves] + [len(keys), rows])
        mean = [x.view_as(p) for x, p in zip(pieces, leaves)]
        metrics = {k: pieces[-2][i] for i, k in enumerate(keys)}
        if per_traj:
            metrics["vtrace/traj_adv_mag"] = pieces[-1]
        params, opt_state, ametrics = apply_step(params, opt_state, step,
                                                 mean)
        metrics.update(ametrics)
        return params, opt_state, metrics

    def step_fn(params, opt_state, step, *loss_args):
        shapes = (_shapes(loss_args[-1]) if batch_replicated and rank != 0
                  else None)
        if shapes in seen:
            keys, rows = seen[shapes]
            flat = torch.empty(
                sum(p.numel() for p in tree_leaves(params)) + len(keys)
                + rows, dtype=torch.float32, device=tree_leaves(params)[0].device)
            dist.broadcast(flat, src, group=pg)
            return apply_mean(params, opt_state, step, flat, keys, rows)
        grads, metrics = grad_step(params, *loss_args)
        traj = metrics.pop("vtrace/traj_adv_mag") if per_traj else None
        keys = sorted(metrics)
        parts = [g.reshape(-1).to(torch.float32) for g in grads]
        del grads
        parts.append(torch.stack([metrics[k].to(torch.float32).reshape(())
                                  for k in keys]))
        rows = 0
        if traj is not None:
            rows = traj.shape[0] * (1 if batch_replicated else n)
            glob = traj.new_zeros(rows, dtype=torch.float32)
            at = 0 if batch_replicated else rank * traj.shape[0]
            glob[at:at + traj.shape[0]] = traj
            parts.append(glob)
        flat = torch.cat(parts)
        del parts
        if shapes is not None:
            seen[shapes] = (keys, rows)
        if batch_replicated:
            dist.broadcast(flat, src, group=pg)
        else:
            dist.all_reduce(flat, group=pg)
            flat[:flat.numel() - rows].div_(n)
        return apply_mean(params, opt_state, step, flat, keys, rows)

    return step_fn


def build_spmd_train_step(arch_cfg: ArchConfig, cfg: ImpalaConfig,
                          num_actions: int, mesh,
                          optimizer: opt_lib.Optimizer = None,
                          vtrace_impl: str = "auto",
                          batch_replicated: bool = False,
                          ) -> Tuple[Callable[..., Tuple[Tree, Tree, Dict]],
                                     opt_lib.Optimizer]:
    """The SPMD learner's ``train_step(params, opt_state, step, batch)``,
    called on every rank of a process group at once: ``mesh`` is the
    ``('data',)`` mesh over any group the caller brought up (a
    ``launch.mesh.Mesh`` whose ``device_mesh`` is built, or a
    ``DeviceMesh``). Each rank passes its own rows of the batch (rank r of N the r-th
    N-th of the trajectory axis), computes the gradient of its shard's
    sum loss (``grad_step``, K2 on the card with ``auto``), and the
    gradients and scalar metrics are averaged over the ranks in one
    all-reduce (``_spmd_step``); every rank then applies the same mean
    (``_apply_fn``: the clip on the mean, then RMSProp), in place.

    That is the documented semantics of the reference's
    ``build_spmd_train_step``: the update an N-learner group computes from
    the same shards, clip after average. (Under jax 0.9 its ``shard_map``
    step applies the shards' sum instead; the port follows the
    documentation and the reference's split route, ``grad_step`` on each
    shard, the mean, ``apply_step``.)

    ``batch_replicated=True`` is the divisibility fallback: every rank
    passes the whole batch, and the update equals the one-device fused
    step on it."""
    optimizer = _optimizer(cfg, optimizer)
    grad_step = _grad_fn(build_loss_fn(arch_cfg, cfg, num_actions,
                                       vtrace_impl))
    return _spmd_step(grad_step, _apply_fn(cfg, optimizer), mesh,
                      batch_replicated), optimizer


def build_spmd_replay_train_step(arch_cfg: ArchConfig, cfg: ImpalaConfig,
                                 num_actions: int, mesh,
                                 optimizer: opt_lib.Optimizer = None,
                                 vtrace_impl: str = "auto",
                                 batch_replicated: bool = False,
                                 ) -> Tuple[Callable[..., Tuple[Tree, Tree,
                                                                Dict]],
                                            opt_lib.Optimizer]:
    """The SPMD variant of ``build_replay_train_step``:
    ``train_step(params, target_params, opt_state, step, batch)`` on every
    rank, the batch (``replay_mask`` included: it is row data) split over
    the ranks as ``build_spmd_train_step``'s. The per-trajectory
    ``vtrace/traj_adv_mag`` comes back as the global (B,) vector, in row
    order, on every rank, so the replay's re-scoring sees every
    trajectory."""
    optimizer = _optimizer(cfg, optimizer)
    grad_step = _grad_fn(build_replay_loss_fn(arch_cfg, cfg, num_actions,
                                              vtrace_impl))
    step_fn = _spmd_step(grad_step, _apply_fn(cfg, optimizer), mesh,
                         batch_replicated, per_traj=True)

    def train_step(params, target_params, opt_state, step, batch):
        return step_fn(params, opt_state, step, target_params, batch)

    return train_step, optimizer


def opt_state_specs(param_specs: Tree, cfg: ImpalaConfig,
                    mixed_precision: bool = False) -> Tree:
    """The optimizer state's tree, mirroring ``param_specs`` (any tree:
    specs, shapes or tensors), as ``repro.core.learner.opt_state_specs``
    builds it: RMSProp's ``ms`` (and ``mom`` with momentum), under
    ``opt`` beside the f32 ``master`` in mixed precision. Its leaves'
    placements under sharding rules are ``common.param_shardings`` of
    this tree."""
    inner = ({"ms": param_specs, "mom": param_specs}
             if cfg.rmsprop_momentum else {"ms": param_specs})
    if mixed_precision:
        return {"opt": inner, "master": param_specs}
    return inner

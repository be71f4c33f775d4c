"""Step builders and abstract input specs for every (arch x input shape)
(``repro.launch.steps``).

``build_steps`` gives the step functions that the dry run traces and
that run on the card: the learner's train step, the backbone's prefill
and one served decode step, each under ``use_rules``. ``input_specs``
gives every input of a step as ``meta`` tensors (shapes and dtypes, no
storage), and ``trace_pair`` runs the step on them at full size, in
place of the reference's ``lower_pair`` (``jit(...).lower``): the port
has no compiler to lower to, so the dry run counts the eager step
(``roofline.analysis.eager_cost``).

Step kinds:
  train_4k     -> train     (V-trace actor-critic update)
  prefill_32k  -> prefill   (actor context ingestion, builds the cache)
  decode_32k   -> serve     (ONE action with a seq_len cache)
  long_500k    -> serve     (sub-quadratic archs only)

The serve step samples from an explicit ``torch.Generator`` that the
caller passes, where the reference's takes JAX key data (``rng``, two
uint32 words). ``input_specs`` keeps that leaf, a (2,) uint32 meta
tensor with the reference's logical axes (``batch_logical_axes``), so
that both input trees agree; the port's step reads the generator in its
place.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils._pytree import tree_leaves as pytree_leaves

from repro_torch.configs.base import ArchConfig, ImpalaConfig, InputShape
from repro_torch.core import actor as actor_lib
from repro_torch.core import learner as learner_lib
from repro_torch.kernels import meta as kernel_meta
from repro_torch.models import backbone as bb
from repro_torch.models import common
from repro_torch.params import tree_leaves, tree_map
from repro_torch.roofline import analysis, memory_model
from repro_torch.sharding.rules import Rules, use_rules

Tree = Any

NUM_ACTIONS = 18  # full Atari action set (paper §5.3.2)


# ---------------------------------------------------------------------------
# Applicability


def decode_cache_len(arch: ArchConfig, seq_len: int) -> int:
    """Context a decode step actually has to hold."""
    if arch.sliding_window:
        return min(arch.sliding_window, seq_len)
    return seq_len


def pair_supported(arch: ArchConfig, shape: InputShape) -> Tuple[bool, str]:
    """Is (arch, shape) runnable? long_500k needs sub-quadratic context."""
    if shape.name != "long_500k":
        return True, ""
    if arch.family in ("ssm", "hybrid"):
        return True, ""
    if arch.sliding_window:
        return True, ""
    return False, ("full quadratic attention cannot hold a 524288-token KV "
                   "cache; runnable only for SSM/hybrid/sliding-window "
                   "variants (DESIGN.md §Arch-applicability)")


# ---------------------------------------------------------------------------
# Abstract inputs


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _stub_inputs(arch: ArchConfig, batch: int) -> Dict[str, torch.Tensor]:
    dtype = common.torch_dtype(arch.dtype)
    if arch.family == "audio":
        return {"enc_embed": _meta((batch, arch.encoder_seq_len,
                                    arch.d_model), dtype)}
    if arch.family == "vlm":
        return {"image_embed": _meta((batch, arch.encoder_seq_len,
                                      arch.d_model), dtype)}
    return {}


def input_specs(arch: ArchConfig, shape: InputShape) -> Dict[str, Any]:
    """``meta`` stand-ins for every model input of this step."""
    b, s = shape.global_batch, shape.seq_len
    f32, i32 = torch.float32, torch.int32
    if shape.kind == "train":
        t = s - 1  # s observations, s-1 transitions
        specs = {
            "obs_token": _meta((b, s), i32),
            "actions": _meta((b, t), i32),
            "rewards": _meta((b, t), f32),
            "discounts": _meta((b, t), f32),
            "behaviour_logprob": _meta((b, t), f32),
        }
        specs.update(_stub_inputs(arch, b))
        return specs
    if shape.kind == "prefill":
        specs = {"tokens": _meta((b, s), i32)}
        specs.update(_stub_inputs(arch, b))
        return specs
    if shape.kind == "decode":
        return {
            "token": _meta((b, 1), i32),
            "cache_index": _meta((), i32),
            # the reference's key data; the port's serve step takes a
            # torch.Generator in its place
            "rng": _meta((2,), torch.uint32),
            "cache": bb.cache_abstract(b, decode_cache_len(arch, s), arch),
        }
    raise ValueError(shape.kind)


# ---------------------------------------------------------------------------
# Sharding resolution


def batch_logical_axes(arch: ArchConfig, shape: InputShape) -> Dict[str, Any]:
    stub = {"enc_embed": ("batch", None, None),
            "image_embed": ("batch", None, None)}
    if shape.kind == "train":
        ax = {
            "obs_token": ("batch", None),
            "actions": ("batch", None),
            "rewards": ("batch", None),
            "discounts": ("batch", None),
            "behaviour_logprob": ("batch", None),
        }
    elif shape.kind == "prefill":
        ax = {"tokens": ("batch", None)}
    else:
        ax = {
            "token": ("batch", None),
            "cache_index": (),
            "rng": (None,),            # replicated, as the generator is
            "cache": bb.cache_logical_axes(arch),
        }
    for k in ("enc_embed", "image_embed"):
        if k in input_specs(arch, shape):
            ax[k] = stub[k]
    return ax


def tree_shardings(abstract: Tree, axes: Tree, rules: Rules) -> Tree:
    """Each leaf's DTensor placements (``Rules.placements``)."""
    return tree_map(lambda sd, ax: rules.placements(ax, sd.shape), abstract,
                    axes)


def tree_shard_bytes(abstract: Tree, axes: Tree, rules: Rules) -> int:
    """The bytes of ``abstract`` one device holds under ``rules``."""
    return sum(sd.numel() * sd.element_size() // rules.shards(ax, sd.shape)
               for sd, ax in zip(tree_leaves(abstract), tree_leaves(axes)))


# ---------------------------------------------------------------------------
# Step functions


def make_impala_config() -> ImpalaConfig:
    return ImpalaConfig(num_actions=NUM_ACTIONS, learning_rate=6e-4)


def build_steps(arch: ArchConfig, rules: Rules, vtrace_impl: str = "auto",
                mixed_precision: bool = False) -> Dict[str, Any]:
    """Step functions closed over the configs and ``rules``:

    * ``train(params, opt_state, step, batch)``: the learner's step
      (``build_train_step``; ``vtrace_impl='auto'`` is K2 on the card and
      on meta tensors), updating ``params`` and ``opt_state`` in place;
    * ``prefill(params, batch)`` -> policy_logits, values, cache;
    * ``serve(params, token, cache, cache_index, gen)`` -> one action
      drawn from ``gen`` (Gumbel-max, as ``jax.random.categorical``), its
      behaviour log-prob, the value, the cache, written in place, and
      the policy logits it drew from;

    with the ``optimizer`` and the ``icfg``. Prefill and serve run under
    ``torch.no_grad()``.

    Where an MoE config's experts are split over the rules' mesh
    (``dispatch_impl='shard_map_a2a'``), each rank holds its experts'
    slices and the replicated rest: the train step clips to the whole
    tree's global norm, its expert leaves' squares summed over the expert
    axis (``expert_parallel_norm``), over the group that is up when the
    step runs. Its batch axis must then be one rank: the data-parallel
    mean of the gradients is the SPMD learner's
    (``build_spmd_train_step``)."""
    icfg = make_impala_config()
    grad_norm = expert_parallel_norm(arch, rules)
    train_step_raw, optimizer = learner_lib.build_train_step(
        arch, icfg, NUM_ACTIONS, vtrace_impl=vtrace_impl,
        mixed_precision=mixed_precision, grad_norm=grad_norm)

    def train_step(params, opt_state, step, batch):
        if grad_norm is not None and _group_mesh(rules) is not None and \
                memory_model.batch_shards(rules) > 1:
            raise NotImplementedError(
                f"the expert-parallel train step on a "
                f"{dict(rules.mesh.shape)} mesh: its batch axis spans "
                f"ranks, and the data-parallel mean of the gradients is "
                f"the SPMD learner's (build_spmd_train_step)")
        with use_rules(rules):
            return train_step_raw(params, opt_state, step, batch)

    def prefill_step(params, batch):
        with use_rules(rules), torch.no_grad():
            out = bb.apply_prefill(params, batch, arch, NUM_ACTIONS)
        return {"policy_logits": out.policy_logits, "values": out.values,
                "cache": out.cache}

    def serve_step(params, token, cache, cache_index: int,
                   gen: torch.Generator):
        with use_rules(rules), torch.no_grad():
            out = bb.apply_decode(params, token, cache, cache_index, arch,
                                  NUM_ACTIONS)
            logits = out.policy_logits[:, 0]
            action = actor_lib.sample(gen, logits)
            blp = actor_lib.action_logprob(logits, action)
        return {"action": action, "behaviour_logprob": blp,
                "value": out.values[:, 0], "cache": out.cache,
                "policy_logits": logits}

    return {"train": train_step, "prefill": prefill_step,
            "serve": serve_step, "optimizer": optimizer, "icfg": icfg}


def _group_mesh(rules: Rules):
    """The rules' mesh's DeviceMesh while its process group is up, else
    None (``Mesh.group_mesh``)."""
    mesh = rules.mesh
    return mesh.group_mesh() if hasattr(mesh, "group_mesh") else None


def expert_parallel_norm(arch: ArchConfig, rules: Rules):
    """The train step's ``grad_norm`` for ``arch`` under ``rules``: None
    (the rank's own tree's norm) unless the experts are split over the
    rules' mesh; then a function of ``(params, grads)`` that sums the
    squares of the expert FFN leaves (``moe.expert_leaf``, the slices
    ``rank_expert_keep`` cuts) over the expert axis and adds the
    replicated leaves' once. It looks the group up on each call, as
    ``moe._apply_moe_shard_map`` does: with none up, the gradients must be
    ``meta`` (one expert rank's count, no collective), and their own norm
    is the clip's."""
    import torch.distributed as dist

    from repro_torch.models import moe
    from repro_torch.optim import optimizer as opt_lib
    from repro_torch.params import flatten, tree_unflatten_like

    if arch.moe is None or arch.moe.dispatch_impl != "shard_map_a2a" or \
            moe.expert_shards(rules) == 1:
        return None
    experts = {k for k, spec in flatten(
        bb.backbone_specs(arch, NUM_ACTIONS)).items()
        if moe.expert_leaf(tuple(k.split("/")), spec)}

    def norm(params, grads):
        dm = _group_mesh(rules)
        if dm is None:
            if grads[0].device.type != "meta":
                raise RuntimeError(
                    f"the expert-parallel train step on a "
                    f"{dict(rules.mesh.shape)} mesh clips over its process "
                    f"group: bring it up and build the mesh's DeviceMesh "
                    f"(Mesh.device_mesh) first")
            return opt_lib.global_norm(tree_unflatten_like(params, grads))
        sq = [torch.sum(torch.square(g.to(torch.float32))) for g in grads]
        keys = list(flatten(params))
        split = torch.stack([q for k, q in zip(keys, sq, strict=True)
                             if k in experts]).sum()
        dist.all_reduce(split, group=dm.get_group(moe.expert_axis(rules)))
        rest = [q for k, q in zip(keys, sq) if k not in experts]
        return torch.sqrt(torch.stack(rest).sum() + split)

    return norm


# ---------------------------------------------------------------------------
# Tracing for the dry run


def local_shape(shape: InputShape, rules: Rules) -> InputShape:
    """``shape`` with its batch cut to one batch shard (at least one row:
    a batch smaller than its shards is replicated)."""
    return InputShape(shape.name, shape.seq_len,
                      max(shape.global_batch //
                          memory_model.batch_shards(rules), 1),
                      shape.kind)


def trace_pair(arch: ArchConfig, shape: InputShape, mesh, rules: Rules,
               vtrace_impl: str = "auto", mixed_precision: bool = False):
    """Run (not lower) the right step for (arch, shape) on ``meta``
    tensors at one device's share of the batch (``local_shape``), the
    model axis unsharded, and count it (``eager_cost``).

    Returns ``(cost, meta)``: ``meta["params"]`` is the parameter count,
    as the reference's; ``argument_bytes`` the per-device bytes of the
    step's arguments at the global shape under ``rules`` (params, the
    optimizer state and the batch or cache); ``output_bytes`` the bytes
    of what the traced step returned; ``local_batch`` the batch traced.
    """
    del mesh                            # the rules carry it
    steps = build_steps(arch, rules, vtrace_impl, mixed_precision)
    specs = bb.backbone_specs(arch, NUM_ACTIONS)
    params = common.abstract_params(specs)
    local = local_shape(shape, rules)
    batch = input_specs(arch, local)
    axes = batch_logical_axes(arch, shape)
    arg_bytes = tree_shard_bytes(input_specs(arch, shape), axes, rules)
    live_specs = specs
    if mixed_precision:
        # live params are bf16 leaves; the f32 master sits in opt_state
        live_specs = tree_map(lambda s: common.Spec(
            s.shape, s.logical, s.init, "bfloat16", s.scale), specs)
    arg_bytes += tree_shard_bytes(common.abstract_params(live_specs),
                                  tree_map(lambda s: s.logical, specs),
                                  rules)
    result = {}
    if shape.kind == "train":
        opt_specs = learner_lib.opt_state_specs(specs, steps["icfg"],
                                                mixed_precision)
        opt_state = common.abstract_params(opt_specs)
        arg_bytes += tree_shard_bytes(
            opt_state, tree_map(lambda s: s.logical, opt_specs), rules)
        master = opt_state["master"] if mixed_precision else params
        for leaf in tree_leaves(master):
            leaf.requires_grad_(True)
        if mixed_precision:
            params = common.cast(master, torch.bfloat16)

        def run():
            result["out"] = steps["train"](params, opt_state, 0, batch)
    elif shape.kind == "prefill":
        def run():
            result["out"] = steps["prefill"](params, batch)
    else:
        gen = torch.Generator().manual_seed(0)

        def run():
            result["out"] = steps["serve"](params, batch["token"],
                                           batch["cache"], shape.seq_len - 1,
                                           gen)
    cost = analysis.eager_cost(run)
    outs = [x for x in pytree_leaves(result["out"])
            if isinstance(x, torch.Tensor)]
    return cost, {"params": common.param_count(specs),
                  "argument_bytes": arg_bytes,
                  "output_bytes": kernel_meta.nbytes(outs),
                  "local_batch": local.global_batch}

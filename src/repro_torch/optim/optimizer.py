"""Hand-written optimizer stack (``repro.optim.optimizer``).

The paper's learner uses RMSProp (momentum 0, tunable epsilon, decay .99)
with global-norm gradient clipping and an (optionally linearly annealed)
learning rate. The RMSProp is TF-style, ``g * rsqrt(ms + eps)`` with eps
inside the root; ``torch.optim.RMSprop`` computes ``g / (sqrt(ms) + eps)``
and does not match it.

Transforms take and return trees (nested dicts of tensors, see
``repro_torch.params``): ``update`` builds new state trees, and
``apply_updates`` adds the updates to the parameters in place, so a
holder of the old parameters must keep a snapshot (``LagController``
does).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.params import tree_leaves, tree_map

Tree = Any


class Optimizer(NamedTuple):
    init: Callable[[Tree], Tree]
    # update(grads, state, params, lr) -> (updates, new_state)
    update: Callable[[Tree, Tree, Tree, float], Tuple[Tree, Tree]]


def _zeros(tree: Tree) -> Tree:
    return tree_map(lambda p: torch.zeros_like(p, requires_grad=False), tree)


def rmsprop(decay: float = 0.99, eps: float = 0.1,
            momentum: float = 0.0) -> Optimizer:
    """TF-style RMSProp as used by the paper (Appendix D/G)."""

    def init(params):
        if momentum:
            return {"ms": _zeros(params), "mom": _zeros(params)}
        return {"ms": _zeros(params)}

    def update(grads, state, params, lr):
        del params
        ms = tree_map(lambda m, g: decay * m + (1 - decay) * g * g,
                      state["ms"], grads)
        if momentum:
            scaled = tree_map(lambda g, m: g * torch.rsqrt(m + eps), grads,
                              ms)
            mom = tree_map(lambda mo, s: momentum * mo + lr * s,
                           state["mom"], scaled)
            return tree_map(lambda m: -m, mom), {"ms": ms, "mom": mom}
        # the same products, leaf by leaf: no whole tree of scaled
        # gradients is held (a full-width model's is gigabytes)
        return tree_map(lambda g, m: -lr * (g * torch.rsqrt(m + eps)),
                        grads, ms), {"ms": ms}

    return Optimizer(init, update)


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    def init(params):
        leaf = tree_leaves(params)[0]
        return {"m": _zeros(params), "v": _zeros(params),
                "t": torch.zeros((), dtype=torch.int32, device=leaf.device)}

    def update(grads, state, params, lr):
        del params
        t = state["t"] + 1
        m = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state["m"], grads)
        v = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g,
                     state["v"], grads)
        tf = t.to(torch.float32)
        c1 = 1 - b1 ** tf
        c2 = 1 - b2 ** tf
        upd = tree_map(
            lambda m_, v_: -lr * (m_ / c1) / (torch.sqrt(v_ / c2) + eps),
            m, v)
        return upd, {"m": m, "v": v, "t": t}

    return Optimizer(init, update)


def global_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The factor ``clip_by_global_norm`` multiplies every leaf by."""
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(grads: Tree, max_norm: float
                        ) -> Tuple[Tree, torch.Tensor]:
    norm = global_norm(grads)
    scale = clip_scale(norm, max_norm)
    return tree_map(lambda g: g * scale, grads), norm


@torch.no_grad()
def apply_updates(params: Tree, updates: Tree) -> Tree:
    """``params += updates``, in place; returns ``params``."""
    for p, u in zip(tree_leaves(params), tree_leaves(updates)):
        p.add_(u.to(p.dtype))
    return params


def linear_schedule(init_value: float, end_value: float,
                    steps: int) -> Callable[[int], float]:
    """The paper anneals the learning rate linearly to 0 over training.
    Computed in float32, as the JAX schedule is."""
    if steps <= 0:
        return lambda step: float(np.float32(init_value))

    def fn(step):
        frac = np.clip(np.float32(step) / np.float32(steps), 0.0, 1.0)
        return float(np.float32(init_value) +
                     np.float32(end_value - init_value) * np.float32(frac))

    return fn

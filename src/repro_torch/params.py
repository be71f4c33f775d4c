"""Parameter trees and the weights bridge to the JAX package's layout.

The port keeps parameters as the JAX package does: a nested dict whose
leaves are tensors, with the leaf names of ``backbone_specs``. Two
layouts differ:

* conv kernels are HWIO in JAX (``lax.conv_general_dilated`` with
  ``("NHWC", "HWIO", "NHWC")``) and OIHW here (``F.conv2d``);
* dense kernels are (in, out) in both, applied as ``x @ W + b``.

``from_jax`` turns a JAX tree (nested dicts of numpy arrays, e.g. from
``jax.device_get`` or an npz checkpoint) into the port's tensors and
``to_jax`` turns them back. ``flatten`` gives the ``"torso/conv1/kernel"``
keys of the npz+json checkpoint format.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np
import torch

Tree = Any


def _is_conv_kernel(name: str, leaf) -> bool:
    return name == "kernel" and len(leaf.shape) == 4


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Map ``fn`` over the leaves of nested dicts (sorted keys, as JAX)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> List:
    """Leaves in JAX's flattening order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten_like(tree: Tree, leaves: List) -> Tree:
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def flatten(tree: Tree, prefix: str = "") -> Dict[str, Any]:
    """``{"torso/conv1/kernel": leaf, ...}`` — the checkpoint's keys."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k in sorted(tree):
        out.update(flatten(tree[k], f"{prefix}/{k}" if prefix else k))
    return out


def snapshot(tree: Tree) -> Tree:
    """A detached copy: survives later in-place updates of ``tree``."""
    return tree_map(lambda x: x.detach().clone(), tree)


def from_jax(tree: Tree, device="cpu", requires_grad: bool = True) -> Tree:
    """JAX-layout tree (numpy arrays or tensors) -> the port's tensors.

    Conv kernels go HWIO -> OIHW; everything else keeps its shape."""
    def conv(name):
        def fn(leaf):
            t = torch.from_numpy(np.array(leaf, np.float32))
            if _is_conv_kernel(name, t):
                t = t.permute(3, 2, 0, 1)
            t = t.contiguous().to(device)
            return t.requires_grad_(requires_grad)
        return fn
    return _map_named(tree, conv)


def to_jax(tree: Tree) -> Tree:
    """The port's tensors -> JAX-layout numpy tree (conv OIHW -> HWIO)."""
    def conv(name):
        def fn(leaf):
            t = leaf.detach().to("cpu", torch.float32)
            if _is_conv_kernel(name, t):
                t = t.permute(2, 3, 1, 0)
            return np.ascontiguousarray(t.numpy())
        return fn
    return _map_named(tree, conv)


def _map_named(tree: Tree, make_fn, name: str = "") -> Tree:
    if isinstance(tree, dict):
        return {k: _map_named(tree[k], make_fn, k) for k in sorted(tree)}
    return make_fn(name)(tree)

"""Parameter trees and the weights bridge to the JAX package's layout.

The port keeps parameters as the JAX package does: a nested dict whose
leaves are tensors, with the leaf names of ``backbone_specs``. Two
layouts differ:

* conv kernels (the ``kernel`` leaves of the torso's conv layers, told
  apart by their full path) are HWIO in JAX
  (``lax.conv_general_dilated`` with ``("NHWC", "HWIO", "NHWC")``) and
  OIHW here (``F.conv2d``);
* every other leaf keeps its shape: dense kernels are (in..., out...) in
  both, applied as ``x @ W + b``, the token backbones' stacked layers
  (under ``scan``, with a leading layer axis) included.

``from_jax`` turns a JAX tree (nested dicts of numpy arrays, e.g. from
``jax.device_get`` or an npz checkpoint) into the port's tensors and
``to_jax`` turns them back. ``flatten`` gives the ``"torso/conv1/kernel"``
keys of the npz+json checkpoint format.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, List

import numpy as np
import torch

Tree = Any


# the kernel of a torso conv layer: conv1/conv2 (shallow), conv and
# res<b>a/res<b>b in each section (deep), in the whole agent's tree
# (under ``torso/``, itself under any prefix: ``ms/`` of an optimizer
# state, ``opt/ms/`` or ``params/`` of a combined checkpoint tree) or in
# a torso tree passed alone
_TORSO_CONV_KERNEL = re.compile(
    r"(?:(?:.+/)?torso/)?(section\d+/)?(conv\d*|res\d+[ab])/kernel")


def _is_conv_kernel(path: str) -> bool:
    """The path decides, not the rank or the layer's name alone: the
    kernel of a torso conv layer is HWIO, whether the tree is the whole
    agent (``torso/conv1/kernel``), a tree that holds it under a prefix
    (``opt/ms/torso/conv1/kernel``) or the torso itself (``conv1/kernel``).
    The token backbones' leaves keep their layout: the stacked dense
    kernels are 4-D too, e.g. ``stack/scan/l0/attn/q/kernel`` of shape
    (layers, d, H, Dh), and the SSM and RG-LRU blocks' depthwise
    ``stack/scan/l0/ssm/conv/kernel`` is (layers, W, C)."""
    return _TORSO_CONV_KERNEL.fullmatch(path) is not None


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


def copy(tree: Tree) -> Tree:
    """A detached copy that keeps each leaf's ``requires_grad``: trainable
    where the source is, and never an alias of it."""
    return tree_map(
        lambda x: x.detach().clone().requires_grad_(x.requires_grad), tree)


def from_jax(tree: Tree, device="cpu", requires_grad: bool = True) -> Tree:
    """JAX-layout tree (numpy arrays or tensors) -> the port's float32
    tensors on ``device``.

    Conv kernels go HWIO -> OIHW; everything else keeps its shape. A
    float32 tensor already on ``device`` that needs no permute is used as
    it is, not copied."""
    def conv(path):
        def fn(leaf):
            t = leaf if isinstance(leaf, torch.Tensor) else \
                torch.from_numpy(np.array(leaf, np.float32))
            if _is_conv_kernel(path):
                t = t.permute(3, 2, 0, 1)
            t = t.to(device, torch.float32).contiguous()
            return t.requires_grad_(requires_grad)
        return fn
    return _map_named(tree, conv)


def to_jax(tree: Tree) -> Tree:
    """The port's tensors -> JAX-layout numpy tree (conv OIHW -> HWIO)."""
    def conv(path):
        def fn(leaf):
            t = leaf.detach().to("cpu", torch.float32)
            if _is_conv_kernel(path):
                t = t.permute(2, 3, 1, 0)
            return np.ascontiguousarray(t.numpy())
        return fn
    return _map_named(tree, conv)


def _map_named(tree: Tree, make_fn, path: str = "") -> Tree:
    if isinstance(tree, dict):
        return {k: _map_named(tree[k], make_fn, f"{path}/{k}" if path else k)
                for k in sorted(tree)}
    return make_fn(path)(tree)

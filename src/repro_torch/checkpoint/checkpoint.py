"""Checkpointing (``repro.checkpoint.checkpoint``): parameter and
optimizer-state trees -> .npz + JSON manifest, in the JAX package's
format, so either package reads what the other wrote.

A directory holds ``ckpt_%08d.npz`` (one array per leaf, keyed by its
``/``-joined path, e.g. ``torso/conv1/kernel`` or, for the combined
fleet-v1 tree, ``opt/ms/torso/conv1/kernel``), ``ckpt_%08d.json`` (``step``,
the sorted ``keys`` and an ``extra`` dict) and a ``LATEST`` file with the
newest step. The archive is written to a temporary file and renamed into
place.

Leaves are stored in the JAX layout: trees of the port's tensors go
through ``params.to_jax`` on save (conv kernels OIHW -> HWIO) and
``restore`` maps them back through ``params.from_jax``. A tree of numpy
arrays is taken to be in the JAX layout already and is written as it is.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import params as params_lib

PyTree = Any


def _jax_layout(tree: PyTree) -> PyTree:
    """Host numpy leaves in the JAX layout."""
    if any(isinstance(x, torch.Tensor)
           for x in params_lib.tree_leaves(tree)):
        return params_lib.to_jax(tree)
    return tree


def save(directory: str, step: int, tree: PyTree,
         extra: Optional[Dict[str, Any]] = None) -> str:
    os.makedirs(directory, exist_ok=True)
    leaves = {k: np.asarray(v)
              for k, v in params_lib.flatten(_jax_layout(tree)).items()}
    manifest = {"step": step, "keys": sorted(leaves),
                "extra": extra or {}}
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    os.close(fd)
    np.savez(tmp, **leaves)
    # np.savez appends .npz to a name without the suffix and leaves the
    # mkstemp file behind: move the archive, drop the stub
    os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp, path)
    if os.path.exists(tmp):
        os.remove(tmp)
    with open(os.path.join(directory, f"ckpt_{step:08d}.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(directory, "LATEST"), "w") as f:
        f.write(str(step))
    return path


def latest_step(directory: str) -> Optional[int]:
    p = os.path.join(directory, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def _step_or_latest(directory: str, step: Optional[int]) -> int:
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    return step


def read_manifest(directory: str,
                  step: Optional[int] = None) -> Dict[str, Any]:
    """The JSON manifest of a checkpoint, with the ``extra`` dict ``save``
    wrote (a fleet-v1 checkpoint's version rides there)."""
    step = _step_or_latest(directory, step)
    with open(os.path.join(directory, f"ckpt_{step:08d}.json")) as f:
        return json.load(f)


def load_with_extra(directory: str, step: Optional[int] = None
                    ) -> Tuple[PyTree, int, Dict[str, Any]]:
    """Restore without a ``like`` structure: rebuilds the nested dict tree
    from the path keys, numpy leaves in the JAX layout (map them with
    ``params.from_jax``). Returns ``(tree, step, extra)``."""
    step = _step_or_latest(directory, step)
    manifest = read_manifest(directory, step)
    tree: Dict[str, Any] = {}
    with np.load(os.path.join(directory, f"ckpt_{step:08d}.npz")) as data:
        for key in manifest["keys"]:
            node = tree
            parts = key.split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = data[key]
    return tree, step, manifest.get("extra", {})


def restore(directory: str, like: PyTree,
            step: Optional[int] = None) -> Tuple[PyTree, int]:
    """Restore into the structure of ``like``, the port's tensors (values
    ignored): each stored leaf must have the JAX-layout shape of its
    counterpart. Returns the port's tensors on ``like``'s device, with
    its ``requires_grad``, and the step."""
    step = _step_or_latest(directory, step)
    leaf0 = params_lib.tree_leaves(like)[0]
    shapes = params_lib.flatten(params_lib.tree_map(
        lambda x: tuple(np.shape(x)), _jax_layout(like)))
    with np.load(os.path.join(directory, f"ckpt_{step:08d}.npz")) as data:
        flat = {}
        for key, shape in shapes.items():
            arr = data[key]
            if arr.shape != shape:
                raise ValueError(f"checkpoint leaf {key} has shape "
                                 f"{arr.shape}; expected {shape}")
            flat[key] = arr
    tree = params_lib.tree_map(lambda _: None, like)
    for key, arr in flat.items():
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node[part]
        node[parts[-1]] = arr
    return params_lib.from_jax(tree, leaf0.device,
                               requires_grad=leaf0.requires_grad), step

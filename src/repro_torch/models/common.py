"""Parameter-spec trees and the dense layer (``repro.models.common``).

A spec tree is a nested dict of ``Spec(shape, init, scale)`` leaves in
the JAX package's layout (conv kernels HWIO), so shapes, fan-ins and
``param_count`` are the reference's own. ``init_params`` draws that tree
from an explicit ``torch.Generator`` on the CPU, so a seed gives the same
weights on every device; ``repro_torch.params.from_jax`` then moves it
into the port's layout and onto the device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.params import tree_leaves, tree_map

Tree = Any


@dataclasses.dataclass(frozen=True)
class Spec:
    shape: Tuple[int, ...]
    init: str = "normal"          # normal | zeros
    scale: float = 1.0            # multiplier on the default init scale


def _fan_in(shape: Tuple[int, ...]) -> int:
    # contraction dims are all but the last by convention
    return int(np.prod(shape[:-1])) if len(shape) > 1 else shape[0]


def _init_leaf(spec: Spec, gen: torch.Generator) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape)
    if spec.init == "normal":
        # std = scale / sqrt(prod(shape[:-1])), as the JAX package draws
        std = spec.scale / math.sqrt(max(_fan_in(spec.shape), 1))
        return torch.randn(spec.shape, generator=gen) * std
    raise ValueError(f"unknown init {spec.init}")


def init_params(specs: Tree, seed: int) -> Tree:
    """JAX-layout float32 CPU tensors drawn from ``torch.Generator(seed)``.

    The draws are torch's (Philox/MT), not JAX's threefry: the same seed
    gives other numbers than the JAX package, from the same distributions.
    """
    gen = torch.Generator().manual_seed(seed)
    return tree_map(lambda s: _init_leaf(s, gen), specs)


def param_count(specs: Tree) -> int:
    return sum(int(np.prod(s.shape)) for s in tree_leaves(specs))


def dense_specs(in_shape: Sequence[int], out_shape: Sequence[int],
                bias: bool = False, scale: float = 1.0) -> Dict[str, Spec]:
    specs = {"kernel": Spec(tuple(in_shape) + tuple(out_shape),
                            scale=scale)}
    if bias:
        specs["bias"] = Spec(tuple(out_shape), init="zeros")
    return specs


def dense(params, x: torch.Tensor) -> torch.Tensor:
    """``x @ W + b`` with W stored (in, out), as ``repro`` contracts it."""
    y = torch.matmul(x, params["kernel"])
    if "bias" in params:
        y = y + params["bias"]
    return y

"""Parameter-spec trees and common layers (``repro.models.common``).

A spec tree is a nested dict of ``Spec(shape, logical, init, dtype,
scale)`` leaves in the JAX package's layout (conv kernels HWIO), so
shapes, fan-ins, logical axes and ``param_count`` are the reference's
own. ``init_params`` draws that tree from an explicit ``torch.Generator``
on one device (the CPU unless asked); ``repro_torch.params.from_jax``
then moves it into the port's layout and onto the device.
``abstract_params`` gives the tree as ``meta`` tensors (the dry run's
stand-ins, no storage) and ``param_shardings`` each leaf's DTensor
placements under a ``repro_torch.sharding.rules.Rules``. The layers
(norms, dense, embedding, RoPE, activations) compute what the JAX
functions compute, in the same dtypes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.params import tree_leaves, tree_map

Tree = Any


@dataclasses.dataclass(frozen=True)
class Spec:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones | embed
    dtype: str = "float32"
    scale: float = 1.0            # multiplier on the default init scale

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"Spec: shape {self.shape} and logical axes "
                             f"{self.logical} differ in rank")


def _fan_in(shape: Tuple[int, ...]) -> int:
    # contraction dims are all but the last by convention
    return int(np.prod(shape[:-1])) if len(shape) > 1 else shape[0]


def _init_leaf(spec: Spec, gen: torch.Generator) -> torch.Tensor:
    dev = gen.device
    if spec.init == "zeros":
        return torch.zeros(spec.shape, device=dev)
    if spec.init == "ones":
        return torch.ones(spec.shape, device=dev)
    if spec.init == "embed":
        return torch.randn(spec.shape, generator=gen, device=dev).mul_(
            spec.scale)
    if spec.init == "normal":
        # std = scale / sqrt(prod(shape[:-1])), as the JAX package draws
        std = spec.scale / math.sqrt(max(_fan_in(spec.shape), 1))
        return torch.randn(spec.shape, generator=gen, device=dev).mul_(std)
    raise ValueError(f"unknown init {spec.init}")


def init_params(specs: Tree, seed: int, device="cpu") -> Tree:
    """JAX-layout float32 tensors drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed``.

    The draws are torch's (Philox/MT), not JAX's threefry: the same seed
    gives other numbers than the JAX package, from the same distributions,
    and a CUDA generator gives other numbers than the CPU one. Drawing on
    the card keeps a 46 GB tree (mistral-nemo-12b in float32) off the
    host."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return tree_map(lambda s: _init_leaf(s, gen), specs)


def abstract_params(specs: Tree) -> Tree:
    """The tree as ``meta`` tensors of each leaf's shape and dtype: the
    stand-ins of JAX's ShapeDtypeStructs, which allocate nothing."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=torch_dtype(
        s.dtype), device="meta"), specs)


def param_shardings(specs: Tree, rules) -> Tree:
    """Each leaf's DTensor placements under ``rules``
    (``Rules.placements`` of its logical axes and shape)."""
    return tree_map(lambda s: rules.placements(s.logical, s.shape), specs)


def param_count(specs: Tree) -> int:
    return sum(int(np.prod(s.shape)) for s in tree_leaves(specs))


def dense_specs(in_shape: Sequence[int], out_shape: Sequence[int],
                in_logical: Sequence[Optional[str]],
                out_logical: Sequence[Optional[str]],
                bias: bool = False, scale: float = 1.0) -> Dict[str, Spec]:
    specs = {"kernel": Spec(tuple(in_shape) + tuple(out_shape),
                            tuple(in_logical) + tuple(out_logical),
                            scale=scale)}
    if bias:
        specs["bias"] = Spec(tuple(out_shape), tuple(out_logical),
                             init="zeros")
    return specs


def cast(tree: Tree, dtype: torch.dtype) -> Tree:
    """``tree`` with its floating leaves cast to ``dtype`` and the others
    as they are (``repro.models.common.cast``). A cast leaf is a new
    tensor, never an alias of its source (the port updates parameters in
    place), and keeps its ``requires_grad``."""
    def leaf(x):
        if not torch.is_floating_point(x):
            return x
        return x.detach().to(dtype, copy=True).requires_grad_(
            x.requires_grad)

    return tree_map(leaf, tree)


def torch_dtype(name: str) -> torch.dtype:
    """``ArchConfig.dtype`` / ``param_dtype`` names -> torch dtypes."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def dense(params, x: torch.Tensor, contract: int = 1,
          dtype=None) -> torch.Tensor:
    """Contract the trailing ``contract`` dims of x with the leading dims
    of the kernel (stored (in..., out...)), then add the bias.

    With ``dtype`` the kernel and bias are cast to it first. Without, the
    operands are promoted to a common dtype, as JAX promotes bf16 @ f32
    to f32 (``torch.matmul`` refuses mixed dtypes)."""
    k = params["kernel"]
    b = params.get("bias")
    if dtype is not None:
        k = k.to(dtype)
        b = None if b is None else b.to(dtype)
    elif x.dtype != k.dtype:
        common = torch.promote_types(x.dtype, k.dtype)
        x, k = x.to(common), k.to(common)
    in_shape, out_shape = k.shape[:contract], k.shape[contract:]
    k2 = k.reshape(math.prod(in_shape), math.prod(out_shape))
    x2 = x.reshape(*x.shape[:x.dim() - contract], math.prod(in_shape))
    y = torch.matmul(x2, k2).reshape(*x2.shape[:-1], *out_shape)
    if b is not None:
        y = y + b
    return y


# ---------------------------------------------------------------------------
# Normalization


def rmsnorm_specs(d: int, name_axis: str = "embed") -> Dict[str, Spec]:
    return {"scale": Spec((d,), (name_axis,), init="ones")}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """In float32, cast back to x's dtype."""
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)).to(x.dtype)


def layernorm_specs(d: int, name_axis: str = "embed") -> Dict[str, Spec]:
    return {"scale": Spec((d,), (name_axis,), init="ones"),
            "bias": Spec((d,), (name_axis,), init="zeros")}


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """In float32 with the population variance, cast back to x's dtype."""
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].to(torch.float32) + \
        params["bias"].to(torch.float32)
    return y.to(x.dtype)


def make_norm(kind: str, d: int):
    if kind == "rmsnorm":
        return rmsnorm_specs(d), rmsnorm
    if kind == "layernorm":
        return layernorm_specs(d), layernorm
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Embedding


def embedding_specs(vocab: int, d: int) -> Dict[str, Spec]:
    return {"table": Spec((vocab, d), ("vocab", "embed"), init="embed",
                          scale=0.02)}


def embed(params, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Rows of the table, cast to ``dtype``. JAX casts the whole table
    first; gathering first gives the same values without a cast copy of
    a (vocab, d) table."""
    return F.embedding(ids.long(), params["table"]).to(dtype)


# ---------------------------------------------------------------------------
# RoPE


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding over the two halves of the head dim.
    x: (..., seq, heads, head_dim); positions: (..., seq)."""
    head_dim = x.shape[-1]
    half = head_dim // 2
    freq = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half))
    angles = positions[..., None].to(torch.float32) * freq
    angles = angles[..., None, :]                 # broadcast over heads
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    return {
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "silu": F.silu,
        "relu": F.relu,
        "tanh": torch.tanh,
    }[name]

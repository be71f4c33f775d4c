"""Logical-axis sharding rules (``repro.sharding.rules``) with the
divisibility fallback.

Tensors in the spec trees are annotated with *logical* axis names
(``('batch', 'seq', 'embed')``). A ``Rules`` object maps logical names to
mesh axes and resolves them, for one tensor shape, into the entries of a
partition spec: ``None``, a mesh axis name or a tuple of names, one entry
a dimension, as the reference's ``PartitionSpec``. A dimension whose size
is not divisible by the product of its mesh axes is replicated (what lets
recurrentgemma's 10 heads sit on a 16-way model axis), and a mesh axis is
used at most once a spec. ``placements`` turns the same resolution into
DTensor placements, one ``Shard(dim)`` or ``Replicate()`` a mesh axis.

A mesh here is anything with ``axis_names`` and a ``shape`` mapping of
name to size (``repro_torch.launch.mesh.Mesh``, or a stand-in), so the
rules of a 256- or 512-device mesh resolve with no device and no process
group.

Not ported, by design: the reference's ``logical_constraint`` (``lc``)
and its calls in the model code. They constrain GSPMD's partitioner,
which eager PyTorch has no counterpart of; on one device they are the
identity in both packages, and no path of the port runs the backbone on
DTensors.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

MeshAxes = Union[None, str, Tuple[str, ...]]

# Baseline logical->mesh rules for a ('pod', 'data', 'model') mesh.
DEFAULT_RULES: Dict[str, MeshAxes] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ff": "model",
    "vocab": "model",
    "experts": "model",
    "expert_cap": None,
    "ssm_state": None,
    "ssm_heads": "model",
    "lru": "model",
    "actions": None,
    "layers": None,
    "conv": None,
    "kv_seq": None,
    "stack": None,
}


class Rules:
    """Resolver from logical axis tuples to partition-spec entries on a
    mesh."""

    def __init__(self, mesh, rules: Optional[Dict[str, MeshAxes]] = None):
        self.mesh = mesh
        table = dict(DEFAULT_RULES)
        if rules:
            table.update(rules)
        # drop mesh axes this mesh lacks (e.g. 'pod' on a 2-D mesh)
        clean: Dict[str, MeshAxes] = {}
        for k, v in table.items():
            if v is None:
                clean[k] = None
            else:
                axes = (v,) if isinstance(v, str) else tuple(v)
                axes = tuple(a for a in axes if a in mesh.axis_names)
                clean[k] = axes if axes else None
        self.table = clean

    def _axis_size(self, mesh_axes: MeshAxes) -> int:
        if mesh_axes is None:
            return 1
        axes = (mesh_axes,) if isinstance(mesh_axes, str) else mesh_axes
        return math.prod(self.mesh.shape[a] for a in axes)

    def spec(self, logical: Sequence[Optional[str]],
             shape: Optional[Sequence[int]] = None) -> Tuple[MeshAxes, ...]:
        """Resolve logical axes (and, with ``shape``, the divisibility of
        each dimension) to one partition-spec entry a dimension."""
        parts = []
        used: set = set()
        for i, name in enumerate(logical):
            if name is None:
                parts.append(None)
                continue
            mesh_axes = self.table.get(name)
            if mesh_axes is None:
                parts.append(None)
                continue
            axes = (mesh_axes,) if isinstance(mesh_axes, str) \
                else tuple(mesh_axes)
            # an axis may appear only once in a spec
            axes = tuple(a for a in axes if a not in used)
            if not axes:
                parts.append(None)
                continue
            if shape is not None and shape[i] % self._axis_size(axes):
                parts.append(None)
                continue
            used.update(axes)
            parts.append(axes if len(axes) > 1 else axes[0])
        return tuple(parts)

    def shards(self, logical: Sequence[Optional[str]],
               shape: Sequence[int]) -> int:
        """The devices a tensor of ``shape`` is split over: the product of
        the mesh axes its ``spec`` shards it on."""
        n = 1
        for part in self.spec(logical, shape):
            for a in (() if part is None else
                      (part,) if isinstance(part, str) else part):
                n *= self.mesh.shape[a]
        return n

    def placements(self, logical: Sequence[Optional[str]],
                   shape: Optional[Sequence[int]] = None) -> tuple:
        """The DTensor placements of ``spec(logical, shape)``: for each
        mesh axis, in mesh order, ``Shard(dim)`` of the dimension it
        shards, else ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard

        dim_of = {}
        for dim, part in enumerate(self.spec(logical, shape)):
            for a in (() if part is None else
                      (part,) if isinstance(part, str) else part):
                dim_of[a] = dim
        return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                     for a in self.mesh.axis_names)


# ---------------------------------------------------------------------------
# Thread-local active rules, so that callers can set them without plumbing.

_state = threading.local()


def get_rules() -> Optional[Rules]:
    return getattr(_state, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Optional[Rules]):
    prev = getattr(_state, "rules", None)
    _state.rules = rules
    try:
        yield rules
    finally:
        _state.rules = prev

"""Production mesh construction (``repro.launch.mesh``), and the H100's
peak rates for the roofline.

Single pod: (data=16, model=16) = 256 devices. Multi-pod: (pod=2,
data=16, model=16) = 512. A ``Mesh`` here is the axis names and sizes
only: it holds no device and no process group, so ``Rules`` resolve the
specs of a 512-device mesh on any machine, and building one touches no
device state. ``Mesh.device_mesh`` gives the
``torch.distributed.device_mesh.DeviceMesh`` of the same shape where a
process group of that size is up.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import MeshConfig
from repro_torch.sharding.rules import Rules


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes) or min(self.sizes) < 1:
            raise ValueError(f"mesh axes {self.axis_names} and sizes "
                             f"{self.sizes} do not match")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def device_mesh(self, device_type: str = "cuda"):
        """The DeviceMesh of this shape over the ranks of the default
        process group, which must be up with exactly ``size`` ranks."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        if not dist.is_initialized() or dist.get_world_size() != self.size:
            have = dist.get_world_size() if dist.is_initialized() else 0
            raise RuntimeError(f"a {self.sizes} mesh needs a process group "
                               f"of {self.size} ranks; {have} are up")
        return init_device_mesh(device_type, self.sizes,
                                mesh_dim_names=self.axis_names)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape)


def make_mesh_2d_tp(*, multi_pod: bool = False) -> Mesh:
    """§Perf variant: split the 16-way model axis into 4x4 so head counts
    divisible by 4 (qwen 20H, recurrentgemma/whisper) shard on model_a
    while ffn/vocab use the full 16 = model_a x model_b."""
    shape = (2, 16, 4, 4) if multi_pod else (16, 4, 4)
    axes = (("pod", "data", "model_a", "model_b") if multi_pod
            else ("data", "model_a", "model_b"))
    return Mesh(axes, shape)


def make_mesh(cfg: MeshConfig) -> Mesh:
    return Mesh(tuple(cfg.axis_names), tuple(cfg.shape))


def make_data_mesh(num_devices: int, device="cuda") -> Mesh:
    """1-D ``('data',)`` mesh over ``num_devices`` devices of ``device``'s
    type: the SPMD data-parallel learner's topology (batch sharded on the
    trajectory axis, params and optimizer state replicated)."""
    kind = torch.device(device).type
    avail = torch.get_device_module(kind).device_count()
    if num_devices < 1 or num_devices > avail:
        raise ValueError(f"spmd mesh needs 1..{avail} devices, got "
                         f"{num_devices} ({avail} {kind} device(s) here)")
    return Mesh(("data",), (num_devices,))


def make_rules(mesh: Mesh, overrides=None) -> Rules:
    return Rules(mesh, overrides)


# One NVIDIA H100 SXM5 80 GB, as its data sheet gives it (dense rates,
# no sparsity, at the full 700 W power limit). These are not measured:
# the roofline's bounds are against them.
HW = {
    "peak_flops_bf16": 989e12,   # bf16 tensor-core FLOP/s (data sheet)
    "hbm_bw": 3.35e12,           # HBM3 bytes/s (data sheet)
    "hbm_bytes": 80e9,           # HBM3 capacity in bytes (data sheet)
    # NVLink 4 bytes/s in one direction, half of 900 GB/s (data sheet)
    "nvlink_bw_one_way": 450e9,
}

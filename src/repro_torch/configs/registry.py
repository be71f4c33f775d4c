"""Architecture config registry: ``get_config(name)``, ``list_configs()``,
``all_configs()``.

Every architecture of the JAX registry is ported: the paper's two
conv-LSTM agents, the dense decoders (mistral-nemo-12b, gemma-7b,
qwen1.5-4b, stablelm-1.6b), the MoE decoders (granite-moe-1b-a400m,
olmoe-1b-7b), the SSM stack mamba2-1.3b, the RG-LRU hybrid
recurrentgemma-2b, the VLM llama-3.2-vision-11b and the enc-dec
whisper-small. Each module defines ``CONFIG`` (the published widths) and
``smoke_config()`` (the reduced variant of the CPU tests). The names are
in the reference's order; ``ASSIGNED`` is its first ten, the token
configs (the dry run's ``--list``).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ArchConfig

_ARCH_MODULES = ["recurrentgemma_2b", "granite_moe_1b_a400m", "whisper_small",
                 "mamba2_1_3b", "stablelm_1_6b", "gemma_7b", "qwen1_5_4b",
                 "llama_3_2_vision_11b", "mistral_nemo_12b", "olmoe_1b_7b",
                 "impala_shallow", "impala_deep"]

_ALIASES = {
    "impala-shallow": "impala_shallow",
    "impala-deep": "impala_deep",
    "gemma-7b": "gemma_7b",
    "qwen1.5-4b": "qwen1_5_4b",
    "stablelm-1.6b": "stablelm_1_6b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "whisper-small": "whisper_small",
}


ASSIGNED = _ARCH_MODULES[:10]


def _module(name: str):
    mod = _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if mod not in _ARCH_MODULES:
        raise KeyError(f"unknown architecture {name!r}; "
                       f"known: {list_configs()}")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ArchConfig:
    return _module(name).smoke_config()


def list_configs() -> List[str]:
    return list(_ARCH_MODULES)


def all_configs() -> Dict[str, ArchConfig]:
    return {n: get_config(n) for n in _ARCH_MODULES}

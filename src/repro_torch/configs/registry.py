"""Architecture config registry: ``get_config(name)`` / ``list_configs()``.

The paper's two conv-LSTM agents, the dense decoders (mistral-nemo-12b,
gemma-7b, qwen1.5-4b, stablelm-1.6b), the SSM stack mamba2-1.3b and the
RG-LRU hybrid recurrentgemma-2b are ported. The other token backbones of
the JAX registry are known by name, so asking for one ends the run with
a pointer to the roadmap item that ports them instead of a bare
``KeyError``.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ArchConfig

_ARCH_MODULES = ["impala_shallow", "impala_deep", "mistral_nemo_12b",
                 "mamba2_1_3b", "gemma_7b", "qwen1_5_4b", "stablelm_1_6b",
                 "recurrentgemma_2b"]

_ALIASES = {
    "impala-shallow": "impala_shallow",
    "impala-deep": "impala_deep",
    "gemma-7b": "gemma_7b",
    "qwen1.5-4b": "qwen1_5_4b",
    "stablelm-1.6b": "stablelm_1_6b",
    "recurrentgemma-2b": "recurrentgemma_2b",
}

# the JAX registry's token backbones (names and module names)
_TOKEN_ARCHS = {
    "granite-moe-1b-a400m", "whisper-small", "llama-3.2-vision-11b",
    "olmoe-1b-7b",
}
_TOKEN_ARCHS |= {n.replace("-", "_").replace(".", "_") for n in _TOKEN_ARCHS}

NOT_PORTED_TOKEN = ("this token backbone is not ported yet (ROADMAP.md, "
                    "Queue 1 item 14: the MoE, cross-attention and enc-dec "
                    "backbones)")


def _module(name: str):
    if name in _TOKEN_ARCHS:
        raise SystemExit(f"--arch {name}: {NOT_PORTED_TOKEN}")
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

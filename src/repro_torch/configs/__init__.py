"""Architecture config registry: ``--arch <id>`` resolution, the JAX
package's ten assigned architectures."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig  # noqa: F401

_ARCH_MODULES: Dict[str, str] = {
    "olmo-1b": "olmo_1b",
    "rwkv6-3b": "rwkv6_3b",
    "nemotron-4-15b": "nemotron_4_15b",
    "stablelm-12b": "stablelm_12b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "paligemma-3b": "paligemma_3b",
    "hubert-xlarge": "hubert_xlarge",
    "mixtral-8x22b": "mixtral_8x22b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "nemotron-4-340b": "nemotron_4_340b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {list(ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced_config(arch: str) -> ModelConfig:
    return _module(arch).reduced()

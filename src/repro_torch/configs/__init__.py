"""Architecture registry (counterpart of ``repro/configs``): ``get(name)`` /
``get_smoke(name)`` / ``ARCHS``: the ten LM families as data."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ArchConfig

_MODULES = {
    "mixtral-8x22b": "mixtral_8x22b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "stablelm-3b": "stablelm_3b",
    "granite-8b": "granite_8b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "starcoder2-3b": "starcoder2_3b",
    "hubert-xlarge": "hubert_xlarge",
    "mamba2-780m": "mamba2_780m",
    "paligemma-3b": "paligemma_3b",
    "recurrentgemma-9b": "recurrentgemma_9b",
}

ARCHS = tuple(_MODULES)


def _mod(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get(name: str) -> ArchConfig:
    return _mod(name).CONFIG


def get_smoke(name: str) -> ArchConfig:
    return _mod(name).smoke()

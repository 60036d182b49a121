"""Architecture registry of the PyTorch port.

A copy of ``repro.configs`` holding the architectures the port serves so
far.  Select with ``get_config("<arch-id>")``.
"""
from __future__ import annotations

import importlib

from repro_torch.config import ModelConfig

# arch-id -> module name
_REGISTRY = {
    "qwen3-8b": "qwen3_8b",
}

ALL_ARCHS = tuple(_REGISTRY)


def get_config(arch: str) -> ModelConfig:
    if arch not in _REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_REGISTRY)}")
    mod = importlib.import_module(f"repro_torch.configs.{_REGISTRY[arch]}")
    return mod.CONFIG


def list_archs() -> list[str]:
    return list(_REGISTRY)

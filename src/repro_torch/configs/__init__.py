"""Architecture registry of the PyTorch port.

A copy of ``repro.configs``: every assigned architecture plus the paper's
own evaluation models is a module exporting ``CONFIG``.  Select with
``get_config("<arch-id>")``.  Simulation prices any of them and ``Model``
builds every one.  ``ASSIGNED_ARCHS`` (the first ten) are the ones the
dry run sweeps (``repro_torch.launch.dryrun``).
"""
from __future__ import annotations

import importlib

from repro_torch.config import ModelConfig

# arch-id -> module name
_REGISTRY = {
    # ---- assigned pool ----
    "phi4-mini-3.8b": "phi4_mini_3p8b",
    "mistral-large-123b": "mistral_large_123b",
    "qwen1.5-0.5b": "qwen15_0p5b",
    "qwen1.5-110b": "qwen15_110b",
    "pixtral-12b": "pixtral_12b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "rwkv6-7b": "rwkv6_7b",
    "musicgen-large": "musicgen_large",
    # ---- paper's own evaluation models ----
    "qwen3-8b": "qwen3_8b",
    "llama3.1-8b": "llama31_8b",
    "qwen3-30b-a3b": "qwen3_30b_a3b",
}

ASSIGNED_ARCHS = tuple(list(_REGISTRY)[:10])
PAPER_ARCHS = tuple(list(_REGISTRY)[10:])
ALL_ARCHS = tuple(_REGISTRY)


def get_config(arch: str) -> ModelConfig:
    if arch not in _REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_REGISTRY)}")
    mod = importlib.import_module(f"repro_torch.configs.{_REGISTRY[arch]}")
    return mod.CONFIG


def list_archs() -> list[str]:
    return list(_REGISTRY)

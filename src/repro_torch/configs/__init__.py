"""Configurations of the port: the paper's MemEC testbed and the model
architectures (``--arch <id>`` -> ``ModelConfig``, plus reduced
variants).

The ten arch modules are the JAX package's with one line changed (the
``ModelConfig`` import), so ``--arch`` names and every field stay
identical; ``tests/test_torch_models.py`` holds them equal.
"""
from __future__ import annotations

import importlib

_ARCH_MODULES = {
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "mamba2-370m": "mamba2_370m",
    "minicpm3-4b": "minicpm3_4b",
    "starcoder2-3b": "starcoder2_3b",
    "mistral-large-123b": "mistral_large_123b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "musicgen-medium": "musicgen_medium",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
}

ARCH_NAMES = list(_ARCH_MODULES)


def _module(name: str):
    key = name.replace("_", "-")
    if key not in _ARCH_MODULES:
        key = name  # maybe already dashed
    if key not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[key]}")


def get_config(name: str):
    return _module(name).CONFIG


def get_reduced(name: str):
    return _module(name).REDUCED


def memec_config():
    from . import memec
    return memec.CONFIG

"""Architecture registry of the port: every arch of ``repro.configs``."""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "gemma3-1b": "repro_torch.configs.gemma3_1b",
    "falcon-mamba-7b": "repro_torch.configs.falcon_mamba_7b",
    "granite-3-2b": "repro_torch.configs.granite_3_2b",
    "chatglm3-6b": "repro_torch.configs.chatglm3_6b",
    "granite-20b": "repro_torch.configs.granite_20b",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b_a400m",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "llama-3.2-vision-11b": "repro_torch.configs.llama_3_2_vision_11b",
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large_398b",
}

ARCH_IDS = tuple(_MODULES)


def _module(name: str):
    if name not in _MODULES:
        raise ValueError(f"unknown arch {name!r}; available: {ARCH_IDS}")
    return importlib.import_module(_MODULES[name])


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    return _module(name).reduced()

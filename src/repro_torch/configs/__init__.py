"""Architecture registry of the port: the ported configs, and for every
other arch of ``repro.configs`` the ROADMAP item that will port it."""

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
}

_NOT_PORTED = {
    "jamba-1.5-large-398b": "Queue 1 item 11 (its Mamba and MoE layers are "
                            "ported; its (mamba, mlp) and (mamba, moe) "
                            "layers and 797 GB need a sharded model)",
}

ARCH_IDS = tuple(_MODULES)


def _module(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported to PyTorch yet: ROADMAP.md "
            f"{_NOT_PORTED[name]}")
    if name not in _MODULES:
        raise ValueError(f"unknown arch {name!r}; available: {ARCH_IDS}")
    return importlib.import_module(_MODULES[name])


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_reduced(name: str) -> ModelConfig:
    return _module(name).reduced()

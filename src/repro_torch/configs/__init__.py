"""Architecture registry of the port: the ported configs, and for every
other arch of ``repro.configs`` the ROADMAP item that will port it."""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "gemma3-1b": "repro_torch.configs.gemma3_1b",
    "falcon-mamba-7b": "repro_torch.configs.falcon_mamba_7b",
}

_NOT_PORTED = {
    "granite-3-2b": "Queue 1 item 12 (the other dense decoders)",
    "chatglm3-6b": "Queue 1 item 12 (the other dense decoders)",
    "granite-20b": "Queue 1 item 12 (the other dense decoders)",
    "mixtral-8x7b": "Queue 1 item 6 (MoE)",
    "granite-moe-1b-a400m": "Queue 1 item 6 (MoE)",
    "jamba-1.5-large-398b": "Queue 1 item 6 (MoE; its Mamba layers are "
                            "ported, and it needs more than one card)",
    "llama-3.2-vision-11b": "Queue 1 item 8 (VLM and encoder-decoder)",
    "seamless-m4t-medium": "Queue 1 item 8 (VLM and encoder-decoder)",
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

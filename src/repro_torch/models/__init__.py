"""Composable model definitions of the port: the unified config and the
functional layer library, exporting what ``repro.models`` exports.

Only the config is imported with the package: the config modules
(``repro_torch.configs``, and through it ``configs.paper_workloads``)
import ``models.config`` and must load without torch. The functions are
bound on first use (PEP 562) from ``models.transformer``, and
``init_params`` from ``repro_torch.bridge``, which imports this package's
modules, so importing either first makes no cycle."""

import importlib

from repro_torch.models.config import (
    ATTN,
    ATTN_LOCAL,
    CROSS,
    MAMBA,
    MLP,
    MOE,
    NONE,
    ModelConfig,
)

__all__ = [
    "ModelConfig", "ATTN", "ATTN_LOCAL", "CROSS", "MAMBA", "MLP", "MOE",
    "NONE", "init_params", "forward", "prefill", "decode_step", "init_cache",
    "encode",
]

_LAZY = {"init_params": "repro_torch.bridge",
         **dict.fromkeys(("forward", "prefill", "decode_step", "init_cache",
                          "encode"), "repro_torch.models.transformer")}


def __getattr__(name: str):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

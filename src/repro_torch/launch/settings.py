"""Per-(arch x shape) launch settings: the input-shape table assigned to this
paper, per-arch memory strategy (microbatching, FSDP, optimizer flavour),
and the long_500k applicability list (see DESIGN.md §Arch-applicability).

The port's copy of ``repro.launch.settings``, value for value."""

from __future__ import annotations

import dataclasses

# ---------------------------------------------------------------- shapes

SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}

# long_500k runs only for sub-quadratic archs (SSM / hybrid / SWA-bounded);
# pure full-attention archs skip it (documented in DESIGN.md).
LONG_CONTEXT_ARCHS = {
    "gemma3-1b",        # 5:1 local(sw=512):global
    "mixtral-8x7b",     # SWA-4096 everywhere
    "jamba-1.5-large-398b",  # 63/72 layers O(1)-state mamba (+ MLP/MoE FFN)
    "falcon-mamba-7b",  # attention-free
}


def cells(arch_ids) -> list[tuple[str, str]]:
    """All (arch, shape) dry-run cells, with documented skips."""
    out = []
    for a in arch_ids:
        for s in SHAPES:
            out.append((a, s))
    return out


def cell_skipped(arch: str, shape: str) -> str | None:
    if shape == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
        return "pure full-attention arch: 500k decode skipped per DESIGN.md"
    return None


# ------------------------------------------------------- per-arch strategy

@dataclasses.dataclass(frozen=True)
class TrainSettings:
    microbatches: int = 1        # grad-accumulation microbatches (train_4k)
    fsdp_train: bool = False     # shard params over data axes for train
    fsdp_serve: bool = False     # ... and for serve (398B-class only)
    optimizer: str = "adamw"     # "adamw" | "adafactor"


TRAIN_SETTINGS: dict[str, TrainSettings] = {
    "gemma3-1b": TrainSettings(),
    "granite-3-2b": TrainSettings(microbatches=4),
    "chatglm3-6b": TrainSettings(microbatches=4, fsdp_train=True),
    "granite-20b": TrainSettings(microbatches=4, fsdp_train=True),
    "mixtral-8x7b": TrainSettings(microbatches=8, fsdp_train=True),
    "granite-moe-1b-a400m": TrainSettings(microbatches=2),
    "jamba-1.5-large-398b": TrainSettings(
        microbatches=4, fsdp_train=True, fsdp_serve=True,
        optimizer="adafactor"),
    "falcon-mamba-7b": TrainSettings(microbatches=16, fsdp_train=True),
    "llama-3.2-vision-11b": TrainSettings(microbatches=4, fsdp_train=True),
    "seamless-m4t-medium": TrainSettings(microbatches=2),
}


def settings_for(arch: str) -> TrainSettings:
    return TRAIN_SETTINGS.get(arch, TrainSettings())

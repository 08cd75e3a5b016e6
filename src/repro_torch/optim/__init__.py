"""The port's optimizers (``repro.optim`` without ``compression``, which
comes with ROADMAP.md Queue 1 item 11)."""

from repro_torch.optim.adamw import (
    OptConfig,
    adafactor_init,
    adafactor_update,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    cosine_schedule,
    make_optimizer,
)

__all__ = [
    "OptConfig", "make_optimizer", "adamw_init", "adamw_update",
    "adafactor_init", "adafactor_update", "clip_by_global_norm",
    "cosine_schedule",
]

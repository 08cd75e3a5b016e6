"""The port's optimizers, with the names ``repro.optim`` exports. The
int8 gradient compression is ``repro_torch.optim.compression``, which,
as in the reference, the package does not export."""

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

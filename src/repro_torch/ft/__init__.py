"""Fault tolerance of the port: the bounded-retry primitive that the
multi-tenant scheduler's chaos recovery runs on (the port's copy of
``repro.ft.retry``). The reference's training supervisor
(``repro.ft.supervisor``: checkpoint/restart, straggler monitor, elastic
remesh) needs the checkpoint and comes with the port's training path."""

from repro_torch.ft.retry import (
    DEFAULT_RETRY,
    RetryBudget,
    RetryError,
    RetryPolicy,
    retry_call,
)

__all__ = ["RetryPolicy", "RetryBudget", "RetryError", "retry_call",
           "DEFAULT_RETRY"]

"""Fault tolerance of the port: the bounded-retry primitive (the port's
copy of ``repro.ft.retry``), which the multi-tenant scheduler's chaos
recovery and the training supervisor run on, and the training supervisor
(``repro.ft.supervisor``: checkpoint/restart, straggler monitor, elastic
remesh plan) on the port's checkpoint."""

from repro_torch.ft.retry import (
    DEFAULT_RETRY,
    RetryBudget,
    RetryError,
    RetryPolicy,
    retry_call,
)
from repro_torch.ft.supervisor import (
    ElasticPlan,
    StragglerMonitor,
    TrainSupervisor,
    plan_elastic_remesh,
)

__all__ = ["TrainSupervisor", "StragglerMonitor", "plan_elastic_remesh",
           "ElasticPlan", "RetryPolicy", "RetryBudget", "RetryError",
           "retry_call", "DEFAULT_RETRY"]

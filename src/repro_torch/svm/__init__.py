"""Executable SVM runtime of the port: range-granular host<->device
streaming for oversubscribed serving (weight streaming), training
(activation offload), and multi-tenant serving over one shared device
pool with seeded fault injection and bounded retry, driven by the paper's
range/fault/eviction model. It exports what ``repro.svm`` exports."""

from repro_torch.svm.planner import (
    ParamRanges,
    plan_leaf_ranges,
    plan_param_ranges,
    tree_leaf_sizes,
)
from repro_torch.svm.executor import StreamingExecutor, run_layer_stream
from repro_torch.svm.offload import (
    OffloadPlan,
    plan_offload,
    record_offload,
    simulate_offload,
)
from repro_torch.svm.faults import FaultEvent, FaultInjector, FaultPlan
from repro_torch.svm.hotset import (
    HotSetProfile,
    ProfileCache,
    spec_profile,
    token_trace,
)
from repro_torch.svm.scheduler import (
    ModelSpec,
    PoolScheduler,
    Request,
    make_requests,
    run_schedule,
)

__all__ = ["plan_param_ranges", "plan_leaf_ranges", "tree_leaf_sizes",
           "ParamRanges", "StreamingExecutor", "run_layer_stream",
           "OffloadPlan", "plan_offload", "record_offload",
           "simulate_offload", "ModelSpec", "PoolScheduler", "Request",
           "make_requests", "run_schedule",
           "FaultPlan", "FaultEvent", "FaultInjector",
           "HotSetProfile", "ProfileCache", "spec_profile",
           "token_trace"]

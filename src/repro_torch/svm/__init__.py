"""Executable SVM runtime of the port: range-granular host<->device weight
streaming for oversubscribed serving, driven by the paper's
range/fault/eviction model. The multi-tenant scheduler, fault injection
and activation offload of ``repro.svm`` are not ported yet (ROADMAP.md
Queue 1 items 5c and 10)."""

from repro_torch.svm.planner import (
    ParamRanges,
    plan_leaf_ranges,
    plan_param_ranges,
    tree_leaf_sizes,
)
from repro_torch.svm.executor import StreamingExecutor, run_layer_stream
from repro_torch.svm.hotset import (
    HotSetProfile,
    ProfileCache,
    spec_profile,
    token_trace,
)

__all__ = ["plan_param_ranges", "plan_leaf_ranges", "tree_leaf_sizes",
           "ParamRanges", "StreamingExecutor", "run_layer_stream",
           "HotSetProfile", "ProfileCache", "spec_profile", "token_trace"]

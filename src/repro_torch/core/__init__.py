"""Core SVM model: ranges, policies, cost model, driver state machine,
discrete-event simulator, and the paper's workload traces."""

from repro_torch.core.costmodel import (
    CostParams,
    CostVector,
    H100_HOST,
    H100_SERVE_FLOPS,
    MI250X,
    eviction_cost,
    migration_cost,
    zerocopy_cost,
)
from repro_torch.core.policies import LRF, LRU, Clock, RandomPolicy, make_policy
from repro_torch.core.ranges import (
    GB,
    KB,
    MB,
    PAGE,
    AddressSpace,
    Allocation,
    Range,
    pow2_floor,
    split_allocation,
    svm_alignment,
)
from repro_torch.core.engine import (
    TRACE_CACHE,
    ColumnEmitter,
    CompiledTrace,
    SegmentCache,
    TraceCache,
    TraceSession,
    compile_trace,
    compile_workload,
    compiled_from_columns,
    execute_compiled,
    execute_fused,
)
from repro_torch.core.simulator import RunResult, Workload, apply_trace, dos_sweep, simulate
from repro_torch.core.svm import DensitySample, Event, MigrationError, SVMManager
from repro_torch.core.sweep import SweepPoint, run_point, run_sweep, trace_key
from repro_torch.core.traces import WORKLOADS, make_workload
from repro_torch.core.uvm import UVMManager, VABLOCK

__all__ = [
    "AddressSpace", "Allocation", "Range", "pow2_floor", "split_allocation",
    "svm_alignment", "GB", "MB", "KB", "PAGE",
    "CostParams", "CostVector", "MI250X", "H100_HOST", "H100_SERVE_FLOPS",
    "migration_cost", "eviction_cost", "zerocopy_cost",
    "LRF", "LRU", "Clock", "RandomPolicy", "make_policy",
    "SVMManager", "Event", "DensitySample", "MigrationError",
    "UVMManager", "VABLOCK",
    "RunResult", "Workload", "simulate", "apply_trace", "dos_sweep",
    "WORKLOADS", "make_workload",
    "CompiledTrace", "compile_trace", "compile_workload", "execute_compiled",
    "execute_fused",
    "ColumnEmitter", "SegmentCache", "TraceCache", "TraceSession",
    "TRACE_CACHE",
    "compiled_from_columns",
    "SweepPoint", "run_point", "run_sweep", "trace_key",
]

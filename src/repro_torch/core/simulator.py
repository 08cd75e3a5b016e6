"""Discrete-event simulation of workloads against the SVM driver model.

A *workload* builds its managed allocations in an AddressSpace and yields a
lazy trace of ops; the simulator applies them to an SVMManager and collects
the paper's metrics (wall time, throughput, migration/eviction profiles,
fault densities, cost breakdown).

Op vocabulary (tuples, for speed):
  ("touch", rid, concurrency, page_hint)  — kernel accesses range rid
  ("compute", seconds)                    — pure device compute
  ("writeback", rid)                      — algorithmic device→host copy
  ("pin", rid) / ("unpin", rid)           — app-directed placement (§4.1)
  ("spill", need_bytes, overlap)          — eager-spill until free >= need
  ("kernel", name)                        — kernel-boundary marker
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator

from repro_torch.core.costmodel import CostParams, MI250X
from repro_torch.core.ranges import DEFAULT_BASE, GB, AddressSpace
from repro_torch.core.svm import SVMManager

Op = tuple


@dataclasses.dataclass
class RunResult:
    workload: str
    dos: float
    wall_s: float
    work_units: float
    throughput: float          # work_units / wall_s
    summary: dict
    manager: SVMManager

    def row(self) -> dict:
        r = {"workload": self.workload, "dos": round(self.dos, 1),
             "throughput": self.throughput}
        r.update({k: v for k, v in self.summary.items()
                  if k != "cost_breakdown"})
        return r


class Workload:
    """Base class: subclasses define allocations + access trace + work."""

    name = "workload"
    concurrency = 32          # in-flight page requests => fault density
    kernel_markers = True

    def __init__(self, total_bytes: int):
        self.total_bytes = int(total_bytes)

    def build(self, space: AddressSpace) -> None:
        raise NotImplementedError

    def trace(self, space: AddressSpace) -> Iterator[Op]:
        raise NotImplementedError

    def work_units(self) -> float:
        """Useful work (bytes or flops) for throughput normalisation."""
        return float(self.total_bytes)


def simulate(
    workload: Workload,
    capacity_bytes: int = 64 * GB,
    *,
    base: int = DEFAULT_BASE,
    params: CostParams = MI250X,
    policy: str = "lrf",
    profile: bool = True,
    max_ops: int | None = None,
    manager_cls=SVMManager,
    zero_copy_alloc_names: tuple | str = (),
    engine: str = "batched",
    trace_cache=None,
    trace_key=None,
    measured_pin: float = 0.0,
    **mgr_kwargs,
) -> RunResult:
    """Simulate one workload run.

    ``engine="batched"`` lowers the trace through the compiled-trace engine
    (`repro_torch.core.engine`) — bit-identical to the scalar path, typically an
    order of magnitude faster.  Table-2 workloads lower through the
    columnar tier (`Workload.emit_columns`); with ``trace_cache`` (a
    `repro_torch.core.engine.TraceCache`) and ``trace_key`` set, the compiled
    trace is shared across runs with the same workload spec + space
    geometry (see `repro_torch.core.sweep.trace_key`).  The engine dispatches on
    the manager type (`SVMManager` and `UVMManager` each have a batched
    interpreter; any other manager replays op-for-op); every §4.2 driver
    variant runs on the fast tier.  ``engine="scalar"`` forces the per-op
    `apply_trace` loop.

    ``zero_copy_alloc_names`` may be the sentinel ``"biggest"``: it
    resolves to the workload's largest allocation of the *same build* used
    for simulation.

    ``measured_pin`` enables measured prefetching (docs/prefetching.md):
    the workload's own compiled touch columns are profiled
    (`repro_torch.svm.hotset.HotSetProfile`) and the measured hot set — ranges
    whose mean reuse interval fits the pool, highest touch frequency
    first, byte-bounded to ``measured_pin`` of capacity — is pinned
    up-front before the trace runs.  The profile is a pure function of
    the trace, so batched and scalar engines pin the identical set."""
    if engine not in ("batched", "scalar"):
        raise ValueError(f"unknown engine {engine!r}; "
                         "available: 'batched', 'scalar'")
    space = AddressSpace(capacity_bytes, base=base)
    workload.build(space)
    if zero_copy_alloc_names == "biggest":
        zero_copy_alloc_names = (
            max(space.allocations, key=lambda a: a.size).name,)
    elif isinstance(zero_copy_alloc_names, str):
        # a bare name would silently substring-match via `in` below
        raise ValueError("zero_copy_alloc_names must be a tuple of "
                         "allocation names or the sentinel 'biggest'; got "
                         f"{zero_copy_alloc_names!r}")
    mgr = manager_cls(space, policy=policy, params=params, profile=profile,
                      **mgr_kwargs)
    for a in space.allocations:
        if a.name in zero_copy_alloc_names:
            mgr.set_zero_copy(a.alloc_id)
    ct = None
    if engine == "batched" or measured_pin > 0.0:
        from repro_torch.core.engine import compile_workload
        ct = compile_workload(workload, space, max_ops=max_ops,
                              cache=trace_cache, key=trace_key)
    if measured_pin > 0.0:
        # measured prefetch: profile the workload's own compiled touch
        # columns and pin the measured hot set before the trace runs.
        # Lazy import — repro_torch.svm.hotset only reads frozen op columns.
        # This is repro_torch.core, where driving mgr.pin directly is the
        # sanctioned scalar-reference idiom (cf. `apply_trace`); the
        # profile is a pure function of the trace, so the scalar engine
        # pins the identical set the batched engine does.
        import numpy as np

        from repro_torch.svm.hotset import HotSetProfile

        size_arr = np.asarray([r.end - r.start for r in space.ranges],
                              dtype=np.int64)
        prof = HotSetProfile.from_trace(ct, size_arr)
        budget = float(measured_pin) * mgr.capacity
        for rid in prof.select_hot_rids(mgr.capacity, budget):
            mgr.pin(int(rid))
    if engine == "batched":
        from repro_torch.core.engine import execute_compiled
        execute_compiled(ct, mgr)
    else:
        apply_trace(mgr, workload.trace(space), max_ops=max_ops)
    flush = getattr(mgr, "flush", None)
    if flush is not None:            # end-of-trace driver sync (UVM)
        flush()
    wall = max(mgr.wall, 1e-12)
    return RunResult(
        workload=workload.name,
        dos=space.dos(),
        wall_s=mgr.wall,
        work_units=workload.work_units(),
        throughput=workload.work_units() / wall,
        summary=mgr.summary(),
        manager=mgr,
    )


def apply_trace(mgr: SVMManager, trace: Iterable[Op],
                max_ops: int | None = None) -> None:
    """Drive a manager through a trace one op at a time — the scalar
    reference loop every batched tier is byte-identical to."""
    n = 0
    for op in trace:
        tag = op[0]
        if tag == "touch":
            _, rid, conc, hint = op
            mgr.touch(rid, concurrency=conc, page_hint=hint)
        elif tag == "compute":
            mgr.advance(op[1])
        elif tag == "writeback":
            mgr.writeback(op[1])
        elif tag == "pin":
            mgr.pin(op[1])
        elif tag == "unpin":
            mgr.unpin(op[1])
        elif tag == "spill":
            while mgr.free < op[1] and \
                    mgr.spill_oldest(overlap=op[2]) is not None:
                pass
        elif tag == "kernel":
            pass
        else:
            raise ValueError(f"unknown trace op {tag!r}")
        n += 1
        if max_ops is not None and n >= max_ops:
            break


def dos_sweep(
    make_workload,
    dos_values: Iterable[float],
    capacity_bytes: int = 64 * GB,
    *,
    normalize_at: float = 78.0,
    policy: str = "lrf",
    params: CostParams = MI250X,
    engine: str = "batched",
    manager: str = "svm",
    jobs: int = 0,
    cache_dir: str | None = None,
    **mgr_kwargs,
) -> list[dict]:
    """Run a workload at several problem sizes (expressed as target DOS %)
    and report throughput normalised to the `normalize_at` point
    (paper Fig. 6).

    ``make_workload`` is either a callable ``bytes -> Workload`` (run
    serially in-process) or a picklable spec tuple ``(name, kwargs)``
    resolved via `repro_torch.core.traces.make_workload`, which additionally
    allows fanning the DOS points out across ``jobs`` worker processes
    with an optional content-keyed on-disk ``cache_dir``
    (see `repro_torch.core.sweep`).  When ``normalize_at`` is not one of
    ``dos_values``, the anchor point rides in the same `run_sweep` batch
    as the main rows — same cache, worker fan-out, and engine selection."""
    dos_values = list(dos_values)
    anchor_idx = next((i for i, d in enumerate(dos_values)
                       if abs(d - normalize_at) < 1e-9), None)
    if not callable(make_workload):
        from repro_torch.core.sweep import SweepPoint, run_sweep
        name, wl_kwargs = make_workload

        def point(dos):
            return SweepPoint.make(name, capacity_bytes * dos / 100.0,
                                   capacity_bytes, policy=policy,
                                   wl_kwargs=dict(wl_kwargs),
                                   mgr_kwargs=mgr_kwargs, engine=engine,
                                   manager=manager)

        points = [point(dos) for dos in dos_values]
        if anchor_idx is None:
            points.append(point(normalize_at))
        all_rows = run_sweep(points, jobs=jobs, params=params,
                             cache_dir=cache_dir)
        rows = all_rows[:len(dos_values)]
        base_thr = (rows[anchor_idx] if anchor_idx is not None
                    else all_rows[-1])["throughput"]
    else:
        from repro_torch.core.sweep import MANAGERS
        manager_cls = MANAGERS[manager]
        rows = []
        for dos in dos_values:
            wl = make_workload(int(capacity_bytes * dos / 100.0))
            res = simulate(wl, capacity_bytes, policy=policy, params=params,
                           profile=False, engine=engine,
                           manager_cls=manager_cls, **mgr_kwargs)
            rows.append(res.row())
        if anchor_idx is not None:
            base_thr = rows[anchor_idx]["throughput"]
        else:
            wl = make_workload(int(capacity_bytes * normalize_at / 100.0))
            base_thr = simulate(wl, capacity_bytes, policy=policy,
                                params=params, profile=False, engine=engine,
                                manager_cls=manager_cls,
                                **mgr_kwargs).throughput
    for row in rows:
        row["norm_perf"] = row["throughput"] / base_thr
    return rows

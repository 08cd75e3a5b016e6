"""Parallel scenario-sweep runner with a content-keyed result cache.

The paper's headline figures (6–10) are grids over
(workload × DOS × policy × §4.2 driver variant).  Points are independent,
so the runner fans them out across a ``ProcessPoolExecutor`` and memoises
each point's result row on disk, keyed by the *content* of the scenario:
the point spec, the cost-model parameters, and a digest of the simulator
sources.  Re-running a figure suite after a code change recomputes only
what the change invalidates; re-running unchanged figures is pure cache
hits.

Points are plain data (workload *name* + kwargs, resolved via
`repro_torch.core.traces.make_workload` inside the worker), so they pickle
cleanly and hash stably.

Compiled-trace sharing: a workload's lowered op columns depend only on
(workload, total_bytes, wl_kwargs, capacity, base) — not on the policy /
variant / manager axes — so `trace_key` derives a `TraceKey` per point and
`run_sweep` groups pending points by it.  Each worker process receives
whole groups and compiles each distinct trace once (into the in-process
`repro_torch.core.engine.TRACE_CACHE` LRU), replaying it across its group's
points.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Iterable, Sequence

from repro_torch.core.costmodel import CostParams, MI250X
from repro_torch.core.ranges import DEFAULT_BASE as BASE

_CODE_DIGEST: str | None = None


def _code_digest() -> str:
    """Digest of the simulator sources: part of every cache key, so cached
    rows invalidate when the model code changes."""
    global _CODE_DIGEST
    if _CODE_DIGEST is None:
        h = hashlib.sha256()
        core = os.path.dirname(os.path.abspath(__file__))
        for fn in sorted(os.listdir(core)):
            if fn.endswith(".py"):
                with open(os.path.join(core, fn), "rb") as f:
                    h.update(f.read())
        _CODE_DIGEST = h.hexdigest()[:16]
    return _CODE_DIGEST


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    """One scenario: a workload instance against one driver configuration.

    ``wl_kwargs``/``mgr_kwargs`` are sorted ``(key, value)`` tuples so the
    point is hashable and its JSON form is canonical.  ``zero_copy`` is a
    tuple of allocation names, or the sentinel ``"biggest"`` (resolved in
    the worker to the workload's largest allocation).  ``manager`` selects
    the driver model: ``"svm"`` (default) or ``"uvm"`` (Table-1
    baseline).  ``measured_pin`` > 0 turns on measured prefetching
    (docs/prefetching.md): the measured hot set, byte-bounded to that
    fraction of capacity, is pinned before the trace runs."""

    workload: str
    total_bytes: int
    capacity: int
    policy: str = "lrf"
    wl_kwargs: tuple = ()
    mgr_kwargs: tuple = ()
    zero_copy: tuple | str = ()
    engine: str = "batched"
    profile: bool = False
    manager: str = "svm"
    measured_pin: float = 0.0

    @classmethod
    def make(cls, workload: str, total_bytes: int, capacity: int, *,
             policy: str = "lrf", wl_kwargs: dict | None = None,
             mgr_kwargs: dict | None = None,
             zero_copy: tuple | str = (), engine: str = "batched",
             profile: bool = False, manager: str = "svm",
             measured_pin: float = 0.0) -> "SweepPoint":
        """Build a point from plain dict kwargs, owning the sorted-tuple
        normalisation so every call site produces identical cache keys."""
        return cls(workload=workload, total_bytes=int(total_bytes),
                   capacity=capacity, policy=policy,
                   wl_kwargs=tuple(sorted((wl_kwargs or {}).items())),
                   mgr_kwargs=tuple(sorted((mgr_kwargs or {}).items())),
                   zero_copy=zero_copy, engine=engine, profile=profile,
                   manager=manager, measured_pin=float(measured_pin))

    def key(self, params: CostParams) -> str:
        blob = json.dumps(
            [dataclasses.astuple(self), dataclasses.astuple(params),
             _code_digest()],
            sort_keys=True, default=str)
        return hashlib.sha256(blob.encode()).hexdigest()


def _managers() -> dict:
    from repro_torch.core.svm import SVMManager
    from repro_torch.core.uvm import UVMManager
    return {"svm": SVMManager, "uvm": UVMManager}


class _ManagerMap:
    """Lazy name -> manager-class map (avoids import cycles at load)."""

    def __getitem__(self, name: str):
        try:
            return _managers()[name]
        except KeyError:
            raise ValueError(f"unknown manager {name!r}; "
                             f"available: {sorted(_managers())}") from None


MANAGERS = _ManagerMap()


def trace_key(point: SweepPoint, base: int = BASE,
              max_ops: int | None = None) -> tuple:
    """TraceKey: the fields that fully determine a point's lowered trace.

    Policy / variant / manager / profile axes deliberately excluded —
    points differing only in those replay one compiled trace."""
    return (point.workload, int(point.total_bytes), point.wl_kwargs,
            point.capacity, base, max_ops)


def hotset_grid(total_bytes: int, capacities: Sequence[int], *,
                policies: Sequence[str] = ("lrf",),
                modes: Sequence[str] = ("static", "dynamic",
                                        "oscillating"),
                ops: int = 4096, seed: int = 0,
                measured_pins: Sequence[float] = (0.0,),
                **hot_kwargs) -> "list[SweepPoint]":
    """Scenario grid over the synthetic hot-set adversaries
    (`repro_torch.core.traces.HotSet`): mode × capacity × eviction policy
    (× measured-prefetch fraction when ``measured_pins`` lists more than
    the off point — 0.0 is the paper's aggressive default, > 0 pins the
    measured hot set up-front, docs/prefetching.md).

    Each mode shares one `trace_key` per capacity-independent axis, so
    `run_sweep` compiles three traces and replays them across the whole
    grid — the cheap way to stress phase-change behaviour alongside the
    Table-2 suite."""
    return [
        SweepPoint.make("hotset", total_bytes, cap, policy=pol,
                        wl_kwargs={"mode": mode, "ops": ops, "seed": seed,
                                   **hot_kwargs},
                        measured_pin=mp)
        for mode in modes for cap in capacities for pol in policies
        for mp in measured_pins
    ]


def run_point(point: SweepPoint, params: CostParams = MI250X, *,
              trace_cache=True) -> dict:
    """Execute one sweep point; returns the flat result row.

    ``trace_cache``: True (default) memoises the compiled trace in the
    process-wide `repro_torch.core.engine.TRACE_CACHE` under `trace_key(point)`;
    pass a `TraceCache` to use a private cache, or False to recompile."""
    from repro_torch.core.simulator import simulate
    from repro_torch.core.traces import make_workload

    cache = key = None
    if trace_cache is not False and point.engine == "batched":
        from repro_torch.core.engine import TRACE_CACHE
        cache = TRACE_CACHE if trace_cache is True else trace_cache
        key = trace_key(point)
    # strings pass through to simulate untupled: "biggest" resolves there
    # off the same build used to run; any other string raises there
    # (tuple() would silently split a bare name into characters)
    zero_copy = point.zero_copy
    if not isinstance(zero_copy, str):
        zero_copy = tuple(zero_copy)
    res = simulate(
        make_workload(point.workload, point.total_bytes,
                      **dict(point.wl_kwargs)),
        point.capacity,
        base=BASE,
        policy=point.policy,
        params=params,
        profile=point.profile,
        engine=point.engine,
        manager_cls=MANAGERS[point.manager],
        zero_copy_alloc_names=zero_copy,
        trace_cache=cache,
        trace_key=key,
        measured_pin=point.measured_pin,
        **dict(point.mgr_kwargs),
    )
    return res.row()


def _run_group_job(args: tuple) -> list[tuple[int, dict]]:
    """Worker job: one TraceKey group — the trace is compiled once into
    the worker's in-process LRU and replayed across the group's points."""
    items, params = args
    return [(i, run_point(p, params)) for i, p in items]


def run_sweep(
    points: Sequence[SweepPoint] | Iterable[SweepPoint],
    *,
    jobs: int | None = 0,
    params: CostParams = MI250X,
    cache_dir: str | None = None,
    stats: dict | None = None,
) -> list[dict]:
    """Run a grid of sweep points, in order-preserving fashion.

    ``jobs``: 0/1 = serial in-process, None = one worker per CPU, N = N
    worker processes.  Pool *infrastructure* failures (restricted
    sandboxes: fork/pipe/import errors, broken pools) fall back to serial
    execution; a point that raises inside a worker propagates its own
    exception either way.  With ``cache_dir`` set, each point's row is
    cached on disk under its content key.  Pass a dict as ``stats`` to
    receive {"cached": n, "computed": m, "trace_groups": g}.

    Scheduling is **grid-aware**: pending points are grouped by
    `trace_key` and dispatched group-wise, so a worker compiles each
    distinct trace once and replays it across that group's
    policy/variant/manager points (serial execution walks the same
    grouped order and shares through the in-process LRU likewise).
    Groups larger than an even per-worker share are split so sharing
    never reduces fan-out below the worker count.
    """
    points = list(points)
    rows: list[dict | None] = [None] * len(points)

    pending: list[tuple[int, SweepPoint]] = []
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        for i, p in enumerate(points):
            path = os.path.join(cache_dir, p.key(params) + ".json")
            if os.path.exists(path):
                try:
                    with open(path) as f:
                        rows[i] = json.load(f)
                    continue
                except (OSError, ValueError):
                    pass
            pending.append((i, p))
    else:
        pending = list(enumerate(points))

    # group by TraceKey: one compile per distinct trace per worker
    groups: dict[tuple, list[tuple[int, SweepPoint]]] = {}
    for i, p in pending:
        groups.setdefault(trace_key(p), []).append((i, p))
    grouped = list(groups.values())

    if stats is not None:
        stats["cached"] = len(points) - len(pending)
        stats["computed"] = len(pending)
        stats["trace_groups"] = len(grouped)

    if pending:
        results: list[tuple[int, dict]] | None = None
        n_jobs = os.cpu_count() if jobs is None else jobs
        if n_jobs and n_jobs > 1 and len(pending) > 1:
            from concurrent.futures import ProcessPoolExecutor
            from concurrent.futures.process import BrokenProcessPool
            # split groups into dispatch units so trace sharing never caps
            # parallelism below the worker count: a split group recompiles
            # once per extra worker (milliseconds on the columnar tier) in
            # exchange for full execution fan-out
            per_unit = max(1, -(-len(pending) // n_jobs))
            units = [g[k:k + per_unit] for g in grouped
                     for k in range(0, len(g), per_unit)]
            # longest-unit-first dispatch: pool.map hands units out in
            # order, so a big group scheduled last would serialise the
            # tail of the sweep behind one worker
            units.sort(key=len, reverse=True)
            pool = None
            try:
                pool = ProcessPoolExecutor(
                    max_workers=min(n_jobs, len(units)))
            except (OSError, ImportError):
                pool = None        # sandbox without fork/pipe support
            if pool is not None:
                try:
                    with pool:
                        results = [r for chunk in pool.map(
                            _run_group_job,
                            [(u, params) for u in units])
                            for r in chunk]
                except BrokenProcessPool:
                    # workers died (OOM kill, hard crash); a point's own
                    # exception propagates unmodified instead
                    import sys
                    print("run_sweep: worker pool died, rerunning "
                          f"{len(pending)} pending points serially",
                          file=sys.stderr)
                    results = None
        if results is None:
            results = [(i, run_point(p, params))
                       for g in grouped for i, p in g]
        for i, row in results:
            rows[i] = row
            if cache_dir:
                path = os.path.join(cache_dir,
                                    points[i].key(params) + ".json")
                try:
                    with open(path, "w") as f:
                        json.dump(row, f)
                except OSError:
                    pass
    return rows  # type: ignore[return-value]

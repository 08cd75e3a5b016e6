"""Multi-tenant serving scheduler over one shared SVM device pool.

The paper's central finding — aggressive prefetch plus eviction thrashes
under oversubscription — bites hardest when *many concurrent decode
streams* contend for one device pool.  This module multiplexes N serving
requests (heterogeneous architectures, seeded synthetic arrival process)
over a **single** `SVMManager`:

  * each admitted request's weights are planned at its own offset into the
    shared `AddressSpace` (`plan_leaf_ranges(space=…, align_start=True)` —
    alignment-padded starts keep same-architecture plans congruent),
  * every token is driven through the request's own `TraceSession`, and
    sessions share one `SegmentCache`: the first token of the first
    request of an architecture records + compiles the per-token trace,
    every same-architecture request thereafter **relocates and replays the
    same compiled segment** (the cross-request analogue of the sweep
    runner's cross-point ``TRACE_CACHE``),
  * per-request wall/migration/eviction accounting is attributed from
    manager counter deltas around each replay, so the per-request rows
    sum exactly to the shared manager's aggregates (conservation —
    tested).

Scheduling policies (`policy=`):

  * ``fifo``       — admit every arrived request immediately and
                     round-robin one token per request: the thrashing
                     baseline.  Aggregate working set = all arrived
                     requests; under oversubscription LRF evicts each
                     tenant's earliest-fetched layers right before its
                     next token needs them (the paper's cyclic-traversal
                     pathology, multiplied by N tenants).
  * ``admission``  — cap the *admitted* working-set bytes at
                     ``admit_watermark × capacity``; later arrivals queue
                     (head-of-line, FIFO).  Trades queueing delay for a
                     pool that actually fits what is running — the
                     paper's §5 "SVM-aware scheduling" direction: treat
                     placement pressure as an admission input.
  * ``svm_aware``  — admission, plus per-request pinning of the hottest
                     leaf (app-directed placement, §4.1; skipped when the
                     leaf would monopolise the pool — the pinned-full-pool
                     deadlock guard), plus same-architecture token
                     batching in the round-robin order so consecutive
                     replays hit the same shared compiled segment.

The scheduler never drives the manager's touch/advance entry points
directly — every access is a recorded op replayed through the engine
(`scalar=True` replays op-for-op; byte-identical by the engine's
equivalence guarantee), and the whole run is deterministic under a fixed
seed.

The port's copy of ``repro.svm.scheduler``: specs come from torch param
trees (`ModelSpec.from_params` walks `repro_torch.bridge.leaves`), and the
default rates are the H100 preset (`H100_HOST`, `H100_SERVE_FLOPS`). Every
other operation keeps the reference's order, so a run given the
reference's rates returns the reference's floats bit for bit."""

from __future__ import annotations

import dataclasses
import functools
import math
from collections import OrderedDict, deque
from typing import Any, Sequence

import numpy as np

from repro_torch.core import (
    AddressSpace,
    MigrationError,
    SVMManager,
    SegmentCache,
    TraceSession,
    execute_fused,
)
from repro_torch.bridge import leaves as tree_leaves
from repro_torch.core.costmodel import CostParams, H100_HOST, H100_SERVE_FLOPS
from repro_torch.core.ranges import DEFAULT_BASE
from repro_torch.ft.retry import RetryError, RetryPolicy, retry_call
from repro_torch.svm.faults import FaultInjector, FaultPlan
from repro_torch.svm.hotset import ProfileCache, spec_profile
from repro_torch.svm.planner import ParamRanges, plan_leaf_ranges

PyTree = Any

POLICIES = ("fifo", "admission", "svm_aware")
ARRIVALS = ("burst", "poisson", "uniform")
#: what the admission watermark caps (docs/prefetching.md):
#:   bytes    — total plan bytes (the paper's baseline: admit by what a
#:              tenant *allocates*)
#:   measured — estimated resident working-set bytes from the tenant's
#:              own touch columns (`repro_torch.svm.hotset.spec_profile`):
#:              admit by what it actually keeps resident, so sparse /
#:              streaming tenants stop reserving room they never use
ADMIT_MODES = ("bytes", "measured")


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """A serving request's weight-streaming shape: named leaves in fetch
    order, the per-token layer→leaf fetch groups, and per-layer FLOPs.

    Frozen and hashable — equal specs share compiled per-token segments
    across requests (the spec itself is the segment key)."""

    arch: str
    leaves: tuple[tuple[str, int], ...]          # (path, nbytes)
    layer_paths: tuple[tuple[str, ...], ...]     # per-layer leaf groups
    flops_per_layer: tuple[float, ...]

    @functools.cached_property
    def total_bytes(self) -> int:
        # cached: `_fits` reads this on every admission probe (cached_
        # property writes the instance __dict__ directly, which a frozen
        # dataclass permits; equality/hash stay field-based)
        return sum(n for _, n in self.leaves)

    def __hash__(self) -> int:
        # specs key every segment-cache lookup (twice per token); the
        # generated dataclass hash re-walks the leaf/path tuples each
        # call, so memoise it (same __dict__ side door as total_bytes)
        h = self.__dict__.get("_hash")
        if h is None:
            h = hash((self.arch, self.leaves, self.layer_paths,
                      self.flops_per_layer))
            self.__dict__["_hash"] = h
        return h

    @property
    def hot_leaf(self) -> tuple[str, int]:
        """The largest leaf — the pinning candidate under ``svm_aware``."""
        return max(self.leaves, key=lambda pn: pn[1])

    @classmethod
    def from_params(cls, arch: str, params: PyTree,
                    batch: int = 1) -> "ModelSpec":
        """Spec from a real parameter tree: one fetch group per leaf in
        model order, per-leaf decode FLOPs ≈ 2 · batch · params (the
        `WeightStream` convention). Leaves in `repro_torch.bridge.leaves`
        order, sized from their metadata only, so CUDA tensors need no
        copy or sync and meta tensors give a spec without weights."""
        leaves, layer_paths, flops = [], [], []
        for path, leaf in tree_leaves(params):
            n = leaf.numel()
            leaves.append((path, n * leaf.element_size()))
            layer_paths.append((path,))
            flops.append(2.0 * batch * n)
        return cls(arch=arch, leaves=tuple(leaves),
                   layer_paths=tuple(layer_paths),
                   flops_per_layer=tuple(flops))

    @classmethod
    def synthetic(cls, arch: str, n_layers: int, layer_bytes: int, *,
                  embed_bytes: int = 0, batch: int = 1) -> "ModelSpec":
        """A uniform synthetic decoder: optional embedding leaf (touched
        first and last per token — the hot leaf) plus ``n_layers`` equal
        weight leaves.  FLOPs assume fp32 leaves (2 · batch · params)."""
        leaves: list[tuple[str, int]] = []
        layer_paths: list[tuple[str, ...]] = []
        flops: list[float] = []

        def add(path: str, nbytes: int) -> None:
            leaves.append((path, int(nbytes)))
            layer_paths.append((path,))
            flops.append(2.0 * batch * (nbytes / 4.0))

        if embed_bytes:
            add(f"{arch}/embed", embed_bytes)
        for i in range(n_layers):
            add(f"{arch}/l{i:03d}", layer_bytes)
        if embed_bytes:
            # tied head re-read: the embedding leaf is touched again
            layer_paths.append((f"{arch}/embed",))
            flops.append(2.0 * batch * (embed_bytes / 4.0))
        return cls(arch=arch, leaves=tuple(leaves),
                   layer_paths=tuple(layer_paths),
                   flops_per_layer=tuple(flops))

    @classmethod
    def synthetic_moe(cls, arch: str, n_layers: int, layer_bytes: int, *,
                      n_experts: int = 8, active_experts: int = 1,
                      expert_bytes: int | None = None,
                      embed_bytes: int = 0, batch: int = 1) -> "ModelSpec":
        """A sparse mixture-of-experts decoder: per layer, one dense leaf
        plus ``n_experts`` expert leaves of which only the first
        ``active_experts`` are routed to (greedy decode with a fixed
        router — deterministic, so the spec stays a pure data shape).

        The inactive experts are *planned* (they count toward
        ``total_bytes`` — the plan must hold them) but never appear in
        ``layer_paths``, so they are never touched: plan bytes ≫ touched
        bytes.  This is exactly the tenant shape plan-bytes admission
        over-charges and measured admission (``admit_by="measured"``,
        docs/prefetching.md) admits at its true resident cost."""
        if not 0 <= active_experts <= n_experts:
            raise ValueError(f"active_experts {active_experts} outside "
                             f"[0, {n_experts}]")
        eb = layer_bytes if expert_bytes is None else int(expert_bytes)
        leaves: list[tuple[str, int]] = []
        layer_paths: list[tuple[str, ...]] = []
        flops: list[float] = []
        if embed_bytes:
            leaves.append((f"{arch}/embed", int(embed_bytes)))
            layer_paths.append((f"{arch}/embed",))
            flops.append(2.0 * batch * (embed_bytes / 4.0))
        for i in range(n_layers):
            dense = f"{arch}/l{i:03d}/dense"
            leaves.append((dense, int(layer_bytes)))
            routed = tuple(f"{arch}/l{i:03d}/e{j:02d}"
                           for j in range(active_experts))
            leaves.extend((f"{arch}/l{i:03d}/e{j:02d}", eb)
                          for j in range(n_experts))
            layer_paths.append((dense,) + routed)
            layer_flops = (layer_bytes + active_experts * eb) / 4.0
            flops.append(2.0 * batch * layer_flops)
        if embed_bytes:
            layer_paths.append((f"{arch}/embed",))
            flops.append(2.0 * batch * (embed_bytes / 4.0))
        return cls(arch=arch, leaves=tuple(leaves),
                   layer_paths=tuple(layer_paths),
                   flops_per_layer=tuple(flops))


@dataclasses.dataclass(eq=False)
class Request:
    """One decode stream: its spec, arrival time, decode length, and —
    once admitted — its plan/session plus attributed accounting.

    ``eq=False``: requests are unique mutable objects; identity equality
    keeps ``active.remove(req)`` a pointer scan instead of a full
    field-by-field compare against every co-active request."""

    req_id: int
    spec: ModelSpec
    arrival_s: float
    n_tokens: int
    # filled at admission
    plan: ParamRanges | None = None
    session: TraceSession | None = None
    admit_seq: int = -1
    admit_s: float = -1.0
    first_token_s: float = -1.0
    finish_s: float = -1.0
    tokens_done: int = 0
    pinned_rids: tuple[int, ...] = ()
    pinned_bytes: int = 0
    # manager-counter deltas attributed to this request's replays
    migrations: int = 0
    evictions: int = 0
    bytes_migrated: int = 0
    bytes_evicted: int = 0
    svm_wall_s: float = 0.0
    # chaos / recovery accounting (docs/robustness.md)
    faults: int = 0            # migration faults this request absorbed
    retries: int = 0           # bounded-retry attempts after faults
    backoff_s: float = 0.0     # simulated backoff wall charged to it
    crashes: int = 0           # mid-decode crashes survived
    preemptions: int = 0       # thrash-guard preemptions survived
    resumes: int = 0           # re-admissions from carried session state
    failed: bool = False       # dropped after retry-budget exhaustion
    not_before_s: float = 0.0  # re-admission backoff gate

    @property
    def latency_s(self) -> float:
        return self.finish_s - self.arrival_s

    @property
    def queue_wait_s(self) -> float:
        return self.admit_s - self.arrival_s

    def row(self) -> dict:
        """Flat per-request result row."""
        return {
            "req_id": self.req_id, "arch": self.spec.arch,
            "bytes": self.spec.total_bytes, "arrival_s": self.arrival_s,
            "admit_s": self.admit_s, "finish_s": self.finish_s,
            "latency_s": self.latency_s,
            "queue_wait_s": self.queue_wait_s,
            "ttft_s": ((self.first_token_s - self.arrival_s)
                       if self.tokens_done else 0.0),
            "tokens": self.tokens_done,
            "migrations": self.migrations, "evictions": self.evictions,
            "bytes_migrated": self.bytes_migrated,
            "bytes_evicted": self.bytes_evicted,
            "svm_wall_s": self.svm_wall_s,
            "pinned_bytes": self.pinned_bytes,
            "faults": self.faults, "retries": self.retries,
            "backoff_s": self.backoff_s, "crashes": self.crashes,
            "preemptions": self.preemptions, "resumes": self.resumes,
            "failed": self.failed,
        }


def make_requests(specs: Sequence[ModelSpec], n_requests: int, *,
                  seed: int = 0, mean_interarrival_s: float = 0.0,
                  arrival: str = "poisson", tokens: int = 32,
                  token_jitter: int = 0,
                  spec_choice: str = "random") -> list[Request]:
    """Seeded synthetic arrival process.

    ``arrival``: ``burst`` (everything at t=0 — also forced when
    ``mean_interarrival_s`` is 0), ``poisson`` (exponential
    interarrivals), or ``uniform`` (fixed spacing).  Specs are drawn
    ``random``-ly or assigned ``roundrobin``; decode lengths are
    ``tokens ± token_jitter``.  Same seed ⇒ same request list."""
    if arrival not in ARRIVALS:
        raise ValueError(f"unknown arrival {arrival!r}; "
                         f"available: {ARRIVALS}")
    if spec_choice not in ("random", "roundrobin"):
        raise ValueError(f"unknown spec_choice {spec_choice!r}")
    rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    for i in range(n_requests):
        if i > 0 and mean_interarrival_s > 0.0 and arrival != "burst":
            t += (float(rng.exponential(mean_interarrival_s))
                  if arrival == "poisson" else mean_interarrival_s)
        spec = (specs[i % len(specs)] if spec_choice == "roundrobin"
                else specs[int(rng.integers(len(specs)))])
        n_tok = tokens if not token_jitter else int(
            rng.integers(max(1, tokens - token_jitter),
                         tokens + token_jitter + 1))
        out.append(Request(req_id=i, spec=spec, arrival_s=t,
                           n_tokens=n_tok))
    return out


class PoolScheduler:
    """Multiplex decode requests over one shared SVM device pool.

    One `AddressSpace` + one `SVMManager` + one shared `SegmentCache`;
    requests are admitted, planned, and interleaved per the scheduling
    ``policy`` (see module docstring).  `run(requests)` drives every
    request to completion on the simulated clock and returns the
    aggregate/percentile report."""

    def __init__(self, capacity_bytes: int, *, policy: str = "svm_aware",
                 evict_policy: str = "lrf",
                 cost_params: CostParams = H100_HOST,
                 admit_watermark: float = 1.0, admit_by: str = "bytes",
                 pin_frac: float = 0.25,
                 concurrency: int = 64, compute_rate: float | None = None,
                 scalar: bool = False, fused: bool = True,
                 base: int = DEFAULT_BASE,
                 segment_cache_size: int = 512,
                 concat_memo_size: int = 16,
                 fault_plan: FaultPlan | None = None,
                 retry_policy: RetryPolicy | None = None,
                 thrash_watermark: float | None = None,
                 thrash_window: int = 64):
        if policy not in POLICIES:
            raise ValueError(f"unknown scheduling policy {policy!r}; "
                             f"available: {POLICIES}")
        if admit_by not in ADMIT_MODES:
            raise ValueError(f"unknown admit_by {admit_by!r}; "
                             f"available: {ADMIT_MODES}")
        self.policy = policy
        self.admit_by = admit_by
        self.capacity = capacity_bytes
        self.space = AddressSpace(capacity_bytes, base=base)
        self.mgr = SVMManager(self.space, policy=evict_policy,
                              params=cost_params, profile=False)
        self.shared_cache = SegmentCache(segment_cache_size)
        self.admit_watermark = admit_watermark
        self.pin_frac = pin_frac
        self.concurrency = concurrency
        # serving compute rate: the card's measured decode rate unless
        # overridden
        self.compute_rate = (compute_rate if compute_rate is not None
                             else H100_SERVE_FLOPS)
        self.scalar = scalar
        # fused round replay: one concatenated mega-trace per scheduler
        # round, executed in a single batched-interpreter pass with
        # per-request attribution sampled at the segment cuts.  Byte-
        # identical to the per-token loop; ``fused=False`` (and scalar
        # mode, which has no batched interpreter) keep the golden
        # reference path.
        self.fused = bool(fused) and not scalar
        self.now = 0.0
        self.admitted_bytes = 0
        self.peak_admitted_bytes = 0
        self.peak_active_requests = 0
        self.pinned_bytes_total = 0
        # measured admission: per-spec profile + memoised admission cost
        # (the cost is a pure function of (spec, nominal capacity), so
        # the same number is added at admit and subtracted at retire /
        # evacuate even if chaos resizes the live pool in between)
        self._profile_cache = ProfileCache()
        self._admit_cost_memo: dict[ModelSpec, int] = {}
        self._admit_seq = 0
        self._geometry: dict[ModelSpec, tuple] = {}
        self._plan_proto: dict[ModelSpec, ParamRanges] = {}
        self._sessions: list[TraceSession] = []
        # round-shape memo: identical segment tuples (by identity — the
        # per-session LRUs hand back the same relocated objects every
        # steady-state round) reuse one concatenated mega-trace.  Bounded
        # (LRU) so thousand-round schedules with churning round shapes
        # cannot grow host memory without limit; evictions are counted
        # and surfaced in the result's ``shared_cache`` block.
        self._concat_memo: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._concat_memo_size = max(int(concat_memo_size), 1)
        self._concat_evictions = 0

        # ---- chaos layer + runtime guards (docs/robustness.md)
        self.injector = (FaultInjector(fault_plan)
                         if fault_plan is not None else None)
        self.retry_policy = (retry_policy if retry_policy is not None
                             else RetryPolicy(max_attempts=4,
                                              base_delay_s=1e-4))
        # thrash detector: sliding evictions-per-token watermark over
        # manager counter deltas (None = guard off)
        self.thrash_watermark = thrash_watermark
        self.thrash_window = max(int(thrash_window), 1)
        self._thrash_hist: "deque[tuple[int, int]]" = deque()
        self._thrash_cooldown = 0
        self._tokens_total = 0
        self._pending_fail_attempts = 0
        self.cost_scale = 1.0
        self.failed: list[Request] = []
        self.incidents: list[str] = []
        self._chaos = {
            "migration_faults": 0, "retries": 0, "retry_exhausted": 0,
            "crashes": 0, "preemptions": 0, "resumes": 0,
            "capacity_events": 0, "slow_page_windows": 0,
            "degraded_rounds": 0, "fused_fallbacks": 0,
            "thrash_trips": 0, "backoff_wall_s": 0.0,
        }

    # -------------------------------------------------------- admission

    def _admit_cost(self, spec: ModelSpec) -> int:
        """What a tenant charges against the admission watermark.

        ``bytes`` mode: total plan bytes.  ``measured`` mode: the
        estimated resident working set from the spec's own touch columns
        (hot set + one streaming buffer, capped at plan bytes — a
        measured cost must never exceed the allocation it measures).
        Memoised per spec with the *nominal* capacity as the pressure
        window, so the ledger adds and subtracts the identical number
        for a tenant even when chaos resizes the live pool mid-flight,
        and congruent tenants share one profile via the cache."""
        if self.admit_by == "bytes":
            return spec.total_bytes
        cost = self._admit_cost_memo.get(spec)
        if cost is None:
            prof = spec_profile(spec, cache=self._profile_cache,
                                concurrency=self.concurrency)
            cost = min(spec.total_bytes,
                       prof.resident_bytes(self.capacity))
            self._admit_cost_memo[spec] = cost
        return cost

    def _fits(self, spec: ModelSpec) -> bool:
        # admission probes the *effective* pool: a chaos capacity loss
        # (mgr.resize_capacity) tightens admission until it is restored
        cap = min(self.capacity, self.mgr.capacity)
        return (self.admitted_bytes + self._admit_cost(spec)
                <= self.admit_watermark * cap)

    def _admit(self, queued: "deque[Request]",
               active: list[Request]) -> None:
        while queued:
            head = queued[0]
            if head.not_before_s > self.now + 1e-12:
                # crash/preemption re-admission backoff: the head waits
                # out its gate (head-of-line, like admission control)
                break
            if self.policy != "fifo" and not self._fits(head.spec):
                # head-of-line admission control; an oversized request
                # that can never fit is admitted alone rather than
                # deadlocking the queue
                if active or self.admitted_bytes > 0:
                    break
            self._admit_one(queued.popleft(), active)

    def _admit_one(self, req: Request, active: list[Request]) -> None:
        if req.plan is None:
            proto_plan = self._plan_proto.get(req.spec)
            if proto_plan is not None:
                # repeated architecture: congruent clone of the
                # prototype plan (geometry equality by construction)
                req.plan = proto_plan.clone_into(self.space)
            else:
                req.plan = plan_leaf_ranges(
                    req.spec.leaves, self.capacity, space=self.space,
                    align_start=True)
                geo = req.plan.geometry()
                proto = self._geometry.setdefault(req.spec, geo)
                if geo != proto:  # pragma: no cover — congruent by design
                    raise AssertionError(
                        f"req {req.req_id}: plan geometry diverged from "
                        f"its spec's prototype; segment sharing would be "
                        f"unsound")
                self._plan_proto[req.spec] = req.plan
            req.session = TraceSession(
                self.mgr, scalar=self.scalar, cache_size=8,
                shared_cache=self.shared_cache, rid_base=req.plan.rid_base)
            self._sessions.append(req.session)
            req.admit_s = self.now
        else:
            # crash/preemption resume: the plan, session, and compiled
            # segments carry over — re-admission replays nothing
            req.resumes += 1
            self._chaos["resumes"] += 1
        req.admit_seq = self._admit_seq
        self._admit_seq += 1
        self.admitted_bytes += self._admit_cost(req.spec)
        self.peak_admitted_bytes = max(self.peak_admitted_bytes,
                                       self.admitted_bytes)
        active.append(req)
        self.peak_active_requests = max(self.peak_active_requests,
                                        len(active))
        if self.policy == "svm_aware":
            self._pin_hot_leaf(req)

    def _pin_hot_leaf(self, req: Request) -> None:
        """App-directed placement (§4.1): pin the request's hottest leaf —
        unless it would monopolise the pool (no leaf above half the
        capacity, and all pins together stay under ``pin_frac``): a
        pinned-full pool deadlocks every later migration."""
        path, nbytes = req.spec.hot_leaf
        if nbytes > self.capacity // 2:
            return
        if self.pinned_bytes_total + nbytes > self.pin_frac * self.capacity:
            return
        rids = tuple(req.plan.leaf_ranges[path])
        self._replay_attributed(
            req, lambda: self._run_pin_segment(req, "pin", rids))
        req.pinned_rids = rids
        req.pinned_bytes = nbytes
        self.pinned_bytes_total += nbytes

    def _run_pin_segment(self, req: Request, kind: str,
                         rids: tuple[int, ...]) -> None:
        """Replay the request's (un)pin segment via the keyed segment
        path: every same-architecture request records the congruent rid
        block, so after the first admission the segment comes out of the
        shared cache as a pure rid-shift relocation instead of a
        per-request record + seal."""
        op = TraceSession.pin if kind == "pin" else TraceSession.unpin

        def record(s: TraceSession) -> None:
            for rid in rids:
                op(s, rid)
        req.session.run((kind, req.spec), record)

    # -------------------------------------------------------- decode loop

    def _round_order(self, active: list[Request]) -> list[Request]:
        """One-token-per-request round order.  ``svm_aware`` groups
        same-architecture requests back to back so consecutive replays
        hit the same shared compiled segment; the others round-robin in
        admission order."""
        if self.policy == "svm_aware":
            return sorted(active, key=lambda r: (r.spec.arch, r.admit_seq))
        return sorted(active, key=lambda r: r.admit_seq)

    def _replay_attributed(self, req: Request, fn) -> None:
        """Run one session replay and attribute the manager's counter
        deltas (wall, migrations, evictions, bytes) to ``req`` — the
        per-request rows sum exactly to the shared manager's totals.
        Attribution lands in ``finally``: a replay that raises mid-way
        (an injected `MigrationError`) still charges whatever work the
        manager did before the fault, so conservation holds across
        failed attempts too."""
        m = self.mgr
        w0, mig0, ev0 = m.wall, m.n_migrations, m.n_evictions
        bm0, be0 = m.bytes_migrated, m.bytes_evicted
        try:
            fn()
        finally:
            req.svm_wall_s += m.wall - w0
            req.migrations += m.n_migrations - mig0
            req.evictions += m.n_evictions - ev0
            req.bytes_migrated += m.bytes_migrated - bm0
            req.bytes_evicted += m.bytes_evicted - be0
            self.now += m.wall - w0

    def _record_token(self, session: TraceSession, spec: ModelSpec,
                      plan: ParamRanges) -> None:
        """Record one decode token's layer-fetch ops into ``session``."""
        rate, conc = self.compute_rate, self.concurrency
        for paths, fl in zip(spec.layer_paths, spec.flops_per_layer):
            for p in paths:
                for rid in plan.leaf_ranges[p]:
                    session.touch(rid, concurrency=conc)
            session.compute(fl / rate)

    def _decode_token(self, req: Request) -> None:
        key = ("tok", req.spec)

        def rec(s, spec=req.spec, plan=req.plan):
            self._record_token(s, spec, plan)

        if self._pending_fail_attempts or self.cost_scale != 1.0:
            # active hazard: route through the golden scalar path with
            # bounded retry (may raise RetryError — the caller drops the
            # request; no token is counted then)
            self._chaos_token(req, key, rec)
        else:
            self._replay_attributed(req, lambda: req.session.run(key, rec))
        req.tokens_done += 1
        self._tokens_total += 1
        if req.tokens_done == 1:
            req.first_token_s = self.now

    # ------------------------------------------------------- chaos layer

    def _chaos_token(self, req: Request, key, rec) -> None:
        """Decode one token under active hazards.

        Armed migration faults must surface at the exact faulting op with
        the manager untouched past it — only op-for-op scalar dispatch
        guarantees that unconditionally (the vectorized tiers batch
        migrations), so the hazard token replays via
        `TraceSession.replay_scalar` (byte-identical when nothing
        raises).  Recovery is the shared bounded retry
        (`repro_torch.ft.retry`): one armed fault per attempt for the event's
        first ``fail_attempts`` attempts, deterministic exponential
        backoff charged to the simulated clock via
        `SVMManager.inject_latency`.  A slow-page window charges its
        multiplicative migration-cost surcharge from the token's
        measured cost delta.  Everything — failed attempts included —
        runs inside one attribution window, so conservation holds."""
        session = req.session
        ct = session.fetch(key, rec)
        fail_attempts = self._pending_fail_attempts
        self._pending_fail_attempts = 0
        m = self.mgr
        mf0 = m.migration_faults

        def on_backoff(attempt: int, delay_s: float) -> None:
            req.retries += 1
            req.backoff_s += delay_s
            self._chaos["retries"] += 1
            self._chaos["backoff_wall_s"] += delay_s
            m.inject_latency(delay_s)

        def attempt_token(attempt: int) -> None:
            m.arm_migration_faults(1 if attempt <= fail_attempts else 0)
            try:
                c0 = m.cost.total()
                session.replay_scalar(ct)
                if self.cost_scale != 1.0:
                    m.inject_latency((self.cost_scale - 1.0)
                                     * (m.cost.total() - c0))
            finally:
                # never leak an armed fault into later vectorized replays
                m.arm_migration_faults(0)

        self._replay_attributed(
            req, lambda: retry_call(attempt_token,
                                    policy=self.retry_policy,
                                    retry_on=(MigrationError,),
                                    on_backoff=on_backoff))
        if fail_attempts:
            if m.migration_faults > mf0:
                req.faults += 1
                self._chaos["migration_faults"] += 1
            else:
                # the token ran fully resident — nothing migrated, so
                # there was no migration to fail; the armed hazard
                # carries to the next decoded token
                self._pending_fail_attempts = fail_attempts

    def _chaos_step(self, req: Request, queued: "deque[Request]",
                    active: list[Request]) -> bool:
        """Pump the injector at the current token counter: apply every
        due environment event, then at most one token-targeted event
        aimed at ``req`` (the next decoder).  Returns True when the
        event consumed the request's turn (a crash — no token
        decodes)."""
        for ev in self.injector.due_env(self._tokens_total):
            if ev.kind in ("capacity_loss", "capacity_restore"):
                self._apply_capacity_event(ev, req, active)
            elif ev.kind == "slow_page":
                self.cost_scale = float(ev.frac)
                self._chaos["slow_page_windows"] += 1
                self.incidents.append(
                    f"tok={self._tokens_total} slow_page window opens "
                    f"(migration cost x{ev.frac:g})")
            else:  # slow_page_end
                self.cost_scale = 1.0
        ev = self.injector.pop_token_event(self._tokens_total)
        if ev is None:
            return False
        if ev.kind == "migration_fault":
            # arm the next decode; _chaos_token recovers via bounded retry
            self._pending_fail_attempts = max(1, int(ev.fail_attempts))
            return False
        # crash: the request dies mid-decode — drain its ranges eagerly
        # and re-queue it to resume from its TraceSession carried state
        req.crashes += 1
        self._chaos["crashes"] += 1
        self.incidents.append(
            f"tok={self._tokens_total} crash req={req.req_id} at "
            f"tokens_done={req.tokens_done} — drained, re-queued")
        self._evacuate(req, active, queued, requeue=True)
        return True

    def _apply_capacity_event(self, ev, req: Request,
                              active: list[Request]) -> None:
        """Transient co-tenancy via the public `resize_capacity` hook.
        The shrink target is clamped above pinned bytes plus the largest
        active leaf — a pool smaller than that deadlocks the next
        migration — and the emergency-eviction work is attributed to the
        next decoder so conservation stays exact."""
        self._chaos["capacity_events"] += 1
        target = max(int(self.capacity * ev.frac), 1)
        floor_b = self.pinned_bytes_total
        if active:
            floor_b += max(max(n for _, n in r.spec.leaves)
                           for r in active)
        target = max(target, floor_b, 1)
        self._replay_attributed(
            req, lambda: self.mgr.resize_capacity(target))
        self.incidents.append(
            f"tok={self._tokens_total} {ev.kind}: pool -> {target} bytes "
            f"({target / self.capacity:.0%} of nominal)")

    def _evacuate(self, req: Request, active: list[Request],
                  queued: "deque[Request]", *, requeue: bool) -> None:
        """Eagerly drain a request out of the pool: unpin its pins,
        write back every resident range of its plan (counted as
        evictions, like any algorithmic device→host transfer), and
        either re-queue it behind a deterministic backoff gate or drop
        it to the failed list.  Plan, session, and compiled segments are
        carried, so a re-admission resumes byte-identically at the next
        un-decoded token."""
        def drain(session=req.session, plan=req.plan,
                  pinned=req.pinned_rids):
            for rid in pinned:
                session.unpin(rid)
            for rids in plan.leaf_ranges.values():
                for rid in rids:
                    session.writeback(rid)
            session.flush()
        self._replay_attributed(req, drain)
        if req.pinned_rids:
            self.pinned_bytes_total -= req.pinned_bytes
            req.pinned_rids = ()
            req.pinned_bytes = 0
        self.admitted_bytes -= self._admit_cost(req.spec)
        active.remove(req)
        if requeue:
            attempt = max(1, req.crashes + req.preemptions)
            req.not_before_s = self.now + self.retry_policy.delay(attempt)
            queued.append(req)
        else:
            req.failed = True
            req.finish_s = self.now
            self.failed.append(req)

    def _thrash_check(self, active: list[Request],
                      queued: "deque[Request]") -> None:
        """Thrash detector (opt-in via ``thrash_watermark``): a sliding
        window of (token counter, manager eviction counter) snapshots.
        When evictions-per-token over the window crosses the watermark,
        degrade: preempt the largest active tenant (eager drain,
        re-queue with backoff, resume from carried session state) and
        tighten admission — the paper's thrashing signature turned into
        a runtime control loop."""
        if self.thrash_watermark is None:
            return
        self._thrash_hist.append((self._tokens_total,
                                  self.mgr.n_evictions))
        cutoff = self._tokens_total - self.thrash_window
        while len(self._thrash_hist) > 1 and \
                self._thrash_hist[0][0] < cutoff:
            self._thrash_hist.popleft()
        t0, e0 = self._thrash_hist[0]
        dt = self._tokens_total - t0
        if dt < self.thrash_window:
            return
        rate = (self.mgr.n_evictions - e0) / dt
        if rate <= self.thrash_watermark:
            return
        if len(active) <= 1 or self._tokens_total < self._thrash_cooldown:
            return
        victim = max(active, key=lambda r: (r.spec.total_bytes,
                                            -r.admit_seq))
        victim.preemptions += 1
        self._chaos["preemptions"] += 1
        self._chaos["thrash_trips"] += 1
        self.admit_watermark = max(0.3, self.admit_watermark * 0.85)
        self.incidents.append(
            f"tok={self._tokens_total} thrash-guard trip "
            f"(ev/token={rate:.2f} > {self.thrash_watermark:g}): preempt "
            f"req={victim.req_id}, "
            f"admit_watermark->{self.admit_watermark:.2f}")
        self._evacuate(victim, active, queued, requeue=True)
        self._thrash_cooldown = self._tokens_total + self.thrash_window
        self._thrash_hist.clear()

    def _chaos_round_pending(self, order: list[Request]) -> bool:
        """True when a hazard is live or due within this round — the
        fused tier degrades the whole round to the golden per-token path
        (chaos events key off the per-token counter, which a fused block
        only advances in bulk)."""
        if self.cost_scale != 1.0 or self._pending_fail_attempts:
            return True
        if self.injector is None:
            return False
        return self.injector.next_at() <= self._tokens_total + len(order)

    # ---------------------------------------------------- fused round tier

    def _fetch_segments(self, block: list[Request]) -> list:
        """Resolve every block member's next-token compiled segment
        without replaying: per-session LRU hits first, then **one**
        shared-cache probe per distinct key (`SegmentCache.batch_relocate`
        rebased to every member's rid base at once), recording only on
        the first-ever encounter of a key.  Session/shared counter totals
        match the sequential per-token `TraceSession.fetch` chain."""
        segs: list = [None] * len(block)
        groups: "OrderedDict[object, list]" = OrderedDict()
        for k, req in enumerate(block):
            key = ("tok", req.spec)
            ct = req.session.get(key)
            if ct is not None:
                req.session.cache_hits += 1
                segs[k] = ct
            else:
                groups.setdefault(key, []).append((k, req))
        for key, members in groups.items():
            cts = self.shared_cache.batch_relocate(
                key, [req.plan.rid_base for _, req in members])
            if cts is None:
                # first encounter: the head records + publishes, the rest
                # re-probe as shared hits (same counters as sequentially)
                k0, r0 = members[0]
                sess = r0.session
                sess.cache_misses += 1
                self._record_token(sess, r0.spec, r0.plan)
                ct0 = sess.seal(key)
                self.shared_cache.put(key, r0.plan.rid_base, ct0)
                segs[k0] = ct0
                members = members[1:]
                if not members:
                    continue
                cts = self.shared_cache.batch_relocate(
                    key, [req.plan.rid_base for _, req in members])
            for (k, req), ct in zip(members, cts):
                req.session.shared_hits += 1
                req.session._cache_put(key, ct)
                segs[k] = ct
        return segs

    def _concat_round(self, segs: list) -> "Any":
        """Memoised `SegmentCache.concat` over the block's segment tuple.
        Keyed by object identity; the memo holds strong references, so a
        key can never alias a freed segment."""
        key = tuple(id(ct) for ct in segs)
        ent = self._concat_memo.get(key)
        if ent is not None:
            self._concat_memo.move_to_end(key)
            return ent[1]
        mega = self.shared_cache.concat(segs)
        self._concat_memo[key] = (tuple(segs), mega)
        while len(self._concat_memo) > self._concat_memo_size:
            self._concat_memo.popitem(last=False)
            self._concat_evictions += 1
        return mega

    def _run_round_fused(self, order: list[Request], waiting,
                         queued: "deque[Request]", active: list[Request],
                         done: list[Request], ingest) -> None:
        """One scheduler round as fused blocks.

        A block is a maximal run of ``order`` whose segments may replay
        back-to-back with **no interleaved manager mutation**: it ends at
        a finishing request (its retirement unpins ranges and admits
        queued tenants — both mutate policy state for later segments) and,
        under ``svm_aware`` with arrivals still pending, every block is
        unit-sized (a mid-round admission pins at a wall-dependent
        position).  fifo/admission mid-round admissions never touch the
        manager, so they replay their bookkeeping inside the attribution
        loop at the exact per-token clock."""
        i, n = 0, len(order)
        while i < n:
            req = order[i]
            if req.tokens_done >= req.n_tokens:
                # zero-token (or raced-complete) request: retire without
                # a decode — and, as in the per-token loop, without the
                # post-token ingest/admit step
                self._retire(req, active, done)
                i += 1
                continue
            block: list[Request] = []
            j = i
            while j < n:
                r = order[j]
                if r.tokens_done >= r.n_tokens:
                    break
                block.append(r)
                j += 1
                if r.tokens_done + 1 >= r.n_tokens:
                    break              # finisher: retire/admit next
                if self.policy == "svm_aware" and waiting:
                    break              # pending arrivals may pin mid-round
            self._run_block_fused(block, queued, active, done, ingest)
            i = j

    # ------------------------------------------- vectorized window tier

    def _window_rounds(self, order: list[Request], waiting,
                       queued: "deque[Request]") -> int:
        """How many *whole rounds* beyond this one can fuse into a single
        multi-round window pass — the count ``r`` such that rounds
        1..r are provably identical replays of the same segment tuple
        with every between-token bookkeeping step a no-op:

          * no pending arrival can ingest mid-window (``waiting`` empty),
          * the admission queue cannot move: empty, or (non-fifo) its
            head fails the working-set watermark check — admitted bytes
            and pool capacity are both constant inside a window, so the
            check's outcome is constant too (fifo admits on the backoff
            gate alone, which expiring mid-window would flip),
          * the thrash guard is off (it samples eviction counters at
            every round boundary and may preempt),
          * no member finishes inside the window (a retirement unpins
            and re-admits — the finisher round runs on the block tier),
          * no chaos event falls due inside the window (the injector
            keys off the token counter; the window decodes
            ``r × len(order)`` tokens).

        Returns 0 when no multi-round window applies (callers then run
        the normal one-round block tier)."""
        if waiting or self.thrash_watermark is not None:
            return 0
        if queued and (self.policy == "fifo"
                       or self._fits(queued[0].spec)):
            return 0
        r = min(q.n_tokens - q.tokens_done for q in order) - 1
        if r < 2:
            return 0
        if self.injector is not None:
            nxt = self.injector.next_at()
            if math.isfinite(nxt):
                # every round i in the window must satisfy the per-round
                # fused gate: next_at > tokens_total + (i+1)*K
                r = min(r, int(nxt - self._tokens_total - 1)
                        // len(order))
        return r if r >= 2 else 0

    def _run_window_fused(self, order: list[Request], r: int,
                          queued: "deque[Request]", active: list[Request],
                          done: list[Request], ingest) -> None:
        """Replay ``r`` identical scheduler rounds in **one**
        `execute_fused` pass over the round mega-trace tiled ``r`` times,
        with all per-request bookkeeping done as NumPy column operations
        over the (round × request) cut table.

        Byte-identity with the per-token oracle: the tiled trace executes
        bit-identically to ``r`` back-to-back mega replays (the engine's
        resumability contract), the wall/`now` trajectories are exact
        seeded ``np.cumsum`` folds in the oracle's add order (column-wise
        per request, flat for the shared clock), and the integer counters
        attribute through exact cut-row differences.  Session counters
        bump by the closed forms of what the per-round loop would do:
        round 1's fetch runs for real, rounds 2..r are per-session LRU
        hits."""
        segs = self._fetch_segments(order)
        if len(segs) == 1:
            mega = segs[0]
            cuts1 = np.array([len(mega)], dtype=np.int64)
        else:
            mega = self._concat_round(segs)
            cuts1 = mega.seg_bounds[1:]
        if self._fused_diverged(segs, mega, cuts1):
            # same degradation as the block tier's round 1: golden
            # per-token fallback, then let the outer loop re-evaluate
            self._fused_fallback(order, len(segs), queued, active, done,
                                 ingest)
            return
        K = len(order)
        window = mega.tile(r)
        cuts = window.seg_bounds[1:]
        m = self.mgr
        prev_w = m.wall
        prev_c = np.array([m.n_migrations, m.n_evictions,
                           m.bytes_migrated, m.bytes_evicted],
                          dtype=np.int64)
        snaps = execute_fused(window, m, cuts)
        live = np.array([m.wall, float(m.n_migrations),
                         float(m.n_evictions), float(m.bytes_migrated),
                         float(m.bytes_evicted)])
        if not np.array_equal(snaps[-1], live):
            # post-hoc reconciliation guard, as in the block tier
            self.incidents.append(
                f"tok={self._tokens_total} fused reconciliation: final "
                f"cut row != live counters — residual charged to "
                f"req={order[-1].req_id}")
            snaps = snaps.copy()
            snaps[-1] = live
        # request-table attribution: column k of the (r, K) delta matrix
        # is request k's per-round charge stream
        walls = snaps[:, 0]
        dws = np.diff(walls, prepend=prev_w)
        now_traj = np.cumsum(np.concatenate(([self.now], dws)))
        seeds = np.array([q.svm_wall_s for q in order])
        wall_fin = np.cumsum(
            np.vstack((seeds, dws.reshape(r, K))), axis=0)[-1]
        cdiff = np.diff(snaps[:, 1:].astype(np.int64), axis=0,
                        prepend=prev_c[None, :])
        csum = cdiff.reshape(r, K, 4).sum(axis=0)
        first_tok = now_traj[1:K + 1]
        for k, req in enumerate(order):
            req.svm_wall_s = float(wall_fin[k])
            req.migrations += int(csum[k, 0])
            req.evictions += int(csum[k, 1])
            req.bytes_migrated += int(csum[k, 2])
            req.bytes_evicted += int(csum[k, 3])
            sess = req.session
            sess.cache_hits += r - 1
            sess.segments_replayed += r
            sess.ops_replayed += r * len(segs[k])
            if req.tokens_done == 0:
                req.first_token_s = float(first_tok[k])
            req.tokens_done += r
        self._tokens_total += r * K
        self.now = float(now_traj[-1])

    def _fused_fallback(self, block: list[Request], n_segs: int,
                        queued: "deque[Request]", active: list[Request],
                        done: list[Request], ingest) -> None:
        """Golden per-token replay of one diverged fused block, with the
        incident logged."""
        self._chaos["fused_fallbacks"] += 1
        self.incidents.append(
            f"tok={self._tokens_total} fused divergence: cut prefix "
            f"sums != segment totals ({n_segs}-segment block) — "
            f"per-token fallback")
        for req in block:
            self._decode_token(req)
            if req.tokens_done >= req.n_tokens:
                self._retire(req, active, done)
            ingest()
            self._admit(queued, active)

    @staticmethod
    def _fused_diverged(segs: list, mega, cuts) -> bool:
        """Structural cross-check before a fused pass: the cut prefix
        sums must reproduce the member segment op totals exactly and the
        last cut must cover the whole mega-trace."""
        if len(cuts) != len(segs):
            return True
        if len(segs) == 1:
            return int(cuts[0]) != len(segs[0]) or len(mega) != len(segs[0])
        bounds = np.concatenate(
            [np.zeros(1, dtype=np.int64), np.asarray(cuts, np.int64)])
        expected = np.asarray([len(s) for s in segs], dtype=np.int64)
        return (int(bounds[-1]) != len(mega)
                or not np.array_equal(np.diff(bounds), expected))

    def _run_block_fused(self, block: list[Request],
                         queued: "deque[Request]", active: list[Request],
                         done: list[Request], ingest) -> None:
        """Replay one block's concatenated segments in a single
        `execute_fused` pass and attribute the per-request counter deltas
        from the sampled cut rows — the same floats/ints the per-token
        loop reads from the manager between replays."""
        segs = self._fetch_segments(block)
        if len(segs) == 1:
            mega = segs[0]
            cuts = np.array([len(mega)], dtype=np.int64)
        else:
            mega = self._concat_round(segs)
            cuts = mega.seg_bounds[1:]
        if self._fused_diverged(segs, mega, cuts):
            # fused-divergence guard: the concatenated round's cut
            # prefix sums disagree with the member segment totals.
            # Nothing has executed yet, so fall back to the golden
            # per-token path for this block — no double charge.
            self._fused_fallback(block, len(segs), queued, active, done,
                                 ingest)
            return
        m = self.mgr
        prev_w = m.wall
        prev_c = [m.n_migrations, m.n_evictions,
                  m.bytes_migrated, m.bytes_evicted]
        snaps = execute_fused(mega, m, cuts)
        live = np.array([m.wall, float(m.n_migrations),
                         float(m.n_evictions), float(m.bytes_migrated),
                         float(m.bytes_evicted)])
        if not np.array_equal(snaps[-1], live):
            # fused-divergence guard, post-hoc half: the final sampled
            # cut must equal the live counters; fold any residual into
            # the last member's row so conservation stays exact
            self.incidents.append(
                f"tok={self._tokens_total} fused reconciliation: final "
                f"cut row != live counters — residual charged to "
                f"req={block[-1].req_id}")
            snaps = snaps.copy()
            snaps[-1] = live
        if len(block) == 1:
            # unit block (finisher/admission rounds): scalar attribution
            # without the array round-trips
            walls = [float(snaps[0, 0])]
            counts = [[int(snaps[0, 1]), int(snaps[0, 2]),
                       int(snaps[0, 3]), int(snaps[0, 4])]]
        else:
            walls = snaps[:, 0].tolist()
            counts = snaps[:, 1:].astype(np.int64).tolist()
        for k, req in enumerate(block):
            w, c = walls[k], counts[k]
            dw = w - prev_w
            req.svm_wall_s += dw
            req.migrations += c[0] - prev_c[0]
            req.evictions += c[1] - prev_c[1]
            req.bytes_migrated += c[2] - prev_c[2]
            req.bytes_evicted += c[3] - prev_c[3]
            self.now += dw
            prev_w, prev_c = w, c
            sess = req.session
            sess.segments_replayed += 1
            sess.ops_replayed += len(segs[k])
            req.tokens_done += 1
            self._tokens_total += 1
            if req.tokens_done == 1:
                req.first_token_s = self.now
            if req.tokens_done >= req.n_tokens:
                self._retire(req, active, done)
            ingest()
            self._admit(queued, active)

    def _retire(self, req: Request, active: list[Request],
                done: list[Request]) -> None:
        if req.pinned_rids:
            # release app-directed placement; the ranges rejoin the
            # eviction policy and age out under other tenants' pressure
            self._replay_attributed(
                req, lambda: self._run_pin_segment(req, "unpin",
                                                   req.pinned_rids))
            self.pinned_bytes_total -= req.pinned_bytes
        req.finish_s = self.now
        self.admitted_bytes -= self._admit_cost(req.spec)
        active.remove(req)
        done.append(req)

    def _run_round_tokenwise(self, order: list[Request],
                             queued: "deque[Request]",
                             active: list[Request], done: list[Request],
                             ingest) -> None:
        """One scheduler round on the golden per-token path — the
        non-fused tier, and the fused tier's degradation target whenever
        a chaos hazard is live or due this round."""
        for req in order:
            if req not in active:
                continue   # crashed/preempted out earlier this round
            if req.tokens_done >= req.n_tokens:
                # zero-token (or raced-complete) request: retire it
                # here, not via a decode, or the loop never drains
                self._retire(req, active, done)
                continue
            if self.injector is not None and \
                    self._chaos_step(req, queued, active):
                # a crash consumed this request's turn — no token
                ingest()
                self._admit(queued, active)
                continue
            try:
                self._decode_token(req)
            except RetryError as e:
                # retry budget exhausted: the request is dropped, its
                # charged work stays on its row (conservation)
                self._chaos["retry_exhausted"] += 1
                self.incidents.append(
                    f"tok={self._tokens_total} req={req.req_id} retry "
                    f"budget exhausted after {e.attempts} attempts — "
                    f"request dropped")
                self._evacuate(req, active, queued, requeue=False)
            else:
                if req.tokens_done >= req.n_tokens:
                    self._retire(req, active, done)
            # arrivals during this token can be admitted mid-round;
            # they join the next round's order
            ingest()
            self._admit(queued, active)

    # --------------------------------------------------------------- run

    def _idle_advance(self, waiting: "deque[Request]",
                      queued: "deque[Request]") -> None:
        """Pool idle: fast-forward to the next arrival or the queue
        head's re-admission backoff gate, whichever is sooner.  (The
        gate matters: with every arrival drained and the head waiting
        out a crash/preemption backoff, the old arrival-only
        fast-forward had nothing to index.)"""
        nxt = math.inf
        if waiting:
            nxt = min(nxt, waiting[0].arrival_s)
        if queued:
            nxt = min(nxt, queued[0].not_before_s)
        if math.isfinite(nxt):
            self.now = max(self.now, nxt)

    def run(self, requests: Sequence[Request]) -> dict:
        """Drive every request to completion; returns the report dict."""
        waiting = deque(sorted(requests,
                               key=lambda r: (r.arrival_s, r.req_id)))
        queued: "deque[Request]" = deque()
        active: list[Request] = []
        done: list[Request] = []
        eps = 1e-12

        def ingest() -> None:
            while waiting and waiting[0].arrival_s <= self.now + eps:
                queued.append(waiting.popleft())

        while waiting or queued or active:
            ingest()
            self._admit(queued, active)
            if not active:
                self._idle_advance(waiting, queued)
                continue
            self._thrash_check(active, queued)
            if not active:   # pragma: no cover — guard preempts ≤ N-1
                continue
            order = self._round_order(active)
            if self.fused and not self._chaos_round_pending(order):
                r = self._window_rounds(order, waiting, queued)
                if r:
                    self._run_window_fused(order, r, queued, active,
                                           done, ingest)
                else:
                    self._run_round_fused(order, waiting, queued, active,
                                          done, ingest)
                continue
            if self.fused:
                # hazard live/due: degrade this round to per-token
                self._chaos["degraded_rounds"] += 1
            self._run_round_tokenwise(order, queued, active, done,
                                      ingest)
        return self._result(done)

    # ------------------------------------------------------------ report

    def _result(self, done: list[Request]) -> dict:
        done = sorted(done, key=lambda r: r.req_id)
        failed = sorted(self.failed, key=lambda r: r.req_id)
        # conservation spans everything that consumed pool work —
        # dropped requests keep their charged rows
        accounted = done + failed
        decoded = [r for r in done if r.tokens_done > 0]
        lat = np.array([r.latency_s for r in done])
        ttft = np.array([r.first_token_s - r.arrival_s for r in decoded])
        waits = np.array([r.queue_wait_s for r in done])

        def pct(arr: np.ndarray, q: float) -> float:
            return float(np.percentile(arr, q)) if len(arr) else 0.0
        total_tokens = sum(r.tokens_done for r in done)
        offered = sum(r.spec.total_bytes for r in done)
        m = self.mgr
        seg_local_hits = sum(s.cache_hits for s in self._sessions)
        seg_shared_hits = sum(s.shared_hits for s in self._sessions)
        seg_misses = sum(s.cache_misses for s in self._sessions)
        lookups = seg_local_hits + seg_shared_hits + seg_misses
        chaos = dict(self._chaos)
        chaos["admit_watermark_final"] = self.admit_watermark
        if self.injector is not None:
            chaos["injector"] = self.injector.stats()
        return {
            "policy": self.policy,
            "admit_by": self.admit_by,
            "fused": self.fused,
            "capacity_bytes": self.capacity,
            "n_requests": len(done),
            "peak_active_requests": self.peak_active_requests,
            "profile_cache": self._profile_cache.stats(),
            "total_tokens": total_tokens,
            "makespan_s": self.now,
            "agg_tok_s": total_tokens / self.now if self.now else 0.0,
            "latency_p50_s": pct(lat, 50),
            "latency_p90_s": pct(lat, 90),
            "latency_p99_s": pct(lat, 99),
            "ttft_p50_s": pct(ttft, 50),
            "ttft_p99_s": pct(ttft, 99),
            "queue_wait_mean_s": float(waits.mean()) if len(waits) else 0.0,
            "dos_offered": offered / self.capacity * 100.0,
            "dos_peak": self.peak_admitted_bytes / self.capacity * 100.0,
            "migrations": m.n_migrations,
            "evictions": m.n_evictions,
            "evict_to_mig": m.evict_to_mig_ratio,
            "evictions_per_token": (m.n_evictions / total_tokens
                                    if total_tokens else 0.0),
            "segment_hit_rate": ((seg_local_hits + seg_shared_hits)
                                 / lookups if lookups else 0.0),
            "segment_local_hits": seg_local_hits,
            "segment_shared_hits": seg_shared_hits,
            "segment_misses": seg_misses,
            "shared_cache": {**self.shared_cache.stats(),
                             "concat_memo_entries": len(self._concat_memo),
                             "concat_memo_evictions":
                                 self._concat_evictions},
            "requests": [r.row() for r in done],
            "n_failed": len(failed),
            "failed_requests": [r.row() for r in failed],
            "incidents": list(self.incidents),
            "chaos": chaos,
            "conservation": {
                "svm_wall_s": sum(r.svm_wall_s for r in accounted),
                "migrations": sum(r.migrations for r in accounted),
                "evictions": sum(r.evictions for r in accounted),
                "bytes_migrated": sum(r.bytes_migrated
                                      for r in accounted),
                "bytes_evicted": sum(r.bytes_evicted for r in accounted),
            },
            "mgr": m.summary(),
        }


def run_schedule(specs: Sequence[ModelSpec], n_requests: int,
                 capacity_bytes: int, *, policy: str = "svm_aware",
                 seed: int = 0, mean_interarrival_s: float = 0.0,
                 arrival: str = "poisson", tokens: int = 32,
                 token_jitter: int = 0, spec_choice: str = "random",
                 **scheduler_kw) -> dict:
    """Build a seeded request mix and run it through a fresh
    `PoolScheduler` — the one-call entry point for benchmarks, figures,
    and the serving CLI."""
    reqs = make_requests(specs, n_requests, seed=seed,
                         mean_interarrival_s=mean_interarrival_s,
                         arrival=arrival, tokens=tokens,
                         token_jitter=token_jitter,
                         spec_choice=spec_choice)
    sched = PoolScheduler(capacity_bytes, policy=policy, **scheduler_kw)
    return sched.run(reqs)

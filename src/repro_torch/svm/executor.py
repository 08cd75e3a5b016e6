"""Streaming executor: serve a model whose weights exceed the device budget
— the port of ``repro.svm.executor``, written anew for torch.

Weights live host-side as CPU tensors, pinned when the executor's device is
CUDA; a fixed-size device pool holds the resident leaves as real device
tensors, copied from the host leaves with ``.to(device, non_blocking=True)``.
Each layer's weight fetch drives the SVMManager (faults -> range
migrations -> LRF/Clock/LRU evictions, with the paper's cost model supplying
the simulated clock), while the math itself runs for real, so correctness
and policy behaviour are validated together.

Streaming modes map the paper's findings onto serving:
  * naive        — demand-fetch in layer order; under oversubscription LRF
                   evicts the *earliest-fetched* layers, which are exactly
                   the ones the next token needs first: the decode loop is
                   Jacobi2d's cyclic-traversal pathology (Category II/III).
  * svm_aware    — pin the hottest leaves (embeddings + head: touched twice
                   per token) and prefetch the next layer overlapped with
                   compute (paper §4.1 pinning + §4.2 parallel eviction).
  * zero_copy    — leave designated cold leaves host-resident at remote-
                   access cost (paper §4.2).

The executor never drives the manager's `touch`/`advance`/`pin` methods
directly: every access is **recorded** into a `repro_torch.core.engine.
TraceSession`, compiled into op-column segments, and **replayed** on the
batched engine (`scalar=True` replays the same segments op-for-op — the
imperative reference path, byte-identical by the engine's equivalence
guarantee).  `decode_step` is the serving hot path: the whole token's
layer-fetch trace seals into cached segments on the first token and
replays as compiled columns every later token.

Leaves are keyed by `repro_torch.bridge.leaves` paths, in JAX's
flattening order (sorted dict keys), never ``named_parameters`` order:
the trace follows leaf order, so the same tree gives the reference's
trace and metrics with ``==``.

Device-pool invalidation is push-based: the executor registers an eviction
listener on the `SVMManager`, and evicted rids map back to their leaf via
the plan's rid→leaf reverse index.  Hidden prefetch overlap is tracked in
a separate ``overlap_hidden_s`` ledger (subtracted in `metrics()`), never
by rewinding the manager's wall clock.
"""

from __future__ import annotations

from collections import OrderedDict, deque
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.bridge import leaves, tree_map
from repro_torch.core.costmodel import H100_HOST, H100_SERVE_FLOPS, CostParams
from repro_torch.core.engine import CompiledTrace, TraceSession
from repro_torch.device import resolve_device
from repro_torch.svm.hotset import HotSetProfile, token_trace
from repro_torch.svm.planner import ParamRanges, plan_param_ranges

#: streaming prefetch policies (docs/prefetching.md):
#:   none       — pure demand paging
#:   aggressive — stage every next layer (the paper's default; thrashes
#:                under oversubscription)
#:   measured   — profile the first token's touch columns and pin only
#:                leaves above the touch-frequency threshold
PREFETCH_MODES = ("none", "aggressive", "measured")


def host_leaf(x: torch.Tensor, pin: bool) -> torch.Tensor:
    """``x`` as a contiguous CPU tensor, page-locked when ``pin``: ``x``
    itself when it already is one, else a copy."""
    x = x.detach()
    if x.device.type == "cpu" and x.is_contiguous() and \
            (not pin or x.is_pinned()):
        return x
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=pin)
    out.copy_(x)
    return out


class StreamingExecutor:
    """Serve a model whose weights exceed the device budget by streaming
    parameter leaves through a managed device pool (see module
    docstring): real tensors + simulated SVM placement, every access
    recorded and replayed as compiled session segments."""

    def __init__(self, params: dict, hbm_budget: int, *,
                 policy: str = "lrf",
                 cost_params: CostParams = H100_HOST,
                 parallel_evict: bool = False,
                 prefetch: bool = False,
                 prefetch_mode: str | None = None,
                 hot_threshold: float = 2.0,
                 hot_frac: float = 0.5,
                 pin: tuple[str, ...] = (),
                 zero_copy: tuple[str, ...] = (),
                 concurrency: int = 64,
                 compute_rate: float | None = None,
                 profile: bool = True,
                 scalar: bool = False,
                 plan: ParamRanges | None = None,
                 manager: Any | None = None,
                 shared_cache: Any | None = None,
                 device: str | torch.device | None = None):
        # the pool's device: CUDA unless the caller asks for the CPU; the
        # host leaves are page-locked for CUDA (so the pool's copies run
        # asynchronously) and plain CPU tensors on the CPU
        self.device = resolve_device(device)
        pin_host = self.device.type == "cuda"
        self.host_params = tree_map(lambda x: host_leaf(x, pin_host), params)
        # shared-pool mode: an externally planned `plan` (offset into a
        # shared AddressSpace) plus the pool's shared `manager` lets this
        # executor co-tenant one device pool with other executors;
        # `shared_cache` (a core SegmentCache) then shares compiled
        # segments between congruent tenants
        self.plan = plan if plan is not None \
            else plan_param_ranges(params, hbm_budget)
        # profile=False for long-lived serving loops: per-event
        # Event/DensitySample records grow without bound, one per
        # migration/eviction per token
        self.mgr = manager if manager is not None \
            else self.plan.manager(policy=policy, params=cost_params,
                                   parallel_evict=parallel_evict,
                                   profile=profile)
        # serving compute rate: the card's measured decode rate unless
        # overridden
        self.compute_rate = (compute_rate if compute_rate is not None
                             else H100_SERVE_FLOPS)
        # prefetch policy: the bool flag keeps its historical meaning
        # (True == "aggressive"); `prefetch_mode` supersedes it when set
        if prefetch_mode is None:
            prefetch_mode = "aggressive" if prefetch else "none"
        if prefetch_mode not in PREFETCH_MODES:
            raise ValueError(f"unknown prefetch_mode {prefetch_mode!r}; "
                             f"available: {PREFETCH_MODES}")
        self.prefetch_mode = prefetch_mode
        self.prefetch = prefetch_mode == "aggressive"
        # measured mode: hot = touched >= hot_threshold times per token,
        # pinned bytes bounded to hot_frac of the pool (deadlock guard)
        self.hot_threshold = float(hot_threshold)
        self.hot_frac = float(hot_frac)
        self.hot_profile: HotSetProfile | None = None
        self.measured_hot_leaves: tuple[str, ...] = ()
        self.measured_hot_bytes = 0
        self._measured_done = prefetch_mode != "measured"
        self.concurrency = concurrency
        # every manager access goes through the session: record -> compile
        # segments -> replay (batched engine, or op-for-op when scalar).
        # LRU sized to hold several whole decode steps: prefetch mode keys
        # ~2 segments per leaf per token
        self.session = TraceSession(
            self.mgr, scalar=scalar,
            cache_size=max(64, 4 * len(self.plan.leaf_ranges)),
            shared_cache=shared_cache, rid_base=self.plan.rid_base)
        # shared-cache key namespace: segment relocation is only sound
        # between congruent tenants, so keys carry a fingerprint of the
        # plan geometry + touch concurrency
        self._seg_ns = (hash((self.plan.geometry(), concurrency))
                        if shared_cache is not None else None)
        # the device pool: leaf path -> tensor on self.device
        self._device: dict[str, torch.Tensor] = {}
        self._flat: dict[str, torch.Tensor] = dict(leaves(self.host_params))
        self._zc_leaves: set[str] = set()
        for pat in zero_copy:
            for path, rids in self.plan.leaf_ranges.items():
                if pat in path:
                    aid = self.plan.space.ranges[rids[0]].alloc_id
                    self.mgr.set_zero_copy(aid)
                    self._zc_leaves.add(path)
        # compute-time ledger (simulated clock shares the SVM manager wall)
        self.compute_flops = 0.0
        # prefetch hidden behind compute: separate ledger, never a wall
        # rewind (keeps Event.t monotonic)
        self.overlap_hidden_s = 0.0
        # push-based pool invalidation (O(1) per eviction, not per fetch)
        self._pending_evictions: deque[int] = deque()
        self.mgr.add_evict_listener(self._pending_evictions.append)
        # double-buffered next-layer prefetch queue
        self._prefetch_q: deque[tuple[str, float]] = deque()
        # fused multi-token replay: memoised concatenation of one step
        # segment repeated N times (`decode_steps`); identity-keyed with
        # a strong segment ref so the id stays valid while memoised
        self._steps_memo: "OrderedDict[tuple, tuple]" = OrderedDict()
        # instrumentation: units of invalidation work done by fetches
        # (range touches + evicted-leaf drops)
        self.fetch_scan_work = 0
        self._step_scan: dict = {}   # step key -> demand-fetch scan units
        # app-directed placement rides the session too (OP_PIN boundary
        # ops migrate-then-pin exactly like the scalar mgr.pin path)
        pinned = [rid for pat in pin
                  for path, rids in self.plan.leaf_ranges.items()
                  if pat in path for rid in rids]
        if pinned:
            for rid in pinned:
                self.session.pin(rid)
            self.session.flush(("setup_pin", tuple(pinned)))

    # ----------------------------------------------------------- fetching

    def _key(self, key):
        """Session segment key, namespaced when a shared cache is wired
        (see ``_seg_ns`` above)."""
        return key if self._seg_ns is None else (self._seg_ns, key)

    def _record_leaf(self, path: str) -> None:
        for rid in self.plan.leaf_ranges[path]:
            self.session.touch(rid, concurrency=self.concurrency)

    def _leaf_resident(self, path: str) -> bool:
        """Would a fetch of this leaf hit?  Zero-copy leaves always do;
        managed leaves hit iff every range is resident."""
        if path in self._zc_leaves:
            return True
        resident = self.mgr.resident
        return all(rid in resident for rid in self.plan.leaf_ranges[path])

    def _copy_in(self, path: str) -> torch.Tensor:
        """A device copy of the host leaf (asynchronous from pinned
        memory on CUDA; the leaf itself on the CPU)."""
        return self._flat[path].to(self.device, non_blocking=True)

    def fetch(self, path: str) -> torch.Tensor:
        """Touch a leaf's ranges (demand paging) and return the tensor.

        Any leaves staged in the prefetch buffer are issued first (their
        migration cost was overlappable with the *previous* layer's
        compute window), so this fetch usually hits.  The touches replay
        as a cached compiled segment (one compile per leaf per session).
        """
        if self._prefetch_q:
            self.drain_prefetch()
        resident_before = self._leaf_resident(path)
        self.session.run(self._key(("fetch", path)),
                         lambda s: self._record_leaf(path))
        self.fetch_scan_work += len(self.plan.leaf_ranges[path])
        if not resident_before or path not in self._device:
            tensor = self._device[path] = self._copy_in(path)
        else:
            tensor = self._device[path]
        # drain after caching: a leaf larger than the pool evicts its own
        # earlier ranges mid-fetch and must fall straight back out of the
        # pool (the tensor itself is still returned for this use)
        self._drain_evictions()
        return tensor

    def prefetch_leaf(self, path: str, overlap_s: float) -> None:
        """Issue next-layer migrations overlapped with current compute
        (paper §4.2 'parallel implementation'): up to `overlap_s` of the
        migration cost is hidden (ledgered, not rewound)."""
        w0 = self.mgr.wall
        self.session.run(self._key(("fetch", path)),
                         lambda s: self._record_leaf(path))
        self.overlap_hidden_s += min(self.mgr.wall - w0, overlap_s)
        self._drain_evictions()

    def queue_prefetch(self, paths: list[str], overlap_s: float) -> None:
        """Stage the next layer's leaves in the prefetch buffer (double
        buffering: at most one upcoming layer is staged at a time; the
        buffer is consumed by the next `fetch`, or an explicit
        `drain_prefetch`)."""
        self._prefetch_q.clear()
        self._prefetch_q.extend((p, overlap_s) for p in paths)

    def drain_prefetch(self) -> None:
        while self._prefetch_q:
            path, overlap_s = self._prefetch_q.popleft()
            self.prefetch_leaf(path, overlap_s)

    def _drain_evictions(self) -> None:
        """Drop device tensors for leaves whose ranges were evicted since
        the last drain — pushed by the manager, O(#evictions)."""
        pending = self._pending_evictions
        if not pending:
            return
        rid_to_leaf = self.plan.rid_to_leaf
        device = self._device
        for rid in pending:
            leaf = rid_to_leaf.get(rid)
            if leaf is not None and device.pop(leaf, None) is not None:
                self.fetch_scan_work += 1
        pending.clear()

    def charge_compute(self, flops: float) -> None:
        self.compute_flops += flops
        seconds = flops / self.compute_rate
        self.session.run(self._key(("compute", seconds)),
                         lambda s: s.compute(seconds))

    def tensor(self, path: str) -> torch.Tensor:
        """The leaf's tensor for compute: the pool's device copy when the
        pool holds it, else a fresh copy from the host leaf (values are
        identical either way — the pool is a placement model)."""
        t = self._device.get(path)
        return t if t is not None else self._copy_in(path)

    def pool(self) -> dict[str, torch.Tensor]:
        """The device pool as it stands: leaf path -> device tensor."""
        return dict(self._device)

    def pool_bytes(self) -> int:
        """Bytes of the managed leaves in the pool. Zero-copy leaves are
        left out: they stay host-resident in the model, and a fetch of
        one always hits (`_leaf_resident`)."""
        return sum(t.numel() * t.element_size()
                   for p, t in self._device.items()
                   if p not in self._zc_leaves)

    def _materialize(self, layer_paths: Sequence[Sequence[str]]) -> None:
        for paths in layer_paths:
            for p in paths:
                if p not in self._device and self._leaf_resident(p):
                    self._device[p] = self._copy_in(p)

    # ------------------------------------------------- measured prefetch

    def _measured_setup(self, layer_paths: Sequence[Sequence[str]]) -> None:
        """First-decode measured-prefetch setup (docs/prefetching.md).

        One token's fetch schedule is lowered to touch columns (pure —
        no manager is driven) and profiled; leaves touched at least
        ``hot_threshold`` times per token are the measured hot set.
        Those leaves — byte-bounded to ``hot_frac`` of the pool, largest
        frequency first, and never a leaf that would monopolise half the
        pool — are migrated once and pinned via the session (OP_PIN
        boundary ops, so scalar and batched replays stay byte-identical).
        """
        if self._measured_done:
            return
        self._measured_done = True
        plan = self.plan
        ct = token_trace(plan.leaf_ranges, layer_paths,
                         concurrency=self.concurrency, tokens=1)
        size_arr = np.asarray([r.end - r.start
                               for r in plan.space.ranges], dtype=np.int64)
        prof = HotSetProfile.from_trace(ct, size_arr,
                                        rid_base=plan.rid_base)
        self.hot_profile = prof
        freq = dict(zip(prof.rids.tolist(), prof.freq.tolist()))
        cand = []
        for path, rids in plan.leaf_ranges.items():
            f = freq.get(rids[0] - plan.rid_base, 0)
            nbytes = plan.leaf_bytes[path]
            if f >= self.hot_threshold and nbytes <= self.mgr.capacity // 2:
                cand.append((-f, path, nbytes, rids))
        cand.sort()                      # frequency desc, then fetch order
        budget = self.hot_frac * self.mgr.capacity
        picked: list[str] = []
        pinned_rids: list[int] = []
        total = 0
        for _, path, nbytes, rids in cand:
            if total + nbytes > budget:
                continue
            total += nbytes
            picked.append(path)
            pinned_rids.extend(rids)
        if pinned_rids:
            for rid in pinned_rids:
                self.session.pin(rid)
            self.session.flush(("measured_pin", tuple(pinned_rids)))
        self.measured_hot_leaves = tuple(picked)
        self.measured_hot_bytes = total

    # --------------------------------------------------- decode hot path

    def _scan_units(self, paths_sig: tuple) -> int:
        """Demand-fetch scan units of one step, memoised per step *shape*
        (flops don't matter, so per-token-varying flops can't grow the
        memo; bounded anyway so a long-lived server with churning
        schedules can't leak)."""
        scan = self._step_scan.get(paths_sig)
        if scan is None:
            if len(self._step_scan) >= 256:
                self._step_scan.clear()
            scan = sum(len(self.plan.leaf_ranges[p])
                       for paths in paths_sig for p in paths)
            self._step_scan[paths_sig] = scan
        return scan

    def decode_step(self, layer_paths: Sequence[Sequence[str]],
                    flops: Sequence[float], *,
                    materialize: bool = True) -> None:
        """Replay one decode step's layer-fetch trace as compiled segments.

        Emits exactly the op sequence the imperative per-fetch path
        produces — per layer: staged prefetch touches (with their
        per-leaf hidden-overlap ledger), demand touches, one compute op —
        but sealed into session segments: the first token records and
        compiles them, every later token replays the cached columns.
        Without prefetch the whole step is **one** segment.

        ``materialize=False`` skips device-pool upkeep (metrics-only
        simulation, e.g. riding along a real serving loop)."""
        self._measured_setup(layer_paths)
        n = len(layer_paths)
        rate = self.compute_rate
        secs = tuple(f / rate for f in flops)
        paths_sig = tuple(map(tuple, layer_paths))
        if self.prefetch:
            for i in range(n):
                if i > 0:
                    # layer i was staged during layer i-1's compute window
                    budget = secs[i - 1]
                    for p in layer_paths[i]:
                        self.prefetch_leaf(p, budget)
                key = self._key(("layer", i, tuple(layer_paths[i]),
                                 secs[i]))

                def rec(s, i=i):
                    for p in layer_paths[i]:
                        self._record_leaf(p)
                    s.compute(secs[i])

                self.session.run(key, rec)
        else:
            self.session.run(self._key(("step", paths_sig, secs)),
                             self._step_recorder(layer_paths, secs))
        self.compute_flops += float(sum(flops))
        self.fetch_scan_work += self._scan_units(paths_sig)
        self._drain_evictions()
        if materialize:
            self._materialize(layer_paths)

    def _step_recorder(self, layer_paths, secs) -> Callable:
        def rec(s):
            for i in range(len(layer_paths)):
                for p in layer_paths[i]:
                    self._record_leaf(p)
                s.compute(secs[i])
        return rec

    def decode_steps(self, layer_paths: Sequence[Sequence[str]],
                     flops: Sequence[float], steps: int, *,
                     materialize: bool = True) -> None:
        """Replay ``steps`` identical decode steps in one fused pass.

        The per-token segment (same cache key as `decode_step`'s
        non-prefetch path) is fetched once and concatenated ``steps``
        times into a mega-trace — segment replays resume from the
        manager's live state, so back-to-back replay and concatenated
        replay are bit-identical (`TraceSession` contract) — then
        executed in a single batched-interpreter pass.

        Prefetch mode interleaves per-leaf overlap ledgering between
        segments and the scalar session is the op-for-op golden
        reference, so both fall back to the `decode_step` loop."""
        if steps <= 0:
            return
        self._measured_setup(layer_paths)
        if self.prefetch or self.session.scalar or steps == 1:
            for _ in range(steps):
                self.decode_step(layer_paths, flops,
                                 materialize=materialize)
            return
        rate = self.compute_rate
        secs = tuple(f / rate for f in flops)
        paths_sig = tuple(map(tuple, layer_paths))
        ct = self.session.fetch(self._key(("step", paths_sig, secs)),
                                self._step_recorder(layer_paths, secs))
        mkey = (id(ct), int(steps))
        hit = self._steps_memo.get(mkey)
        if hit is not None and hit[0] is ct:
            self._steps_memo.move_to_end(mkey)
            mega = hit[1]
        else:
            segs = [ct] * steps
            mega = (self.session.shared_cache.concat(segs)
                    if self.session.shared_cache is not None
                    else CompiledTrace.concat(segs))
            self._steps_memo[mkey] = (ct, mega)
            while len(self._steps_memo) > 8:
                self._steps_memo.popitem(last=False)
        self.session.replay(mega)
        # account the fused pass as the per-step loop would: `steps`
        # segment replays (ops_replayed already covers the mega length)
        self.session.segments_replayed += steps - 1
        self.compute_flops += float(sum(flops)) * steps
        self.fetch_scan_work += self._scan_units(paths_sig) * steps
        self._drain_evictions()
        if materialize:
            self._materialize(layer_paths)

    # ------------------------------------------------------------ metrics

    def metrics(self) -> dict:
        s = self.mgr.summary()
        s["wall_s"] = self.mgr.wall - self.overlap_hidden_s
        s["overlap_hidden_s"] = self.overlap_hidden_s
        s["dos"] = self.plan.dos()
        s["compute_flops"] = self.compute_flops
        s["prefetch_mode"] = self.prefetch_mode
        s["measured_hot_bytes"] = self.measured_hot_bytes
        s.update(self.session.stats())
        return s


def run_layer_stream(
    executor: StreamingExecutor,
    layer_paths: list[list[str]],
    apply_layer: Callable[[int, dict[str, torch.Tensor]], float],
    *,
    steps: int = 1,
) -> dict:
    """Drive a layer-ordered streaming pass `steps` times (decode loop).

    `layer_paths[i]` lists the param-leaf paths layer i needs;
    `apply_layer(i, tensors)` runs the math and returns its FLOPs.  The
    math runs every step (tensor values never depend on placement); the
    step's SVM trace replays through `decode_step` — compiled once on the
    first step, cached-segment replays after.
    """
    n = len(layer_paths)
    for _ in range(steps):
        flops = []
        for i in range(n):
            tensors = {p: executor.tensor(p) for p in layer_paths[i]}
            flops.append(apply_layer(i, tensors))
        executor.decode_step(layer_paths, flops)
    return executor.metrics()

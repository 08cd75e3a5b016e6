"""SVMManager — the SVM driver state machine (paper §2.2–§2.4).

Reproduces the driver-visible dynamics:

  * page-level faults, range-level migration (one serviceable fault migrates
    the whole range; concurrent faults on the same range are *duplicates*
    and dismissed — 97–99 % of all faults),
  * synchronous range eviction on the migration critical path, victim chosen
    by the eviction policy (LRF by default),
  * the five-term host-visible cost model, with eviction charged to the
    triggering migration's `alloc` term,
  * migration/eviction event profiles and fault-density samples (paper
    Figs. 7–10).

The manager is driven by access *traces* rather than hardware page
faults, with the paper's policies, range construction and cost accounting.

Beyond-paper / §4.2 driver variants (all selectable):
  * ``parallel_evict``  — overlap eviction with the blocked migration
    (paper §4.2 "Parallel Implementation"): wall time takes
    max(evictions, migration) instead of their sum.
  * ``policy="clock"|"lru"|"random"`` — alternative victim selection.
  * ``defer_granule``/``defer_k`` — adaptive granularity: the first
    ``defer_k - 1`` serviceable faults on a range migrate only a granule,
    deferring the full-range migration (paper §4.2 "Granularity",
    density/access-count triggered prefetching).
  * ``zero_copy`` allocations — never migrated; accesses are charged
    remote-access cost (paper §4.2 "Zero-Copy instead of Demand Paging").
  * ``previct_watermark`` — background pre-eviction below a free-space
    watermark (beyond paper; cf. Li et al. ASPLOS'19), removing eviction
    from the critical path at the cost of mild contention.

All of the above run on the compiled-trace fast tier (`repro_torch.core.engine`)
with byte-identical `summary()` output — no variant drops a sweep to the
scalar per-op path anymore.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.costmodel import (
    CostParams,
    CostVector,
    MI250X,
    eviction_cost,
    migration_cost,
    zerocopy_cost,
)
from repro_torch.core.policies import EvictionPolicy, make_policy
from repro_torch.core.ranges import AddressSpace, Range


class MigrationError(RuntimeError):
    """An injected (or, on real hardware, reported) range-migration
    failure.  Raised by `SVMManager` *before* any state mutation for the
    failing migration, so the manager is left exactly as it was and the
    caller can retry the access — subclassing ``RuntimeError`` keeps the
    batched engine's mid-span snapshot/restore + scalar re-raise path
    applicable, surfacing the error at the exact op with consistent
    state."""


@dataclasses.dataclass
class Event:
    """One migration or eviction, for profile plots (paper Fig. 7)."""

    t: float          # wall-clock seconds at completion
    kind: str         # "mig" | "evt" | "zc"
    rid: int
    alloc_id: int
    nbytes: int


@dataclasses.dataclass
class DensitySample:
    """Faults satisfied by one migration (paper §3.3 'fault density')."""

    t: float
    rid: int
    alloc_id: int
    faults: int          # serviceable + duplicates (dismissed)
    trigger_page: int    # virtual page that raised the serviceable fault


class SVMManager:
    """The SVM driver state machine (see module docstring): page faults,
    range-granular migration/eviction, the five-term cost model, and the
    simulated wall clock, driven by `touch`/`advance`/… calls or — far
    faster — by compiled traces through `repro_torch.core.engine`."""

    def __init__(
        self,
        space: AddressSpace,
        *,
        policy: str | EvictionPolicy = "lrf",
        params: CostParams = MI250X,
        profile: bool = True,
        parallel_evict: bool = False,
        defer_granule: int | None = None,
        defer_k: int = 0,
        previct_watermark: float = 0.0,
        previct_overlap: float = 0.9,
        seed: int = 0,
    ) -> None:
        self.space = space
        self.params = params
        self.policy = (policy if isinstance(policy, EvictionPolicy)
                       else make_policy(policy))
        self.profile = profile
        self.parallel_evict = parallel_evict
        self.defer_granule = defer_granule
        self.defer_k = defer_k
        self.previct_watermark = previct_watermark
        self.previct_overlap = previct_overlap
        self._seed = seed

        self.capacity = space.capacity
        self.free = space.capacity
        self.resident: set[int] = set()
        self.pinned: set[int] = set()
        self.zero_copy_allocs: set[int] = set()
        self._defer_count: dict[int, int] = {}

        # clock & ledgers
        self.wall = 0.0                 # critical-path seconds
        self.compute_time = 0.0
        self.cost = CostVector()        # five-term host-visible work
        self.evict_cost_total = 0.0     # also folded into cost.alloc
        self.chaos_wall = 0.0           # injected latency (faults/backoff)

        # chaos hooks: armed migration-fault countdown + fault ledger
        self.fault_armed = 0
        self.migration_faults = 0

        # counters
        self.n_migrations = 0
        self.n_evictions = 0
        self.n_zerocopy = 0
        self.bytes_migrated = 0
        self.bytes_evicted = 0
        self.bytes_zerocopy = 0
        self.faults_serviceable = 0
        self.faults_duplicate = 0
        self.trigger_pages: set[int] = set()

        # profiles
        self.events: list[Event] = []
        self.density: list[DensitySample] = []

        # push-based eviction notification: callbacks fire with the evicted
        # rid, and the epoch counter bumps once per eviction, so clients
        # (e.g. the streaming executor's device pool) can invalidate only
        # what actually changed instead of rescanning residency
        self.eviction_epoch = 0
        self._evict_listeners: list = []

    # ------------------------------------------------------------------ api

    def pin(self, rid: int) -> None:
        """Pin a resident range (excluded from eviction). Migrates it first
        if needed (app-directed placement, as in SGEMM-svm-aware §4.1)."""
        if rid not in self.resident:
            self.touch(rid, concurrency=1)
        self.pinned.add(rid)
        self.policy.remove(rid)

    def unpin(self, rid: int) -> None:
        if rid in self.pinned:
            self.pinned.discard(rid)
            if rid in self.resident:
                self.policy.insert(rid, self.wall)

    def set_zero_copy(self, alloc_id: int) -> None:
        """Mark an allocation host-pinned / zero-copy (paper §4.2)."""
        self.zero_copy_allocs.add(alloc_id)

    def add_evict_listener(self, callback) -> None:
        """Register ``callback(rid)`` to fire whenever a range is evicted."""
        self._evict_listeners.append(callback)

    def previct(self, rid: int, *, overlap: float = 0.0) -> float:
        """Pre-evict a specific resident range off the migration critical
        path (background eviction, cf. §4.2 / Li et al. ASPLOS'19).

        ``overlap`` is the fraction of the eviction cost hidden behind
        concurrent compute; the remainder lands on the wall clock.  Returns
        the full eviction cost (0.0 if the range was not evictable)."""
        if rid not in self.resident or rid in self.pinned:
            return 0.0
        w = self._evict(rid, charge=None)
        self.wall += w * (1.0 - overlap)
        return w

    def spill_oldest(self, *, overlap: float = 0.0) -> int | None:
        """Pre-evict the policy's current victim (oldest under LRF/FIFO);
        returns its rid, or None when nothing is evictable."""
        if len(self.policy) == 0:
            return None
        victim = self.policy.victim()
        self.previct(victim, overlap=overlap)
        return victim

    def advance(self, seconds: float) -> None:
        """Pure device compute time (no driver involvement)."""
        self.wall += seconds
        self.compute_time += seconds

    # -------------------------------------------------------- chaos hooks
    #
    # Public entry points for the fault-injection layer (docs/
    # robustness.md).  They are deliberately *not* op-driving calls: the
    # runtime layer may invoke them directly without breaking the
    # manager-encapsulation contract, because none of them replays a
    # recorded access — they perturb the environment the replays run in.

    def inject_latency(self, seconds: float) -> None:
        """Charge injected wall time (slow-page surcharge, retry
        backoff) to the critical path.  Not compute, not migration work —
        ledgered separately in ``chaos_wall``."""
        self.wall += seconds
        self.chaos_wall += seconds

    def arm_migration_faults(self, n: int) -> None:
        """Arm the next ``n`` migrations to raise `MigrationError`
        (``n=0`` disarms).  The raise happens before any state mutation
        for that migration, so a retry sees the manager unchanged."""
        self.fault_armed = int(n)

    def resize_capacity(self, new_capacity: int) -> float:
        """Transient co-tenancy: grow/shrink the device pool at runtime
        (another tenant grabbed or released pool bytes).  Shrinking below
        current occupancy emergency-evicts policy victims until the pool
        fits again; the eviction wall lands on the critical path.
        Returns the emergency-eviction wall cost."""
        new_capacity = int(new_capacity)
        if new_capacity < 1:
            raise ValueError("pool capacity must stay positive")
        delta = new_capacity - self.capacity
        self.capacity = new_capacity
        self.free += delta
        w = 0.0
        while self.free < 0:
            victim = self._pick_victim()
            w += self._evict(victim, charge=None)
        self.wall += w
        return w

    def touch(
        self,
        rid: int,
        *,
        bytes_touched: int | None = None,
        concurrency: int = 32,
        page_hint: int | None = None,
        write: bool = False,
    ) -> bool:
        """The kernel accesses data in range `rid`.

        Returns True if the access hit resident data (no migration).
        ``concurrency`` models the number of in-flight wavefront page
        requests during a fault-service window — it sets the duplicate-fault
        count (fault density) for a triggered migration.
        ``page_hint`` identifies the faulting page (defaults to the range's
        first page — linear kernels fault at range starts, paper Fig. 9d-f).
        """
        r = self.space.ranges[rid]
        if r.alloc_id in self.zero_copy_allocs:
            nb = bytes_touched if bytes_touched is not None else r.size
            self.wall += zerocopy_cost(nb, self.params)
            self.n_zerocopy += 1
            self.bytes_zerocopy += nb
            if self.profile:
                self.events.append(Event(self.wall, "zc", rid, r.alloc_id, nb))
            return True

        if rid in self.resident:
            self.policy.on_touch(rid, self.wall)
            return True

        # -------- serviceable page fault → range migration (paper §2.2)
        trigger = (r.start // 4096) + (page_hint or 0)
        self.faults_serviceable += 1
        self.trigger_pages.add(trigger)
        if concurrency >= 32:
            # high-occupancy kernels land a second in-flight fault page in
            # the driver before CAM dedupe (paper Fig. 9d-f: ≈2 faulting
            # pages per migration for STREAM/SGEMM)
            self.trigger_pages.add(trigger + 1)

        # adaptive granularity: defer full-range migration (§4.2)
        if self.defer_granule and self.defer_k > 0:
            c = self._defer_count.get(rid, 0) + 1
            self._defer_count[rid] = c
            if c < self.defer_k:
                nb = min(self.defer_granule, r.size)
                self._migrate_bytes(nb, r, resident=False,
                                    concurrency=concurrency, trigger=trigger)
                return False

        self._migrate_bytes(r.size, r, resident=True,
                            concurrency=concurrency, trigger=trigger)
        return False

    def writeback(self, rid: int) -> None:
        """Algorithmic device→host transfer (e.g. BFS frontier output).

        Counted as an eviction (paper §3.4: BFS's eviction-to-migration
        ratio is nonzero even below DOS 100 because it "algorithmically
        transfers data from the device to the host")."""
        if rid in self.resident:
            w = self._evict(rid, charge=None)
            self.wall += w

    # ------------------------------------------------------------ internals

    def _noise(self, k: int) -> float:
        """Deterministic ±20 % jitter for fault-density samples."""
        h = (k * 2654435761 + self._seed * 97) & 0xFFFFFFFF
        return 0.8 + 0.4 * (h / 0xFFFFFFFF)

    def _migrate_bytes(self, nbytes: int, r: Range, *, resident: bool,
                       concurrency: int, trigger: int) -> None:
        if self.fault_armed > 0:
            # armed chaos fault: fail this migration before touching any
            # state (counters, residency, policy, clock all unchanged)
            self.fault_armed -= 1
            self.migration_faults += 1
            raise MigrationError(
                f"injected migration failure on range {r.rid} "
                f"({nbytes} bytes)")
        mc = migration_cost(nbytes, self.params)

        # ---- allocation: evict until there is room (paper §2.2, Fig. 3)
        base_mig = mc.total()  # migration work excluding evictions
        evict_wall = 0.0
        while self.free < nbytes:
            victim = self._pick_victim()
            evict_wall += self._evict(victim, charge=mc)

        if self.parallel_evict and evict_wall > 0.0:
            # §4.2 Parallel Implementation: overlap eviction(s) with the
            # blocked migration; lock/rollback overhead on top.
            wall_delta = max(base_mig, evict_wall) + 5e-6
        else:
            wall_delta = mc.total()  # evictions already folded into mc.alloc

        self.cost.add(mc)
        self.wall += wall_delta
        self.n_migrations += 1
        self.bytes_migrated += nbytes
        if resident:
            self.free -= nbytes
            self.resident.add(r.rid)
            if r.rid not in self.pinned:
                self.policy.insert(r.rid, self.wall)
            self._defer_count.pop(r.rid, None)
        else:
            pass  # deferred granule copy: not tracked as residency

        dup = max(0, int(concurrency * self._noise(self.n_migrations)) - 1)
        self.faults_duplicate += dup
        if self.profile:
            self.events.append(
                Event(self.wall, "mig", r.rid, r.alloc_id, nbytes))
            self.density.append(
                DensitySample(self.wall, r.rid, r.alloc_id, 1 + dup, trigger))

        # background pre-eviction below watermark (beyond paper)
        if self.previct_watermark > 0.0:
            target = self.previct_watermark * self.capacity
            while self.free < target and len(self.policy) > 0:
                victim = self._pick_victim()
                w = self._evict(victim, charge=None)
                # mostly off critical path
                self.wall += w * (1.0 - self.previct_overlap)

    def _pick_victim(self) -> int:
        if len(self.policy) == 0:
            raise RuntimeError(
                "SVM: device full of pinned/unevictable ranges "
                f"(free={self.free}, need more; pinned={len(self.pinned)})")
        return self.policy.victim()

    def _evict(self, rid: int, charge: CostVector | None) -> float:
        """Evict one range; returns its wall cost. If `charge` is given the
        cost is folded into that migration's `alloc` term (paper §2.4)."""
        r = self.space.ranges[rid]
        ec = eviction_cost(r.size, self.params)
        if charge is not None:
            charge.alloc += ec
        else:
            self.cost.alloc += ec
        self.evict_cost_total += ec
        self.policy.remove(rid)
        self.resident.discard(rid)
        self.free += r.size
        self.n_evictions += 1
        self.bytes_evicted += r.size
        self.eviction_epoch += 1
        if self._evict_listeners:
            for cb in self._evict_listeners:
                cb(rid)
        if self.profile:
            self.events.append(Event(self.wall, "evt", rid, r.alloc_id, r.size))
        return ec

    # ------------------------------------------------------------- metrics

    @property
    def faults_total(self) -> int:
        return self.faults_serviceable + self.faults_duplicate

    @property
    def duplicate_share(self) -> float:
        t = self.faults_total
        return self.faults_duplicate / t if t else 0.0

    @property
    def evict_to_mig_ratio(self) -> float:
        return self.n_evictions / self.n_migrations if self.n_migrations else 0.0

    @property
    def mean_fault_density(self) -> float:
        if not self.density:
            return 0.0
        return sum(d.faults for d in self.density) / len(self.density)

    @property
    def serviceable_per_migration(self) -> float:
        """Unique trigger pages / migrations (paper Fig. 9d-f: ≈2 for
        streaming, ≈0.05 for thrashing GESUMMV)."""
        if not self.n_migrations:
            return 0.0
        return len(self.trigger_pages) / self.n_migrations

    def summary(self) -> dict:
        return {
            "wall_s": self.wall,
            "compute_s": self.compute_time,
            "migrations": self.n_migrations,
            "evictions": self.n_evictions,
            "evict_to_mig": self.evict_to_mig_ratio,
            "bytes_migrated": self.bytes_migrated,
            "bytes_evicted": self.bytes_evicted,
            "faults_serviceable": self.faults_serviceable,
            "faults_duplicate": self.faults_duplicate,
            "duplicate_share": self.duplicate_share,
            "mean_fault_density": self.mean_fault_density,
            "serviceable_per_migration": self.serviceable_per_migration,
            "cost_breakdown": self.cost.as_dict(),
            "dos": self.space.dos(),
            "capacity_bytes": self.capacity,
            "chaos_wall_s": self.chaos_wall,
            "migration_faults": self.migration_faults,
        }

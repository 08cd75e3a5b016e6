"""UVM-style baseline manager (paper Table 1 comparison).

Models the NVIDIA-UVM design points the paper contrasts with SVM:

  * UM (de)allocation in 2 MB **VABlocks** (vs SVM ranges up to 1 GB),
  * migration unit: 64 KB base pages, coalesced up to a VABlock by a
    density/tree prefetcher (contiguous faulting blocks in one batch are
    migrated as one transfer),
  * **fault batching**: up to ``MAX_BATCH`` faults buffered **across ops**
    and serviced together (vs SVM's immediate single-fault servicing).
    The buffer flushes when it reaches ``MAX_BATCH`` distinct blocks, when
    the pending blocks no longer fit in free device memory (capacity
    pressure), and at every driver synchronisation point: ``advance``
    (kernel compute), ``writeback``, ``pin``, or an explicit ``flush()``
    (the simulator flushes once at end of trace).  ``BATCH_FIXED_S`` is
    therefore charged per *batch*, not per faulting touch.  A touch on a
    block already sitting in the buffer is dismissed as a duplicate fault
    (the fault CAM dedupes it) — cf. Chien et al., *Performance Evaluation
    of Advanced Features in CUDA Unified Memory*.
  * eviction at VABlock granularity (LRU over blocks), with **dirtiness
    tracking**: evicting a clean block is an unmap (page-table work only,
    no copy, no bytes moved), only dirty blocks (touched with
    ``write=True``) pay the full device→host transfer.  Algorithmic
    device→host copies issued via ``writeback`` are booked as writebacks
    (``n_writebacks`` / ``bytes_writeback`` / ``writeback_cost_total``),
    not as eviction overhead.

Exposes the same trace-facing API as SVMManager (`touch`, `advance`,
`writeback`, `pin`, `summary`) so the simulator can drive either.  The
compiled-trace engine (`repro_torch.core.engine`) has a batched interpreter for
this manager with byte-identical `summary()` output.
"""

from __future__ import annotations

from collections import OrderedDict

from repro_torch.core.costmodel import CostParams, CostVector, MI250X, migration_cost
from repro_torch.core.ranges import AddressSpace, MB
from repro_torch.core.svm import Event

VABLOCK = 2 * MB
BASE_CHUNK = 64 * 1024
MAX_BATCH = 256

BATCH_FIXED_S = 45e-6     # GPU->host interrupt + batch preprocessing
PER_FAULT_S = 2.5e-6      # per-fault decode/dedupe within a batch


class UVMManager:
    """The NVIDIA-UM baseline (Table 1): VABlock-granular demand paging
    with cross-op fault batching (CAM dedupe, serviced at driver sync
    points), dirtiness-tracked LRU eviction, and writeback accounting —
    the comparison design point for the paper's SVM range machinery."""

    def __init__(
        self,
        space: AddressSpace,
        *,
        params: CostParams = MI250X,
        profile: bool = True,
        prefetch: bool = True,
        **_ignored,
    ) -> None:
        self.space = space
        self.params = params
        self.profile = profile
        self.prefetch = prefetch
        self.capacity = space.capacity
        self.free = space.capacity
        # resident VABlocks: block_id -> last-use time (LRU)
        self.resident: OrderedDict[int, float] = OrderedDict()
        self.pinned: set[int] = set()
        self.dirty: set[int] = set()      # written since migration

        self.wall = 0.0
        self.compute_time = 0.0
        self.cost = CostVector()
        self.n_migrations = 0      # transfers (after coalescing)
        self.n_evictions = 0
        self.n_writebacks = 0
        self.n_batches = 0
        self.bytes_migrated = 0
        self.bytes_evicted = 0
        self.bytes_writeback = 0
        self.evict_cost_total = 0.0
        self.writeback_cost_total = 0.0
        self.faults_serviceable = 0
        self.faults_duplicate = 0
        self.trigger_pages: set[int] = set()
        self.events: list[Event] = []
        self.density: list = []
        # pending faulting block ids, insertion-ordered, CAM-deduped
        self._pending: OrderedDict[int, None] = OrderedDict()
        # one VABlock's migration cost is a constant of `params`
        self._mc_block = migration_cost(VABLOCK, params)
        self._mc_block_total = self._mc_block.total()

    # -------------------------------------------------------------- helpers

    def _blocks_of_range(self, rid: int) -> range:
        r = self.space.ranges[rid]
        return range(r.start // VABLOCK, -(-r.end // VABLOCK))

    # ------------------------------------------------------------------ api

    def touch(self, rid: int, *, bytes_touched: int | None = None,
              concurrency: int = 32, page_hint: int | None = None,
              write: bool = False) -> bool:
        hit = True
        blocks = self._blocks_of_range(rid)
        for b in blocks:
            if b in self.resident:
                self.resident.move_to_end(b)
                self.resident[b] = self.wall
            elif b in self._pending:
                # already buffered: the fault CAM dedupes it
                hit = False
                self.faults_duplicate += 1
            else:
                hit = False
                self._pending[b] = None
                self.faults_serviceable += 1
                self.trigger_pages.add(b * (VABLOCK // 4096))
                self.faults_duplicate += max(0, concurrency // 8)
                if (len(self._pending) >= MAX_BATCH
                        or len(self._pending) * VABLOCK >= self.free):
                    self._service_batch()
        if write:
            self.dirty.update(blocks)
        return hit

    def advance(self, seconds: float) -> None:
        self.flush()     # kernel-boundary sync: service buffered faults
        self.wall += seconds
        self.compute_time += seconds

    def flush(self) -> None:
        """Service any buffered faults (driver synchronisation point)."""
        self._service_batch()

    def writeback(self, rid: int) -> None:
        """Algorithmic device→host copy (e.g. BFS frontier output): a full
        transfer per resident block, booked as writeback — not eviction."""
        self.flush()
        for b in self._blocks_of_range(rid):
            if b in self.resident:
                self._writeback_block(b)

    def pin(self, rid: int) -> None:
        self.touch(rid, concurrency=1)
        self.flush()     # blocks must be resident before they leave the LRU
        for b in self._blocks_of_range(rid):
            self.pinned.add(b)
            self.resident.pop(b, None)  # memory accounting unchanged

    def unpin(self, rid: int) -> None:
        for b in self._blocks_of_range(rid):
            if b in self.pinned:
                self.pinned.discard(b)
                self.resident[b] = self.wall

    # ------------------------------------------------------------ internals

    def _service_batch(self) -> None:
        if not self._pending:
            return
        blocks = sorted(self._pending)
        self._pending.clear()
        self.n_batches += 1
        self.wall += BATCH_FIXED_S + PER_FAULT_S * len(blocks)
        # tree/density prefetcher: coalesce contiguous faulting blocks
        groups: list[list[int]] = [[blocks[0]]]
        for b in blocks[1:]:
            if self.prefetch and b == groups[-1][-1] + 1:
                groups[-1].append(b)
            else:
                groups.append([b])
        for g in groups:
            nbytes = len(g) * VABLOCK
            # make room at VABlock granularity (LRU)
            while self.free < nbytes:
                victim = self._lru_victim()
                self._evict(victim)
            mc = migration_cost(nbytes, self.params)
            self.cost.add(mc)
            self.wall += mc.total()
            self.n_migrations += 1
            self.bytes_migrated += nbytes
            for b in g:
                self.resident[b] = self.wall
            self.free -= nbytes
            if self.profile:
                rid = self._rid_of_block(g[0])
                self.events.append(Event(self.wall, "mig", rid,
                                         self.space.ranges[rid].alloc_id,
                                         nbytes))

    def _rid_of_block(self, b: int) -> int:
        addr = min(b * VABLOCK, self.space.ranges[-1].end - 1)
        addr = max(addr, self.space.ranges[0].start)
        return self.space.range_at(addr).rid

    def _lru_victim(self) -> int:
        for b in self.resident:
            if b not in self.pinned:
                return b
        raise RuntimeError("UVM: all resident blocks pinned")

    def _evict(self, b: int) -> None:
        """LRU capacity eviction: dirty blocks pay the full device→host
        transfer (charged to `alloc`, mirroring SVM's eviction booking);
        clean blocks are dropped with page-table unmap work only — no copy,
        no bytes counted."""
        if b in self.dirty:
            w = self._mc_block_total
            self.cost.alloc += w
            self.evict_cost_total += w
            self.bytes_evicted += VABLOCK
            self.dirty.discard(b)
        else:
            w = self._mc_block.cpu_unmap
            self.cost.cpu_unmap += w
        self.wall += w
        self.resident.pop(b, None)
        self.free += VABLOCK
        self.n_evictions += 1
        if self.profile:
            rid = self._rid_of_block(b)
            self.events.append(Event(self.wall, "evt", rid,
                                     self.space.ranges[rid].alloc_id, VABLOCK))

    def _writeback_block(self, b: int) -> None:
        """Device→host transfer of one block on behalf of the application;
        the block is dropped after the copy (its data now lives on the
        host).  Booked per cost term (a real five-phase transfer) and in
        the writeback counters."""
        w = self._mc_block_total
        self.cost.add(self._mc_block)
        self.writeback_cost_total += w
        self.wall += w
        self.resident.pop(b, None)
        self.dirty.discard(b)
        self.free += VABLOCK
        self.n_writebacks += 1
        self.bytes_writeback += VABLOCK
        if self.profile:
            rid = self._rid_of_block(b)
            self.events.append(Event(self.wall, "wb", rid,
                                     self.space.ranges[rid].alloc_id, VABLOCK))

    # ------------------------------------------------------------- metrics

    @property
    def faults_total(self) -> int:
        return self.faults_serviceable + self.faults_duplicate

    @property
    def evict_to_mig_ratio(self) -> float:
        return self.n_evictions / self.n_migrations if self.n_migrations else 0.0

    def summary(self) -> dict:
        return {
            "wall_s": self.wall,
            "compute_s": self.compute_time,
            "migrations": self.n_migrations,
            "evictions": self.n_evictions,
            "writebacks": self.n_writebacks,
            "batches": self.n_batches,
            "evict_to_mig": self.evict_to_mig_ratio,
            "bytes_migrated": self.bytes_migrated,
            "bytes_evicted": self.bytes_evicted,
            "bytes_writeback": self.bytes_writeback,
            "faults_serviceable": self.faults_serviceable,
            "faults_duplicate": self.faults_duplicate,
            "cost_breakdown": self.cost.as_dict(),
            "dos": self.space.dos(),
        }

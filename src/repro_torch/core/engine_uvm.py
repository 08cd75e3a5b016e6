"""Batched interpreter for `UVMManager` — the UVM side of the fast tier.

The scalar `UVMManager.touch` walks every VABlock of the touched range
through an OrderedDict LRU (a `move_to_end` + store per resident block,
hundreds of blocks per large range), which dominates UVM sweep wall time.
This interpreter keeps the block state in flat NumPy arrays instead:

  * residency / pinned / dirty / pending as boolean bitmaps over the
    block universe, so a touch is a handful of fancy-indexed vector ops
    regardless of range size;
  * LRU recency as a monotonically increasing per-block sequence number
    (one per scalar `move_to_end`); the victim is the min-seq resident
    block (a masked argmin, or one argpartition for an eviction storm),
    which is exactly the OrderedDict's front-of-queue order;
  * fault-batch servicing (sort, coalesce, evict, migrate) mirrors the
    scalar float/accounting operations **in the same order**, so every
    wall/cost accumulator is bit-for-bit identical.

Mid-touch batch flushes (MAX_BATCH or capacity pressure) are honoured by
splitting the block vector at the first fault that trips a threshold and
re-classifying the remainder against the post-service residency, exactly
as the scalar per-block loop would.

On completion the manager's OrderedDict/set state is reconstructed from
the arrays (ordering by sequence number restores the exact LRU order), so
`summary()`, counters, residency, the pending fault buffer, and profile
events all match `apply_trace` byte for byte.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

from repro_torch.core.uvm import (
    BATCH_FIXED_S,
    MAX_BATCH,
    PER_FAULT_S,
    UVMManager,
    VABLOCK,
)
from repro_torch.core.svm import Event

from repro_torch.core.engine import (   # noqa: E402  (engine imports us lazily)
    OP_COMPUTE,
    OP_PIN,
    OP_TOUCH,
    OP_UNPIN,
    OP_WRITEBACK,
)

_NO_SEQ = np.iinfo(np.int64).max


class _UVMState:
    """Array mirror of a UVMManager's block state, plus local scalars for
    the hot accumulators (written back to the manager once at the end)."""

    def __init__(self, mgr: UVMManager):
        space = mgr.space
        self.mgr = mgr
        self.nblocks = -(-space.ranges[-1].end // VABLOCK)
        nb = self.nblocks
        self.res = np.zeros(nb, dtype=bool)
        self.seq = np.zeros(nb, dtype=np.int64)
        self.time = np.zeros(nb)
        self.pinned = np.zeros(nb, dtype=bool)
        self.dirty = np.zeros(nb, dtype=bool)
        self.pending_arr = np.zeros(nb, dtype=bool)
        self.counter = 0
        for b, t in mgr.resident.items():
            self.res[b] = True
            self.seq[b] = self.counter
            self.time[b] = t
            self.counter += 1
        for b in mgr.pinned:
            self.pinned[b] = True
        self.n_pinned = len(mgr.pinned)
        for b in mgr.dirty:
            self.dirty[b] = True
        self.n_dirty = len(mgr.dirty)
        self.pending_list: list[int] = list(mgr._pending)
        self.pending_count = len(self.pending_list)
        if self.pending_list:
            self.pending_arr[self.pending_list] = True

        self.blocks = [np.arange(r.start // VABLOCK, -(-r.end // VABLOCK),
                                 dtype=np.int64)
                       for r in space.ranges]
        self.wall = mgr.wall
        self.compute_time = mgr.compute_time
        self.free = mgr.free
        self.n_migrations = mgr.n_migrations
        self.n_evictions = mgr.n_evictions
        self.n_writebacks = mgr.n_writebacks
        self.n_batches = mgr.n_batches
        self.bytes_migrated = mgr.bytes_migrated
        self.bytes_evicted = mgr.bytes_evicted
        self.bytes_writeback = mgr.bytes_writeback
        self.evict_cost_total = mgr.evict_cost_total
        self.writeback_cost_total = mgr.writeback_cost_total
        self.faults_serviceable = mgr.faults_serviceable
        self.faults_duplicate = mgr.faults_duplicate
        self.trigger: set[int] = set()
        self.trig_chunks: list[np.ndarray] = []   # block-id arrays, * pages
        self.mc_cache: dict[int, tuple] = {}   # nbytes -> (CostVector, total)

    def finish(self) -> None:
        mgr = self.mgr
        resb = np.nonzero(self.res)[0]
        order = np.argsort(self.seq[resb])       # seqs are unique
        mgr.resident = OrderedDict(
            zip(resb[order].tolist(), self.time[resb[order]].tolist()))
        mgr.pinned = set(np.nonzero(self.pinned)[0].tolist())
        mgr.dirty = set(np.nonzero(self.dirty)[0].tolist())
        mgr._pending = OrderedDict.fromkeys(self.pending_list)
        mgr.wall = self.wall
        mgr.compute_time = self.compute_time
        mgr.free = self.free
        mgr.n_migrations = self.n_migrations
        mgr.n_evictions = self.n_evictions
        mgr.n_writebacks = self.n_writebacks
        mgr.n_batches = self.n_batches
        mgr.bytes_migrated = self.bytes_migrated
        mgr.bytes_evicted = self.bytes_evicted
        mgr.bytes_writeback = self.bytes_writeback
        mgr.evict_cost_total = self.evict_cost_total
        mgr.writeback_cost_total = self.writeback_cost_total
        mgr.faults_serviceable = self.faults_serviceable
        mgr.faults_duplicate = self.faults_duplicate
        mgr.trigger_pages.update(self.trigger)
        if self.trig_chunks:
            mgr.trigger_pages.update(
                (np.concatenate(self.trig_chunks)
                 * (VABLOCK // 4096)).tolist())
            self.trig_chunks = []


def execute_compiled_uvm(ct, mgr: UVMManager) -> None:
    """Apply a compiled trace to a UVMManager; equivalent to
    `apply_trace` (same flush points: compute ops, writeback, pin,
    MAX_BATCH, capacity pressure — the end-of-trace flush stays the
    caller's job, as with the scalar path)."""
    st = _UVMState(mgr)
    # list mirrors of the op columns, memoised on the (immutable) trace:
    # a cached CompiledTrace re-executed across sweep points — including
    # by the SVM interpreter for other points of the same TraceKey group —
    # converts once, not per execution
    lists = ct.span_cache.get("uvm_lists")
    if lists is None:
        lists = (ct.codes.tolist(), ct.rids.tolist(),
                 ct.concs.tolist(), ct.fargs.tolist())
        ct.span_cache["uvm_lists"] = lists
    codes, rids, concs, fargs = lists
    try:
        for k in range(len(codes)):
            c = codes[k]
            if c == OP_TOUCH:
                _touch(st, rids[k], concs[k])
            elif c == OP_COMPUTE:
                _service(st)
                st.wall += fargs[k]
                st.compute_time += fargs[k]
            elif c == OP_WRITEBACK:
                _writeback(st, rids[k])
            elif c == OP_PIN:
                _touch(st, rids[k], 1)
                _service(st)
                bl = st.blocks[rids[k]]
                st.pinned[bl] = True
                st.res[bl] = False       # memory accounting unchanged
                st.n_pinned = int(st.pinned.sum())
            elif c == OP_UNPIN:
                bl = st.blocks[rids[k]]
                sel = st.pinned[bl]
                if sel.any():
                    ub = bl[sel]
                    st.pinned[ub] = False
                    st.n_pinned = int(st.pinned.sum())
                    # scalar resident[b] = wall: appends NEW keys in block
                    # order but leaves already-resident blocks (faulted
                    # back in while pinned) at their old LRU position
                    newly = ub[~st.res[ub]]
                    st.res[ub] = True
                    st.seq[newly] = np.arange(st.counter,
                                              st.counter + len(newly))
                    st.counter += len(newly)
                    st.time[ub] = st.wall
            else:
                # OP_SPILL (eager pre-eviction) is an SVM policy concept;
                # the UVM baseline has no range-level spill API
                raise ValueError(
                    f"opcode {c} unsupported on the UVM interpreter")
    finally:
        # flush array state back even on a mid-trace device-full error so
        # the manager is left in the same partial state as the scalar path
        st.finish()


def _touch(st: _UVMState, rid: int, conc: int) -> None:
    blocks = st.blocks[rid]
    dup_base = conc // 8 if conc >= 8 else 0
    res = st.res[blocks]
    if res.all():
        # pure-hit fast path: the paper's dominant re-touch case
        st.seq[blocks] = np.arange(st.counter, st.counter + len(blocks))
        st.counter += len(blocks)
        st.time[blocks] = st.wall
        return
    if (st.pending_count == 0 and st.free < VABLOCK and not res.any()
            and not st.pending_arr[blocks].any()):
        # fault storm: every block pends and trips the capacity flush
        # immediately — one single-fault service (evict one, migrate one)
        # per block, fully vectorisable
        _touch_storm(st, blocks, dup_base)
        return
    start = 0
    n = len(blocks)
    while start < n:
        c_star = min(MAX_BATCH, -(-st.free // VABLOCK))
        if c_star - st.pending_count < 16:
            # near a flush threshold (capacity pressure): vector segments
            # would degenerate to per-block slices — mirror the scalar
            # per-block loop directly on the array state instead
            _touch_scalar(st, blocks, start, dup_base)
            return
        bl = blocks[start:] if start else blocks
        res = st.res[bl]
        pend = st.pending_arr[bl]
        new_mask = ~res & ~pend
        new_idx = np.nonzero(new_mask)[0]
        # first new fault that trips a flush: batch full, or the pending
        # blocks no longer fit in free memory (thresholds are constant
        # between services — free only changes inside _service)
        cut = len(bl)
        flush_after = False
        if len(new_idx):
            jstar = c_star - st.pending_count
            if jstar < 1:
                jstar = 1
            if jstar <= len(new_idx):
                cut = int(new_idx[jstar - 1]) + 1
                flush_after = True
        res_s = res[:cut]
        hits = np.nonzero(res_s)[0]
        if len(hits):
            hb = bl[hits]
            st.seq[hb] = np.arange(st.counter, st.counter + len(hb))
            st.counter += len(hb)
            st.time[hb] = st.wall
        st.faults_duplicate += int((~res_s & pend[:cut]).sum())
        newb = bl[:cut][new_mask[:cut]]
        if len(newb):
            st.pending_arr[newb] = True
            st.pending_list.extend(newb.tolist())
            st.pending_count += len(newb)
            st.faults_serviceable += len(newb)
            st.trig_chunks.append(newb)
            st.faults_duplicate += dup_base * len(newb)
        if flush_after:
            _service(st)
        start += cut


def _touch_scalar(st: _UVMState, blocks: np.ndarray, start: int,
                  dup_base: int) -> None:
    """Per-block mirror of the scalar touch loop, used when every few
    faults trip a flush (capacity pressure) and vector segments would
    shrink to single blocks."""
    res = st.res
    pend = st.pending_arr
    seq = st.seq
    time = st.time
    trig_scale = VABLOCK // 4096
    for b in blocks[start:].tolist():
        if res[b]:
            seq[b] = st.counter
            st.counter += 1
            time[b] = st.wall
        elif pend[b]:
            st.faults_duplicate += 1
        else:
            pend[b] = True
            st.pending_list.append(b)
            st.pending_count += 1
            st.faults_serviceable += 1
            st.trigger.add(b * trig_scale)
            st.faults_duplicate += dup_base
            if (st.pending_count >= MAX_BATCH
                    or st.pending_count * VABLOCK >= st.free):
                _service(st)


def _touch_storm(st: _UVMState, blocks: np.ndarray, dup_base: int) -> None:
    """Vectorised single-fault-service storm: with ``free < VABLOCK`` and
    an empty buffer, each non-resident block pends, immediately trips the
    capacity flush, evicts exactly one LRU victim, and migrates one block
    — so the whole touch is a fixed wall/cost pattern per block, folded
    with one ``cumsum`` (bit-identical to the scalar `+=` chain)."""
    n = len(blocks)
    # victim stream: the n resident blocks with the smallest seqs, in seq
    # order — exactly n successive LRU pops (the n new blocks get higher
    # seqs than every existing resident block, so they are never victims
    # within this touch), selected with one argpartition.
    cand = np.nonzero(_evictable(st))[0]
    if len(cand) < n:
        # fewer pre-existing residents than faults: the scalar loop would
        # start evicting this touch's own earlier blocks (or raise on a
        # truly empty pool) — mirror it block by block instead
        _touch_scalar(st, blocks, 0, dup_base)
        return
    sq = st.seq[cand]
    if len(cand) > n:
        part = np.argpartition(sq, n - 1)[:n]
        victims = cand[part[np.argsort(sq[part])]]
    else:
        victims = cand[np.argsort(sq)]
    st.res[victims] = False
    _storm_apply(st, blocks, victims, dup_base)


def _storm_apply(st: _UVMState, blocks: np.ndarray, victims: np.ndarray,
                 dup_base: int) -> None:
    if not len(blocks):
        return
    mgr = st.mgr
    n = len(blocks)
    mc, mc_total = _mc_for(st, VABLOCK)
    all_clean = st.n_dirty == 0          # the trace case: touches never write
    if all_clean:
        ev_w = mgr._mc_block.cpu_unmap
        nd = 0
    else:
        dirty_v = st.dirty[victims]
        ev_w = np.where(dirty_v, mgr._mc_block_total,
                        mgr._mc_block.cpu_unmap)
        nd = int(dirty_v.sum())
    # wall: per fault [batch fixed+decode, evict, migrate] — exact fold
    deltas = np.empty(3 * n)
    deltas[0::3] = BATCH_FIXED_S + PER_FAULT_S
    deltas[1::3] = ev_w
    deltas[2::3] = mc_total
    traj = np.cumsum(np.concatenate(([st.wall], deltas)))
    st.wall = float(traj[-1])
    ev_wall = traj[2::3]       # wall after each eviction
    mig_wall = traj[3::3]      # wall after each migration
    cost = mgr.cost
    # cost folds, scalar order per fault: the eviction charge (alloc if
    # dirty, cpu_unmap if clean) then the migration's five terms.  Terms
    # with no eviction contribution skip the zero interleave (+0.0 is
    # add-identity for the non-negative accumulators)
    ledger2 = np.empty((2 * n + 1, 2))
    ledger2[0] = (cost.cpu_unmap, cost.alloc)
    if all_clean:
        ledger2[1::2, 0] = mgr._mc_block.cpu_unmap
        ledger2[1::2, 1] = 0.0
    else:
        ledger2[1::2, 0] = np.where(dirty_v, 0.0, mgr._mc_block.cpu_unmap)
        ledger2[1::2, 1] = np.where(dirty_v, mgr._mc_block_total, 0.0)
    ledger2[2::2, 0] = mc.cpu_unmap
    ledger2[2::2, 1] = mc.alloc
    cost.cpu_unmap, cost.alloc = np.cumsum(ledger2, axis=0)[-1].tolist()
    ledger3 = np.empty((n + 1, 3))
    ledger3[0] = (cost.sdma_setup, cost.cpu_update, cost.misc)
    ledger3[1:] = (mc.sdma_setup, mc.cpu_update, mc.misc)
    (cost.sdma_setup, cost.cpu_update,
     cost.misc) = np.cumsum(ledger3, axis=0)[-1].tolist()
    if nd:
        dirty_ws = np.full(nd, mgr._mc_block_total)
        st.evict_cost_total = float(np.cumsum(
            np.concatenate(([st.evict_cost_total], dirty_ws)))[-1])
        st.bytes_evicted += nd * VABLOCK
        st.dirty[victims] = False
        st.n_dirty -= nd
    st.res[victims] = False
    st.res[blocks] = True
    seqs = np.arange(st.counter, st.counter + n)
    st.counter += n
    st.seq[blocks] = seqs
    st.time[blocks] = mig_wall
    st.n_batches += n
    st.n_evictions += n
    st.n_migrations += n
    st.bytes_migrated += n * VABLOCK
    st.faults_serviceable += n
    st.faults_duplicate += dup_base * n
    st.trig_chunks.append(blocks)
    if mgr.profile:
        events = mgr.events
        ranges = mgr.space.ranges
        ew = ev_wall.tolist()
        mw = mig_wall.tolist()
        for i, (v, b) in enumerate(zip(victims.tolist(), blocks.tolist())):
            rv = mgr._rid_of_block(v)
            events.append(Event(ew[i], "evt", rv, ranges[rv].alloc_id,
                                VABLOCK))
            rb = mgr._rid_of_block(b)
            events.append(Event(mw[i], "mig", rb, ranges[rb].alloc_id,
                                VABLOCK))


def _mc_for(st: _UVMState, nbytes: int):
    cached = st.mc_cache.get(nbytes)
    if cached is None:
        from repro_torch.core.costmodel import migration_cost
        mc = migration_cost(nbytes, st.mgr.params)
        st.mc_cache[nbytes] = cached = (mc, mc.total())
    return cached


def _service(st: _UVMState) -> None:
    if not st.pending_count:
        return
    mgr = st.mgr
    if st.pending_count == 1:
        _service_one(st)
        return
    barr = np.sort(np.asarray(st.pending_list, dtype=np.int64))
    st.pending_arr[barr] = False
    st.pending_list = []
    st.pending_count = 0
    st.n_batches += 1
    st.wall += BATCH_FIXED_S + PER_FAULT_S * len(barr)
    # tree/density prefetcher: coalesce contiguous faulting blocks
    if mgr.prefetch:
        splits = np.nonzero(np.diff(barr) != 1)[0] + 1
        gstarts = np.concatenate(([0], splits))
        gends = np.concatenate((splits, [len(barr)]))
    else:
        gstarts = np.arange(len(barr))
        gends = gstarts + 1
    gsizes = gends - gstarts
    total_bytes = len(barr) * VABLOCK
    if st.free >= total_bytes:
        # no group can evict (free only shrinks across groups): fold the
        # whole batch's migrations vectorised
        _service_noevict(st, barr, gsizes)
        return
    for gs, ge in zip(gstarts.tolist(), gends.tolist()):
        g = barr[gs:ge]
        nbytes = (ge - gs) * VABLOCK
        while st.free < nbytes:
            _evict(st, _pop_victim(st))
        mc, mc_total = _mc_for(st, nbytes)
        mgr.cost.add(mc)
        st.wall += mc_total
        st.n_migrations += 1
        st.bytes_migrated += nbytes
        newly = g[~st.res[g]]
        st.res[g] = True
        st.seq[newly] = np.arange(st.counter, st.counter + len(newly))
        st.counter += len(newly)
        st.time[g] = st.wall
        st.free -= nbytes
        if mgr.profile:
            rid = mgr._rid_of_block(int(g[0]))
            mgr.events.append(Event(st.wall, "mig", rid,
                                    mgr.space.ranges[rid].alloc_id, nbytes))


def _service_noevict(st: _UVMState, barr: np.ndarray,
                     gsizes: np.ndarray) -> None:
    mgr = st.mgr
    k = len(gsizes)
    nbytes_g = gsizes * VABLOCK
    usz = np.unique(nbytes_g)
    terms = np.empty((len(usz), 5))
    totals = np.empty(len(usz))
    for j, sz in enumerate(usz.tolist()):
        mc, tot = _mc_for(st, sz)
        terms[j] = (mc.cpu_unmap, mc.sdma_setup, mc.alloc,
                    mc.cpu_update, mc.misc)
        totals[j] = tot
    idx = np.searchsorted(usz, nbytes_g)
    cost = mgr.cost
    ledger = np.empty((k + 1, 5))
    ledger[0] = (cost.cpu_unmap, cost.sdma_setup, cost.alloc,
                 cost.cpu_update, cost.misc)
    ledger[1:] = terms[idx]
    (cost.cpu_unmap, cost.sdma_setup, cost.alloc, cost.cpu_update,
     cost.misc) = np.cumsum(ledger, axis=0)[-1].tolist()
    traj = np.cumsum(np.concatenate(([st.wall], totals[idx])))
    st.wall = float(traj[-1])
    gwall = traj[1:]
    st.n_migrations += k
    st.bytes_migrated += len(barr) * VABLOCK
    newly = barr[~st.res[barr]]
    st.res[barr] = True
    st.seq[newly] = np.arange(st.counter, st.counter + len(newly))
    st.counter += len(newly)
    st.time[barr] = np.repeat(gwall, gsizes)
    st.free -= len(barr) * VABLOCK
    if mgr.profile:
        gw = gwall.tolist()
        gstart_blocks = barr[np.cumsum(gsizes) - gsizes].tolist()
        for j in range(k):
            rid = mgr._rid_of_block(gstart_blocks[j])
            mgr.events.append(Event(gw[j], "mig", rid,
                                    mgr.space.ranges[rid].alloc_id,
                                    int(nbytes_g[j])))


def _service_one(st: _UVMState) -> None:
    """Single-fault batch: the common shape under capacity pressure (every
    pend trips the capacity flush).  Same operations as the general path,
    without the sort/group/array scaffolding."""
    mgr = st.mgr
    b = st.pending_list[0]
    st.pending_arr[b] = False
    st.pending_list = []
    st.pending_count = 0
    st.n_batches += 1
    st.wall += BATCH_FIXED_S + PER_FAULT_S
    while st.free < VABLOCK:
        _evict(st, _pop_victim(st))
    mc, mc_total = _mc_for(st, VABLOCK)
    mgr.cost.add(mc)
    st.wall += mc_total
    st.n_migrations += 1
    st.bytes_migrated += VABLOCK
    if not st.res[b]:
        st.res[b] = True
        st.seq[b] = st.counter
        st.counter += 1
    st.time[b] = st.wall
    st.free -= VABLOCK
    if mgr.profile:
        rid = mgr._rid_of_block(b)
        mgr.events.append(Event(st.wall, "mig", rid,
                                mgr.space.ranges[rid].alloc_id, VABLOCK))


def _evictable(st: _UVMState) -> np.ndarray:
    """Residency mask minus pinned blocks: a block shared with a pinned
    range can fault back into residency while still pinned, and the
    scalar `_lru_victim` skips exactly those."""
    return st.res & ~st.pinned if st.n_pinned else st.res


def _pop_victim(st: _UVMState) -> int:
    """Oldest (min-seq) evictable block — the OrderedDict front in scalar
    terms.  One O(nblocks) masked argmin; evictions are far rarer than
    touches, and this has no per-touch bookkeeping to keep fresh."""
    ev = _evictable(st)
    masked = np.where(ev, st.seq, _NO_SEQ)
    v = int(masked.argmin())
    if not ev[v]:
        raise RuntimeError("UVM: all resident blocks pinned")
    return v


def _evict(st: _UVMState, b: int) -> None:
    mgr = st.mgr
    if st.n_dirty and st.dirty[b]:
        w = mgr._mc_block_total
        mgr.cost.alloc += w
        st.evict_cost_total += w
        st.bytes_evicted += VABLOCK
        st.dirty[b] = False
        st.n_dirty -= 1
    else:
        w = mgr._mc_block.cpu_unmap
        mgr.cost.cpu_unmap += w
    st.wall += w
    st.res[b] = False
    st.free += VABLOCK
    st.n_evictions += 1
    if mgr.profile:
        rid = mgr._rid_of_block(b)
        mgr.events.append(Event(st.wall, "evt", rid,
                                mgr.space.ranges[rid].alloc_id, VABLOCK))


def _writeback(st: _UVMState, rid: int) -> None:
    mgr = st.mgr
    _service(st)
    for b in st.blocks[rid].tolist():
        if st.res[b]:
            w = mgr._mc_block_total
            mgr.cost.add(mgr._mc_block)
            st.writeback_cost_total += w
            st.wall += w
            st.res[b] = False
            if st.n_dirty and st.dirty[b]:
                st.dirty[b] = False
                st.n_dirty -= 1
            st.free += VABLOCK
            st.n_writebacks += 1
            st.bytes_writeback += VABLOCK
            if mgr.profile:
                r = mgr._rid_of_block(b)
                mgr.events.append(Event(st.wall, "wb", r,
                                        mgr.space.ranges[r].alloc_id,
                                        VABLOCK))

"""Compiled-trace engine — the fast execution tier for the simulators.

`apply_trace` walks a workload trace one op at a time through
`SVMManager.touch`, paying full Python dispatch (dataclass construction,
method calls, attribute chasing) on every op.  Reproducing one paper figure
sweeps the Table-2 suite across DOS points × policies × §4.2 variants, so
that per-op loop dominates `benchmarks/run.py` wall time.

This module lowers a trace **once** into flat NumPy op arrays
(opcode / rid / concurrency / page-hint / float-arg columns) and executes
them with a batched interpreter:

  * **Columnar compile tier**: Table-2 workloads construct the op columns
    *directly* (`Workload.emit_columns` via `ColumnEmitter` —
    `np.repeat`/`np.tile`/`np.arange` over range-id arrays, no per-op
    generator tuples); `compile_workload` dispatches to it and falls back
    to generator lowering (`compile_trace`) for custom workloads or
    ``max_ops`` truncation.  Compiled traces are immutable after build
    (`CompiledTrace.freeze`) and shared **across sweep points** through an
    in-process LRU (`TraceCache` / the module-level ``TRACE_CACHE``): each
    worker compiles each distinct trace once and replays it across its
    policy / variant / manager points.

  * **Phase A** (structure): a lean, integer-only loop over the touch ops
    of a span determines hits, misses, and the exact victim sequence,
    mutating the live policy/residency state.  Resident hits — the paper's
    97–99 % duplicate/hit common case — cost one set lookup.
  * **Phase B** (accounting): all per-migration float work (five-term cost
    model, wall trajectory, duplicate-fault synthesis, trigger pages,
    profile events) is done vectorised with NumPy.  Sequential float
    accumulation order is preserved bit-for-bit via ``np.cumsum`` (an exact
    left-to-right fold) seeded with the manager's current accumulator
    values, so `summary()` is **byte-identical** to the scalar path.
  * Every §4.2 driver variant runs on the fast tier: deferred granularity
    (``defer_granule``/``defer_k``, per-range fault counters and
    granule-sized non-resident migrations), background pre-eviction
    (``previct_watermark``/``previct_overlap``, folded into the wall
    trajectory and cost ledger at the exact scalar add positions), and
    zero-copy allocations (remote-access costs vectorised in-span instead
    of breaking spans at every zero-copy touch).
  * `UVMManager` runs on its own batched interpreter
    (`repro_torch.core.engine_uvm`): the same `execute_compiled` entry point
    dispatches on manager type.  Unknown manager types replay op-for-op.
  * Boundary ops (writeback / pin / unpin / spill) drop to the scalar
    manager path, op for op.
  * The runtime layer (streaming executor, activation offload, serving
    launcher) drives the engine through `TraceSession`: ops are recorded
    incrementally into the same columns, compiled in segments, and
    replayed against *resumable* manager state — a decode loop compiles
    its per-token trace once and replays it every token.

Equivalence guarantee: for any trace and any manager configuration,
executing the compiled trace leaves the manager with the same `summary()`,
counters, residency set, free bytes, eviction order, and (under `profile`)
the same `events`/`density` lists as `apply_trace`.  Two tolerated
deviations: (1) the *stored* (never read) float timestamps inside LRF/LRU
policy queues are patched to the correct wall values at span flush for all
surviving entries; (2) eviction listeners / `eviction_epoch` fire at span
flush rather than at each eviction's wall time — end-of-run totals are
identical, but a listener sampling `mgr.wall` mid-run sees the span-end
clock (drive the manager via `touch()` for per-eviction timing, as the
streaming executor does).
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import weakref
from collections import OrderedDict
from typing import Iterable, Sequence

import numpy as np

from repro_torch.core.costmodel import (
    CostParams,
    eviction_cost,
    migration_cost,
    zerocopy_cost,
)
from repro_torch.core.policies import LRF, LRU
from repro_torch.core.ranges import PAGE, AddressSpace
from repro_torch.core.svm import DensitySample, Event, SVMManager
from repro_torch.core.uvm import UVMManager

ENGINE_VERSION = "4"

OP_TOUCH = 0
OP_COMPUTE = 1
OP_WRITEBACK = 2
OP_PIN = 3
OP_UNPIN = 4
# spill-until-free boundary op (runtime layer): drain policy victims via
# `SVMManager.spill_oldest(overlap=farg)` until `free >= hint` bytes —
# the eager-spill loop of the activation-offload scheduler, as an op
OP_SPILL = 5

#: trace-op tag -> opcode; the single source of truth for the op
#: vocabulary.  svmlint's opcode-exhaustiveness rule derives its universe
#: from this table (plus the lowering-only "kernel" marker), so growing
#: it flags every dispatch chain that has not learned the new op.
OP_TAGS = {
    "touch": OP_TOUCH,
    "compute": OP_COMPUTE,
    "writeback": OP_WRITEBACK,
    "pin": OP_PIN,
    "unpin": OP_UNPIN,
    "spill": OP_SPILL,
}

# spans shorter than this run through the scalar manager path: the NumPy
# batch setup would cost more than it saves
FAST_SPAN_MIN = 48

_EMPTY_I = np.zeros(0, dtype=np.int64)


@dataclasses.dataclass
class CompiledTrace:
    """A workload trace lowered to flat op columns (lowered once, executed
    many times — e.g. across the policies × variants axes of a sweep)."""

    codes: np.ndarray      # int8   — OP_* opcode per op
    rids: np.ndarray       # int64  — range id (-1 where n/a)
    concs: np.ndarray      # int64  — touch concurrency
    hints: np.ndarray      # int64  — touch page hint
    fargs: np.ndarray      # float64 — compute seconds
    boundaries: np.ndarray  # int64 — indices of writeback/pin/unpin ops
    touch_pos_np: np.ndarray
    touch_rid_np: np.ndarray
    n_ops: int             # source ops consumed (incl. kernel markers)
    # op-index boundaries of the source segments when this trace was
    # built by `concat` (len = n segments + 1); None for plain traces
    seg_bounds: np.ndarray | None = None
    # per-span slices + uniqueness flags, memoised across executions
    span_cache: dict = dataclasses.field(default_factory=dict)
    # lazy python-list mirrors of the touch stream (Phase A iterates
    # lists); built on first execution, not at compile time — a cached
    # trace shared across sweep points converts once
    _touch_pos: list | None = dataclasses.field(
        default=None, repr=False, compare=False)
    _touch_rid: list | None = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def touch_pos(self) -> list:
        if self._touch_pos is None:
            self._touch_pos = self.touch_pos_np.tolist()
        return self._touch_pos

    @property
    def touch_rid(self) -> list:
        if self._touch_rid is None:
            self._touch_rid = self.touch_rid_np.tolist()
        return self._touch_rid

    def __len__(self) -> int:
        return len(self.codes)

    def freeze(self) -> "CompiledTrace":
        """Mark the op columns immutable.  A frozen trace is safe to share
        across sweep points (and cache cross-point): execution only reads
        the columns; the `span_cache` memo stays mutable by design."""
        for arr in (self.codes, self.rids, self.concs, self.hints,
                    self.fargs, self.boundaries, self.touch_pos_np,
                    self.touch_rid_np):
            arr.flags.writeable = False
        if self.seg_bounds is not None:
            self.seg_bounds.flags.writeable = False
        return self

    def copy(self) -> "CompiledTrace":
        """Cheap copy: shares the (immutable) op columns, private
        `span_cache` — for callers that want memo isolation (e.g. driving
        one trace from multiple threads)."""
        return dataclasses.replace(self, span_cache={})

    def relocate(self, delta: int) -> "CompiledTrace":
        """A copy of this trace with every range id shifted by ``delta``.

        Rebases a segment recorded against one block of ranges onto a
        congruent block elsewhere in the same address space (two requests
        of the same architecture planned at different offsets into a
        shared pool): only the rid columns are rewritten — opcodes,
        concurrencies, hints, and float args are shared with the source.
        The caller owns the congruence precondition (same per-op relative
        rid layout; `repro.svm.scheduler` checks plan geometry before
        relocating)."""
        if delta == 0:
            return self.copy()
        rids = self.rids.copy()
        rids[rids >= 0] += delta
        return dataclasses.replace(
            self, rids=rids, touch_rid_np=self.touch_rid_np + delta,
            span_cache={}, _touch_rid=None,
        ).freeze()

    @staticmethod
    def concat(segments: "Sequence[CompiledTrace]") -> "CompiledTrace":
        """One mega-trace = the given segments back-to-back, with the
        per-segment op boundaries recorded in ``seg_bounds``.

        This is the fused-round primitive: a scheduler round's relocated
        per-token segments stitch into a single op-column trace that the
        batched interpreter executes in one pass, and `execute_fused`
        samples the manager counters at each ``seg_bounds`` cut to
        attribute costs back per segment.  Executing the concatenation is
        bit-identical to executing the segments back-to-back (the
        `TraceSession` resumability guarantee), so no recompilation or
        re-derivation happens here — columns concatenate, and the
        derived touch/boundary indices shift by each segment's offset."""
        if not segments:
            raise ValueError("CompiledTrace.concat: no segments")
        offs = np.concatenate(
            ([0], np.cumsum([len(s) for s in segments]))).astype(np.int64)
        return CompiledTrace(
            codes=np.concatenate([s.codes for s in segments]),
            rids=np.concatenate([s.rids for s in segments]),
            concs=np.concatenate([s.concs for s in segments]),
            hints=np.concatenate([s.hints for s in segments]),
            fargs=np.concatenate([s.fargs for s in segments]),
            boundaries=np.concatenate(
                [s.boundaries + o for s, o in zip(segments, offs)]),
            touch_pos_np=np.concatenate(
                [s.touch_pos_np + o for s, o in zip(segments, offs)]),
            touch_rid_np=np.concatenate(
                [s.touch_rid_np for s in segments]),
            n_ops=sum(s.n_ops for s in segments),
            seg_bounds=offs,
        ).freeze()

    def tile(self, reps: int) -> "CompiledTrace":
        """``reps`` copies of this trace back-to-back — ``concat([self] *
        reps)`` without materialising the intermediate list of segment
        references, built from whole-column ``np.tile`` ops.

        This is the multi-round fused primitive: a scheduler window of
        ``reps`` identical rounds replays one round's mega-trace tiled,
        with ``seg_bounds`` repeated at per-copy offsets so cut sampling
        still attributes per original segment per round.  Executing the
        tiling is bit-identical to executing the trace ``reps`` times
        back-to-back (the session resumability guarantee)."""
        if reps < 1:
            raise ValueError("CompiledTrace.tile: reps must be >= 1")
        if reps == 1:
            return self
        n = len(self.codes)
        offs = np.arange(reps, dtype=np.int64) * n
        bounds = self.seg_bounds
        if bounds is None:
            bounds = np.array([0, n], dtype=np.int64)
        # tiled bounds: each copy contributes its interior cuts shifted by
        # its offset; the shared endpoints collapse (copy k's end == copy
        # k+1's start), giving len = reps * (len(bounds) - 1) + 1
        tiled_bounds = np.concatenate(
            [(bounds[:-1][None, :] + offs[:, None]).ravel(),
             [n * reps]]).astype(np.int64)
        out = CompiledTrace(
            codes=np.tile(self.codes, reps),
            rids=np.tile(self.rids, reps),
            concs=np.tile(self.concs, reps),
            hints=np.tile(self.hints, reps),
            fargs=np.tile(self.fargs, reps),
            boundaries=(self.boundaries[None, :] + offs[:, None]).ravel(),
            touch_pos_np=(self.touch_pos_np[None, :]
                          + offs[:, None]).ravel(),
            touch_rid_np=np.tile(self.touch_rid_np, reps),
            n_ops=self.n_ops * reps,
            seg_bounds=tiled_bounds,
        ).freeze()
        # seed the whole-trace span memo from the source's structure:
        # tiling introduces no new rids, so the unique-rid set and each
        # rid's first touch ordinal are the source's (first copy), and
        # repeats make the stream trivially non-unique.  Saves an
        # O(N log N) `np.unique` over the tiled stream — windows are
        # executed once, so nothing would amortise it.  The seeds key on
        # zc_key=None; a zero-copy execution misses them and recomputes.
        if len(self.boundaries) == 0 and len(out.touch_rid_np):
            n_out = len(out.codes)
            out.span_cache[(0, n_out, None)] = [
                None, None, out.touch_pos_np, out.touch_rid_np,
                False, _EMPTY_I, _EMPTY_I]
            u, first_idx = np.unique(self.touch_rid_np, return_index=True)
            out.span_cache[("uniq", 0, n_out, None)] = (
                u, u.tolist(), first_idx)
        return out

    def span(self, s: int, e: int, zc_mask=None, zc_key=None):
        """Touch-stream slice for ops [s, e): a mutable cache cell
        ``[pos_list, rid_list, pos_np, rid_np, rids_unique, zc_pos_np,
        zc_rid_np]``.  Touches on zero-copy ranges (``zc_mask`` indexed by
        rid; ``zc_key`` identifies the zero-copy configuration for
        caching) are split out of the policy-visible stream.  Cached —
        compiled traces are executed many times (policy/variant axes of a
        sweep).  The Python-list mirrors (slots 0/1) materialise lazily
        via `span_lists` — only the sequential Phase-A fallbacks read
        them, and a multi-round window span can hold millions of touches
        the vectorised paths never iterate."""
        key = (s, e, zc_key)
        cached = self.span_cache.get(key)
        if cached is None:
            lo, hi = np.searchsorted(self.touch_pos_np, (s, e))
            pos_np = self.touch_pos_np[lo:hi]
            rid_np = self.touch_rid_np[lo:hi]
            zc_pos = zc_rid = _EMPTY_I
            if zc_mask is not None and len(rid_np):
                zsel = zc_mask[rid_np]
                if zsel.any():
                    zc_pos = pos_np[zsel]
                    zc_rid = rid_np[zsel]
                    keep = ~zsel
                    pos_np = pos_np[keep]
                    rid_np = rid_np[keep]
            uniq = len(np.unique(rid_np)) == len(rid_np)
            cached = [None, None, pos_np, rid_np, uniq, zc_pos, zc_rid]
            self.span_cache[key] = cached
        return cached

    def span_lists(self, s: int, e: int, zc_key=None) -> tuple[list, list]:
        """The (pos_list, rid_list) mirrors of a cached `span` entry,
        materialised on first use and memoised in the cache cell."""
        cached = self.span_cache[(s, e, zc_key)]
        if cached[0] is None:
            cached[0] = cached[2].tolist()
            cached[1] = cached[3].tolist()
        return cached[0], cached[1]

    def touch_columns(self) -> tuple[np.ndarray, np.ndarray]:
        """The whole-trace (op position, rid) touch columns — the access
        log the hot-set estimator (`repro.svm.hotset`) profiles.  The
        returned arrays are the trace's own (frozen) columns; callers
        must treat them as read-only."""
        return self.touch_pos_np, self.touch_rid_np

    def touch_counts(self, minlength: int = 0) -> np.ndarray:
        """Per-rid touch counts over the whole trace, as one `bincount`
        pass over the rid column (index = absolute rid)."""
        if not len(self.touch_rid_np):
            return np.zeros(minlength, dtype=np.int64)
        return np.bincount(self.touch_rid_np, minlength=minlength)


def compile_trace(trace: Iterable, max_ops: int | None = None) -> CompiledTrace:
    """Lower a lazy op trace into flat columns.

    Kernel markers are consumed (they count toward ``max_ops``, matching
    `apply_trace`) but not materialised.
    """
    if max_ops is not None:
        trace = itertools.islice(trace, max_ops)
    codes: list[int] = []
    rids: list[int] = []
    concs: list[int] = []
    hints: list[int] = []
    fargs: list[float] = []
    n_src = 0
    for op in trace:
        n_src += 1
        tag = op[0]
        if tag == "touch":
            codes.append(OP_TOUCH)
            rids.append(op[1])
            concs.append(op[2])
            hints.append(op[3] or 0)
            fargs.append(0.0)
        elif tag == "compute":
            codes.append(OP_COMPUTE)
            rids.append(-1)
            concs.append(0)
            hints.append(0)
            fargs.append(op[1])
        elif tag == "kernel":
            continue
        elif tag == "writeback":
            codes.append(OP_WRITEBACK)
            rids.append(op[1])
            concs.append(0)
            hints.append(0)
            fargs.append(0.0)
        elif tag == "pin":
            codes.append(OP_PIN)
            rids.append(op[1])
            concs.append(0)
            hints.append(0)
            fargs.append(0.0)
        elif tag == "unpin":
            codes.append(OP_UNPIN)
            rids.append(op[1])
            concs.append(0)
            hints.append(0)
            fargs.append(0.0)
        elif tag == "spill":
            codes.append(OP_SPILL)
            rids.append(-1)
            concs.append(0)
            hints.append(op[1])        # bytes that must become free
            fargs.append(op[2])        # overlap fraction
        else:
            raise ValueError(f"unknown trace op {tag!r}")
    return compiled_from_columns(
        np.array(codes, dtype=np.int8),
        np.array(rids, dtype=np.int64),
        np.array(concs, dtype=np.int64),
        np.array(hints, dtype=np.int64),
        np.array(fargs, dtype=np.float64),
        n_src,
    )


def compiled_from_columns(codes: np.ndarray, rids: np.ndarray,
                          concs: np.ndarray, hints: np.ndarray,
                          fargs: np.ndarray, n_ops: int) -> CompiledTrace:
    """Assemble (and freeze) a CompiledTrace from flat op columns — the
    shared tail of generator lowering and columnar emission."""
    touch_mask = codes == OP_TOUCH
    touch_pos_np = np.nonzero(touch_mask)[0]
    touch_rid_np = rids[touch_mask]
    return CompiledTrace(
        codes=codes,
        rids=rids,
        concs=concs,
        hints=hints,
        fargs=fargs,
        boundaries=np.nonzero(codes >= OP_WRITEBACK)[0],
        touch_pos_np=touch_pos_np,
        touch_rid_np=touch_rid_np,
        n_ops=n_ops,
    ).freeze()


_NEG1_I = np.array([-1], dtype=np.int64)   # shared compute-op rid chunk


class ColumnEmitter:
    """Builds the flat op columns directly — the columnar compile tier.

    Table-2 workloads describe their access patterns as vectorised blocks
    (`touches` over a rid array, per-row touch×k+compute `rows`, …)
    instead of yielding per-op generator tuples; `finish()` assembles the
    blocks into a CompiledTrace.  Op-for-op identical to lowering the
    workload's `trace()` generator through `compile_trace` (golden-tested
    in tests/test_columnar_traces.py).

    Hot-loop cost model: *uniform* blocks (`touches`/`compute`/`pins` —
    one opcode/concurrency/hint/farg for the whole block, the shape of
    the per-wave loops) append four Python scalars and a rid array;
    columns for a run of consecutive uniform blocks are materialised with
    one `np.repeat` per column at `finish()`.  Interleaved blocks
    (`rows`, `touch_writeback`) are prebuilt per call."""

    def __init__(self):
        # uniform-block descriptors (parallel lists)
        self._u_code: list[int] = []
        self._u_conc: list[int] = []
        self._u_hint: list[int] = []
        self._u_farg: list[float] = []
        self._u_len: list[int] = []
        self._u_rids: list[np.ndarray] = []
        # ordered assembly plan: ("u", uniform idx) | ("p", 5 columns)
        self._parts: list[tuple] = []
        self.n_ops = 0        # source ops, incl. kernel markers

    def kernel(self) -> None:
        """Kernel-boundary marker: consumed, not materialised (matches
        `compile_trace`), but counted toward ``n_ops``."""
        self.n_ops += 1

    def _uniform(self, code: int, rids: np.ndarray, conc: int, hint: int,
                 farg: float, n: int) -> None:
        self._parts.append(("u", len(self._u_len)))
        self._u_code.append(code)
        self._u_conc.append(conc)
        self._u_hint.append(hint)
        self._u_farg.append(farg)
        self._u_len.append(n)
        self._u_rids.append(rids)
        self.n_ops += n

    def touches(self, rids, conc: int, hint: int = 0) -> None:
        rids = np.asarray(rids, dtype=np.int64)
        if len(rids):
            self._uniform(OP_TOUCH, rids, conc, hint, 0.0, len(rids))

    def compute(self, seconds: float) -> None:
        self._uniform(OP_COMPUTE, _NEG1_I, 0, 0, seconds, 1)

    def pins(self, rids) -> None:
        rids = np.asarray(rids, dtype=np.int64)
        if len(rids):
            self._uniform(OP_PIN, rids, 0, 0, 0.0, len(rids))

    def raw(self, codes, rids, concs, hints, fargs) -> None:
        """Prebuilt column block (already dtype-correct: int8 / int64 ×3 /
        float64) — for fully vectorised irregular patterns.  The arrays
        remain the caller's: `finish` copies them if they would otherwise
        be frozen into the trace."""
        self._parts.append(("p", (codes, rids, concs, hints, fargs), False))
        self.n_ops += len(codes)

    def rows(self, rid_cols, conc: int, fargs, hint: int = 0) -> None:
        """Per-row interleave: k touches (the columns of ``rid_cols``,
        one row per iteration) followed by one compute of ``fargs[i]``."""
        rid_cols = np.asarray(rid_cols, dtype=np.int64)
        n, k = rid_cols.shape
        if n == 0:
            return
        codes = np.full(k + 1, OP_TOUCH, dtype=np.int8)
        codes[k] = OP_COMPUTE
        rids = np.empty((n, k + 1), dtype=np.int64)
        rids[:, :k] = rid_cols
        rids[:, k] = -1
        concs = np.full(k + 1, conc, dtype=np.int64)
        concs[k] = 0
        hints = np.full(k + 1, hint, dtype=np.int64)
        hints[k] = 0
        f = np.zeros((n, k + 1))
        f[:, k] = fargs
        self._parts.append(("p", (np.tile(codes, n), rids.ravel(),
                                  np.tile(concs, n), np.tile(hints, n),
                                  f.ravel()), True))
        self.n_ops += n * (k + 1)

    def touch_writeback(self, rids, conc: int, hint: int = 0) -> None:
        """Per-rid (touch, writeback) pairs — the BFS frontier pattern."""
        rids = np.asarray(rids, dtype=np.int64)
        n = len(rids)
        if n == 0:
            return
        codes = np.empty(2 * n, dtype=np.int8)
        codes[0::2] = OP_TOUCH
        codes[1::2] = OP_WRITEBACK
        concs = np.zeros(2 * n, dtype=np.int64)
        concs[0::2] = conc
        hints = np.zeros(2 * n, dtype=np.int64)
        hints[0::2] = hint
        self._parts.append(("p", (codes, np.repeat(rids, 2), concs, hints,
                                  np.zeros(2 * n)), True))
        self.n_ops += 2 * n

    def _uniform_seg(self, i0: int, i1: int) -> tuple:
        """Materialise uniform blocks [i0, i1) — one repeat per column."""
        lens = np.asarray(self._u_len[i0:i1])
        return (
            np.repeat(np.array(self._u_code[i0:i1], dtype=np.int8), lens),
            (self._u_rids[i0] if i1 - i0 == 1
             else np.concatenate(self._u_rids[i0:i1])),
            np.repeat(np.array(self._u_conc[i0:i1], dtype=np.int64), lens),
            np.repeat(np.array(self._u_hint[i0:i1], dtype=np.int64), lens),
            np.repeat(np.asarray(self._u_farg[i0:i1]), lens),
        )

    def finish(self) -> CompiledTrace:
        segs: list[tuple] = []
        owned = False      # does the last seg own (all of) its arrays?
        parts = self._parts
        i = 0
        while i < len(parts):
            part = parts[i]
            if part[0] == "p":
                segs.append(part[1])
                owned = part[2]
                i += 1
                continue
            j = i
            while j < len(parts) and parts[j][0] == "u":
                j += 1
            i0, i1 = part[1], parts[j - 1][1] + 1
            owned = i1 - i0 > 1    # single block: rid col is the caller's
            segs.append(self._uniform_seg(i0, i1))
            i = j
        if not segs:
            cols = (np.zeros(0, dtype=np.int8), _EMPTY_I.copy(),
                    _EMPTY_I.copy(), _EMPTY_I.copy(), np.zeros(0))
        elif len(segs) == 1:
            # freeze must not flip writeable on caller-held arrays
            cols = segs[0] if owned else tuple(c.copy() for c in segs[0])
        else:
            cols = tuple(np.concatenate([s[c] for s in segs])
                         for c in range(5))
        return compiled_from_columns(*cols, self.n_ops)


class TraceCache:
    """Small in-process LRU of compiled traces.

    Keys are caller-defined (see `repro_torch.core.sweep.trace_key`: the workload
    spec + address-space geometry that fully determine the trace).  Entries
    are frozen CompiledTraces, safe to replay across the policy / variant /
    manager points of a sweep.

    Memory: a live entry pins its op columns *and* its execution memos
    (lazy touch-list mirrors, span cache) — tens of MB for a fine-grained
    million-op trace.  Grid-aware scheduling replays a trace's points
    back-to-back, so a handful of slots suffices; size the LRU to one
    grid's working set and `clear()` to release everything."""

    def __init__(self, maxsize: int = 16):
        self.maxsize = maxsize
        self._d: "OrderedDict[object, CompiledTrace]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key) -> CompiledTrace | None:
        ct = self._d.get(key)
        if ct is None:
            self.misses += 1
            return None
        self._d.move_to_end(key)
        self.hits += 1
        return ct

    def put(self, key, ct: CompiledTrace) -> None:
        self._d[key] = ct
        self._d.move_to_end(key)
        while len(self._d) > self.maxsize:
            self._d.popitem(last=False)

    def clear(self) -> None:
        self._d.clear()
        self.hits = self.misses = 0

    def __len__(self) -> int:
        return len(self._d)


# process-wide default: one per sweep worker, shared by every run_point
TRACE_CACHE = TraceCache()


def compile_workload(workload, space: AddressSpace,
                     max_ops: int | None = None, *,
                     cache: TraceCache | None = None, key=None,
                     columnar: bool = True) -> CompiledTrace:
    """Lower a workload's trace, preferring the columnar tier.

    Table-2 workloads construct the flat op columns directly
    (``emit_columns`` — `np.repeat`/`np.tile`/`np.arange` over range-id
    arrays, no per-op generator tuples); custom workloads, and ``max_ops``
    truncations (which count kernel markers op-for-op), lower the
    generator through `compile_trace`.  With ``cache`` and ``key`` set the
    compiled trace is memoised so sweep points sharing a workload spec
    compile once and replay (`repro_torch.core.sweep.trace_key`)."""
    if cache is not None and key is not None and max_ops is None:
        ct = cache.get(key)
        if ct is None:
            ct = _compile_uncached(workload, space, max_ops, columnar)
            cache.put(key, ct)
        return ct
    return _compile_uncached(workload, space, max_ops, columnar)


def _compile_uncached(workload, space, max_ops, columnar) -> CompiledTrace:
    emit = getattr(workload, "emit_columns", None) if columnar else None
    if emit is not None and max_ops is None:
        return emit(space)
    return compile_trace(workload.trace(space), max_ops=max_ops)


# ------------------------------------------------------------- trace session

class SegmentCache:
    """Keyed LRU of compiled segments **shared across sessions** bound to
    one manager — the cross-request analogue of the cross-point
    `TRACE_CACHE`.

    Entries are stored as ``key -> (rid_base, CompiledTrace)``, where
    ``rid_base`` is the first range id of the block the recording session
    was planned against.  A session looking up the same key from a
    different base receives the segment **relocated** by the rid delta
    (`CompiledTrace.relocate` — one vectorised add over the rid columns
    instead of a re-record + re-compile), which is how N same-architecture
    serving requests planned at different offsets into one shared pool
    replay a single compiled per-token segment.

    Sharing is only sound between congruent rid blocks (identical per-op
    relative layout); publishers guarantee that by keying on the
    architecture *and* its plan geometry (see
    `repro.svm.scheduler.PoolScheduler`)."""

    def __init__(self, cache_size: int = 256):
        self.cache_size = cache_size
        self._segments: "OrderedDict[object, tuple[int, CompiledTrace]]" = \
            OrderedDict()
        self.hits = 0
        self.misses = 0
        self.relocations = 0
        self.concats = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._segments)

    def get(self, key, rid_base: int) -> CompiledTrace | None:
        """Cached segment for ``key`` rebased to ``rid_base`` (LRU
        refreshed), or None."""
        ent = self._segments.get(key)
        if ent is None:
            self.misses += 1
            return None
        self._segments.move_to_end(key)
        self.hits += 1
        base0, ct = ent
        if base0 == rid_base:
            return ct
        self.relocations += 1
        return ct.relocate(rid_base - base0)

    def batch_relocate(self, key,
                       rid_bases: Sequence[int]) -> list[CompiledTrace] | None:
        """One segment for ``key``, rebased to *each* of ``rid_bases`` —
        a whole scheduler round's worth of same-architecture lookups in a
        single cache probe.  Counter contract matches the sequential
        `get` chain exactly: one miss when the key is absent (the caller
        records once and retries for the rest), else one hit per
        requested base and one relocation per base that differs from the
        recorded prototype's."""
        ent = self._segments.get(key)
        if ent is None:
            self.misses += 1
            return None
        self._segments.move_to_end(key)
        self.hits += len(rid_bases)
        base0, ct = ent
        out = []
        for base in rid_bases:
            if base == base0:
                out.append(ct)
            else:
                self.relocations += 1
                out.append(ct.relocate(base - base0))
        return out

    def concat(self, segments: Sequence[CompiledTrace]) -> CompiledTrace:
        """Stitch relocated segments into one fused-round mega-trace
        (`CompiledTrace.concat`), counting the build for `stats()` —
        schedulers memoise the result per block, so ``shared_concats``
        measures distinct round shapes, not rounds."""
        self.concats += 1
        return CompiledTrace.concat(segments)

    def put(self, key, rid_base: int, ct: CompiledTrace) -> None:
        self._segments[key] = (rid_base, ct)
        self._segments.move_to_end(key)
        while len(self._segments) > self.cache_size:
            self._segments.popitem(last=False)
            self.evictions += 1

    def clear(self) -> None:
        self._segments.clear()

    def stats(self) -> dict:
        return {"shared_segments": len(self._segments),
                "shared_lookup_hits": self.hits,
                "shared_lookup_misses": self.misses,
                "shared_relocations": self.relocations,
                "shared_concats": self.concats,
                "shared_evictions": self.evictions}


class TraceSession:
    """Record → compile → replay API for the runtime layer.

    Where `compile_workload` lowers a *complete* trace up front, a session
    records ops **incrementally** into the flat `OP_*` columns, compiles
    them into frozen `CompiledTrace` *segments*, and replays each segment
    against the live manager.  The manager's residency, policy queues,
    ledgers, and clock carry across segment replays — executing segments
    back-to-back is bit-identical to executing their concatenation (every
    accumulator fold is seeded from the manager's current value) — so a
    replay *resumes* where the previous one stopped.

    Segments sealed under a key land in a per-session LRU, which is what
    makes a decode loop cheap: the per-token layer-fetch trace records and
    compiles **once** (first token) and replays as a compiled segment every
    later token (`run`; hits/misses counted).  Sessions bound to one
    manager can additionally share a `SegmentCache` (``shared_cache=``):
    on a local miss, `run` consults the shared cache and — when the hit
    was recorded by a session planned at a different offset into the
    space — relocates the segment to this session's ``rid_base``, so N
    same-architecture serving requests replay a single compiled trace.

    ``scalar=True`` replays segments op-for-op through the manager's own
    `touch`/`advance`/… methods (`_replay`) instead of the batched
    interpreter — the imperative reference path, used by the golden
    equivalence tests.  Both modes execute the *same* recorded op sequence,
    and the engine's equivalence guarantee makes their `summary()` output
    byte-identical.

    Op vocabulary = `apply_trace`'s, plus ``spill(need_bytes, overlap)``
    (`OP_SPILL`): drain `spill_oldest(overlap=…)` victims until ``free >=
    need_bytes`` — the runtime layer's eager-spill loop as an op.  `OP_SPILL`
    is SVM-only (the UVM interpreter rejects it).
    """

    def __init__(self, mgr, *, scalar: bool = False, cache_size: int = 64,
                 shared_cache: SegmentCache | None = None,
                 rid_base: int = 0):
        self.mgr = mgr
        self.scalar = scalar
        self.cache_size = cache_size
        # cross-session segment sharing (multi-tenant serving): `run`
        # consults the shared cache on a local miss, relocating the hit
        # to this session's rid base; fresh seals are published back
        self.shared_cache = shared_cache
        self.rid_base = rid_base
        self._codes: list[int] = []
        self._rids: list[int] = []
        self._concs: list[int] = []
        self._hints: list[int] = []
        self._fargs: list[float] = []
        self._n_src = 0
        self._segments: "OrderedDict[object, CompiledTrace]" = OrderedDict()
        self.cache_hits = 0
        self.cache_misses = 0
        self.shared_hits = 0
        self.segments_sealed = 0
        self.segments_replayed = 0
        self.ops_recorded = 0
        self.ops_replayed = 0

    # ------------------------------------------------------------ recording

    @property
    def pending(self) -> int:
        """Ops recorded but not yet sealed into a segment."""
        return len(self._codes)

    def _op(self, code: int, rid: int, conc: int, hint: int,
            farg: float) -> None:
        self._codes.append(code)
        self._rids.append(rid)
        self._concs.append(conc)
        self._hints.append(hint)
        self._fargs.append(farg)
        self._n_src += 1
        self.ops_recorded += 1

    def touch(self, rid: int, *, concurrency: int = 32,
              page_hint: int = 0) -> None:
        self._op(OP_TOUCH, rid, concurrency, page_hint or 0, 0.0)

    def compute(self, seconds: float) -> None:
        self._op(OP_COMPUTE, -1, 0, 0, seconds)

    def writeback(self, rid: int) -> None:
        self._op(OP_WRITEBACK, rid, 0, 0, 0.0)

    def pin(self, rid: int) -> None:
        self._op(OP_PIN, rid, 0, 0, 0.0)

    def unpin(self, rid: int) -> None:
        self._op(OP_UNPIN, rid, 0, 0, 0.0)

    def spill(self, need_bytes: int, *, overlap: float = 0.0) -> None:
        """Record an eager-spill boundary: at replay, policy victims are
        pre-evicted (`spill_oldest(overlap=…)`) until ``free >=
        need_bytes`` or nothing is evictable."""
        self._op(OP_SPILL, -1, 0, int(need_bytes), overlap)

    def kernel(self) -> None:
        """Kernel-boundary marker: consumed, not materialised (matches
        `compile_trace`), but counted toward the segment's ``n_ops``."""
        self._n_src += 1

    def record(self, ops: Iterable) -> None:
        """Record a batch of `apply_trace`-vocabulary op tuples."""
        for op in ops:
            tag = op[0]
            if tag == "touch":
                self.touch(op[1], concurrency=op[2], page_hint=op[3])
            elif tag == "compute":
                self.compute(op[1])
            elif tag == "kernel":
                self.kernel()
            elif tag == "writeback":
                self.writeback(op[1])
            elif tag == "pin":
                self.pin(op[1])
            elif tag == "unpin":
                self.unpin(op[1])
            elif tag == "spill":
                self.spill(op[1], overlap=op[2])
            else:
                raise ValueError(f"unknown trace op {tag!r}")

    # ------------------------------------------------------ compile / replay

    def seal(self, key=None) -> CompiledTrace:
        """Compile the pending ops into a frozen segment (and clear the
        recording buffer).  With ``key`` the segment enters the session's
        LRU for later `run`/`get` replays."""
        ct = compiled_from_columns(
            np.array(self._codes, dtype=np.int8),
            np.array(self._rids, dtype=np.int64),
            np.array(self._concs, dtype=np.int64),
            np.array(self._hints, dtype=np.int64),
            np.array(self._fargs, dtype=np.float64),
            self._n_src,
        )
        self._codes = []
        self._rids = []
        self._concs = []
        self._hints = []
        self._fargs = []
        self._n_src = 0
        self.segments_sealed += 1
        if key is not None:
            self._cache_put(key, ct)
        return ct

    def _cache_put(self, key, ct: CompiledTrace) -> None:
        """Insert into the session LRU, trimming to ``cache_size``."""
        self._segments[key] = ct
        self._segments.move_to_end(key)
        while len(self._segments) > self.cache_size:
            self._segments.popitem(last=False)

    def get(self, key) -> CompiledTrace | None:
        """Cached segment for ``key`` (LRU-refreshed), or None."""
        ct = self._segments.get(key)
        if ct is not None:
            self._segments.move_to_end(key)
        return ct

    def replay(self, ct: CompiledTrace) -> None:
        """Execute one compiled segment against the manager, resuming from
        its current state."""
        if self.scalar:
            _replay(ct, self.mgr, 0, len(ct))
        else:
            execute_compiled(ct, self.mgr)
        self.segments_replayed += 1
        self.ops_replayed += len(ct)

    def replay_scalar(self, ct: CompiledTrace) -> None:
        """Golden op-for-op replay of one segment, regardless of the
        session's mode.  The chaos layer routes fault-armed tokens here:
        an armed `MigrationError` must surface at the *exact* faulting op
        with the manager untouched past it, which the scalar dispatch
        guarantees unconditionally (the batched tier only guarantees it
        on the snapshot/restore path).  Byte-identical to `replay` when
        nothing raises, by the engine's equivalence contract."""
        _replay(ct, self.mgr, 0, len(ct))
        self.segments_replayed += 1
        self.ops_replayed += len(ct)

    def flush(self, key=None) -> CompiledTrace | None:
        """Seal the pending ops and replay them immediately.  Returns the
        segment (cached under ``key`` if given), or None when nothing was
        pending."""
        if not self._codes and self._n_src == 0:
            return None
        ct = self.seal(key)
        self.replay(ct)
        return ct

    def fetch(self, key, record_fn) -> CompiledTrace:
        """Resolve ``key`` to a compiled segment without executing it:
        local LRU hit, shared-cache relocation, or — on the first
        encounter — record via ``record_fn(session)``, seal, cache, and
        publish.  `run` is fetch + replay; the fused scheduler fetches
        every segment of a round up front and replays their concatenation
        in one batched pass.  Requires an empty recording buffer."""
        if self._codes or self._n_src:   # incl. pending kernel markers
            raise RuntimeError(
                f"TraceSession.fetch({key!r}): {self.pending} recorded "
                "ops pending; flush() them before running a segment")
        ct = self.get(key)
        if ct is None and self.shared_cache is not None:
            ct = self.shared_cache.get(key, self.rid_base)
            if ct is not None:
                # adopt into the local LRU: later tokens replay without
                # another shared lookup (or relocation)
                self.shared_hits += 1
                self._cache_put(key, ct)
        elif ct is not None:
            self.cache_hits += 1
        if ct is None:
            self.cache_misses += 1
            record_fn(self)
            ct = self.seal(key)
            if self.shared_cache is not None:
                self.shared_cache.put(key, self.rid_base, ct)
        return ct

    def run(self, key, record_fn) -> CompiledTrace:
        """The decode-loop primitive: replay the compiled segment cached
        under ``key``, or — on the first encounter — record it via
        ``record_fn(session)``, seal, cache, and replay."""
        ct = self.fetch(key, record_fn)
        self.replay(ct)
        return ct

    def stats(self) -> dict:
        return {
            "segments_sealed": self.segments_sealed,
            "segments_replayed": self.segments_replayed,
            "segment_cache_hits": self.cache_hits,
            "segment_cache_misses": self.cache_misses,
            "segment_shared_hits": self.shared_hits,
            "ops_recorded": self.ops_recorded,
            "ops_replayed": self.ops_replayed,
        }


# --------------------------------------------------------------- cost tables

# per-AddressSpace static tables, shared by every execution over that space
_SPACE_TABLES: "weakref.WeakKeyDictionary[AddressSpace, dict]" = \
    weakref.WeakKeyDictionary()


def _params_tables(size_arr: np.ndarray, params: CostParams,
                   xcost: dict | None = None,
                   zcc: dict | None = None) -> dict:
    usz = np.unique(size_arr)
    # migration_cost is a pure function of (size, params): memoised
    # values are bit-identical to what the scalar path computes fresh
    mcs = [migration_cost(int(s), params) for s in usz.tolist()]
    return {
        "usz": usz,
        "terms": np.array([[m.cpu_unmap, m.sdma_setup, m.alloc,
                            m.cpu_update, m.misc] for m in mcs]),
        "ecs": np.array([eviction_cost(int(s), params)
                         for s in usz.tolist()]),
        "sizeidx": np.searchsorted(usz, size_arr),
        # off-table sizes (deferred granules) and zero-copy touch costs:
        # pure (size, params) memos, carried across table growth
        "xcost": xcost if xcost is not None else {},
        "zcc": zcc if zcc is not None else {},
    }


# one-entry identity memo over (space, params, n_ranges): scheduler rounds
# call `_tables` once per span with the same space and params, so the
# common case skips the weak-dict probe and the params-keyed dict hashes
# entirely.  Holds only a weakref to the space (the strong tables live in
# `_SPACE_TABLES`), so it cannot extend any space's lifetime.
_TABLES_LAST: tuple | None = None


def _tables(space: AddressSpace, params: CostParams) -> dict:
    global _TABLES_LAST
    last = _TABLES_LAST
    n = len(space.ranges)
    if (last is not None and last[0]() is space and last[1] is params
            and last[2] == n):
        return last[3]
    tab = _SPACE_TABLES.get(space)
    if tab is None:
        size_arr = np.array([r.end - r.start for r in space.ranges],
                            dtype=np.int64)
        tab = {
            "n_ranges": n,
            "sizes": size_arr.tolist(),
            "size_arr": size_arr,
            "alloc_ids": [r.alloc_id for r in space.ranges],
            "pages": np.array([r.start // PAGE for r in space.ranges],
                              dtype=np.int64),
            "params": {},
            "merged": {},
        }
        _SPACE_TABLES[space] = tab
    elif tab["n_ranges"] != n:
        # the space only ever *grows* (AddressSpace.alloc extends the
        # range list), so admissions mid-run extend the static columns
        # with the new tail instead of rebuilding O(n_ranges) tables
        new = space.ranges[tab["n_ranges"]:]
        tail = np.array([r.end - r.start for r in new], dtype=np.int64)
        tab["n_ranges"] = n
        tab["size_arr"] = np.concatenate([tab["size_arr"], tail])
        tab["sizes"].extend(tail.tolist())
        tab["alloc_ids"].extend(r.alloc_id for r in new)
        tab["pages"] = np.concatenate(
            [tab["pages"],
             np.array([r.start // PAGE for r in new], dtype=np.int64)])
        tab.pop("zc_masks", None)      # stale length
        for p, pp in tab["params"].items():
            tab["params"][p] = _params_tables(
                tab["size_arr"], p, pp["xcost"], pp["zcc"])
        tab["merged"].clear()
    merged = tab["merged"].get(params)
    if merged is None:
        per_params = tab["params"].get(params)
        if per_params is None:
            per_params = _params_tables(tab["size_arr"], params)
            tab["params"][params] = per_params
        merged = {**tab, **per_params}
        tab["merged"][params] = merged
    _TABLES_LAST = (weakref.ref(space), params, n, merged)
    return merged


def _terms_for_sizes(tab: dict, m_nb: np.ndarray,
                     params: CostParams) -> np.ndarray:
    """(len(m_nb), 5) cost terms for arbitrary per-miss byte counts —
    deferred-granularity migrations are granule-sized, off the range-size
    table.  Memoised per unique size, bit-identical to the scalar path's
    fresh `migration_cost` calls."""
    xc = tab["xcost"]
    usz2, inv = np.unique(m_nb, return_inverse=True)
    tarr = np.empty((len(usz2), 5))
    for j, sz in enumerate(usz2.tolist()):
        t = xc.get(sz)
        if t is None:
            m = migration_cost(sz, params)
            t = (m.cpu_unmap, m.sdma_setup, m.alloc, m.cpu_update, m.misc)
            xc[sz] = t
        tarr[j] = t
    return tarr[inv]


def _zc_costs(tab: dict, zc_sizes: np.ndarray,
              params: CostParams) -> np.ndarray:
    zcc = tab["zcc"]
    usz, inv = np.unique(zc_sizes, return_inverse=True)
    carr = np.empty(len(usz))
    for j, sz in enumerate(usz.tolist()):
        c = zcc.get(sz)
        if c is None:
            c = zerocopy_cost(sz, params)
            zcc[sz] = c
        carr[j] = c
    return carr[inv]


# ----------------------------------------------------------------- execution

def execute_compiled(ct: CompiledTrace, mgr) -> None:
    """Apply a compiled trace to a manager; equivalent to `apply_trace`.

    Dispatches on the manager type: `SVMManager` and `UVMManager` execute
    on their batched interpreters; any other manager replays op-for-op
    through its own `touch`/`advance`/... methods."""
    if type(mgr) is SVMManager:
        _execute_svm(ct, mgr)
    elif type(mgr) is UVMManager:
        from repro_torch.core.engine_uvm import execute_compiled_uvm
        execute_compiled_uvm(ct, mgr)
    else:
        _replay(ct, mgr, 0, len(ct))


def _zc_setup(mgr: SVMManager) -> tuple:
    """(zc_mask, zc_key) for the manager's zero-copy configuration —
    the per-execution preamble shared by `_execute_svm`/`execute_fused`."""
    zc_mask = zc_key = None
    if mgr.zero_copy_allocs:
        key = frozenset(mgr.zero_copy_allocs)
        tab = _SPACE_TABLES.get(mgr.space)
        masks = tab.setdefault("zc_masks", {}) if tab is not None else {}
        zc_mask = masks.get(key)
        if zc_mask is None:
            aid_arr = np.array([r.alloc_id for r in mgr.space.ranges])
            zc_mask = np.isin(aid_arr, list(key))
            masks[key] = zc_mask
        if zc_mask.any():
            zc_key = key
        else:
            zc_mask = None
    return zc_mask, zc_key


def _execute_svm(ct: CompiledTrace, mgr: SVMManager) -> None:
    zc_mask, zc_key = _zc_setup(mgr)
    pos = 0
    for b in ct.boundaries.tolist():
        _run_span(ct, mgr, pos, b, zc_mask, zc_key)
        _exec_boundary(ct, mgr, b)
        pos = b + 1
    _run_span(ct, mgr, pos, len(ct), zc_mask, zc_key)


def _read_counters(mgr, out: np.ndarray, ci: int) -> None:
    out[ci, 0] = mgr.wall
    out[ci, 1] = mgr.n_migrations
    out[ci, 2] = mgr.n_evictions
    out[ci, 3] = mgr.bytes_migrated
    out[ci, 4] = mgr.bytes_evicted


def execute_fused(ct: CompiledTrace, mgr, cuts) -> np.ndarray:
    """Execute ``ct`` exactly like `execute_compiled`, additionally
    snapshotting the five attribution counters — wall clock, migrations,
    evictions, bytes migrated, bytes evicted — after each op index in
    ``cuts`` (sorted, ascending; typically a concatenated round's
    ``seg_bounds[1:]``).  Returns a ``(len(cuts), 5)`` float64 array.

    This is the fused-round entry point: a scheduler replays a whole
    round's concatenated segments in **one** batched-interpreter pass and
    attributes per-request deltas from the cut snapshots instead of N
    manager round-trips.  The snapshots are byte-identical to reading the
    manager between back-to-back `execute_compiled` calls at the same
    boundaries: mid-span wall values come from the same exact `np.cumsum`
    trajectory Phase B folds the wall with, and the count/byte columns
    are integer prefix sums of Phase A's miss/victim streams.  SVM-only
    (the UVM interpreter has no span sampling)."""
    if type(mgr) is not SVMManager:
        raise TypeError("execute_fused requires an SVMManager, got "
                        f"{type(mgr).__name__}")
    cuts = np.asarray(cuts, dtype=np.int64)
    out = np.empty((len(cuts), 5))
    zc_mask, zc_key = _zc_setup(mgr)
    pos = 0
    ci = 0
    for b in ct.boundaries.tolist():
        ci = _run_span_sampled(ct, mgr, pos, b, zc_mask, zc_key,
                               cuts, out, ci)
        _exec_boundary(ct, mgr, b)
        pos = b + 1
    ci = _run_span_sampled(ct, mgr, pos, len(ct), zc_mask, zc_key,
                           cuts, out, ci)
    while ci < len(cuts):          # cuts at (or past) the trace end
        _read_counters(mgr, out, ci)
        ci += 1
    return out


def _run_span_sampled(ct, mgr, s, e, zc_mask, zc_key, cuts, out, ci) -> int:
    """`_run_span` plus counter snapshots at the ``cuts`` that land in
    ``(s, e]`` (cuts ≤ s read the live manager directly — state is
    current there).  Returns the index of the first unconsumed cut."""
    n_cuts = len(cuts)
    while ci < n_cuts and cuts[ci] <= s:
        _read_counters(mgr, out, ci)
        ci += 1
    if e <= s:
        return ci
    hi = ci
    while hi < n_cuts and cuts[hi] <= e:
        hi += 1
    if hi == ci:                   # no cuts in this span
        _run_span(ct, mgr, s, e, zc_mask, zc_key)
        return ci
    if e - s < FAST_SPAN_MIN:
        # short span: scalar replay split at the cut points — exact
        p = s
        for j in range(ci, hi):
            c = int(cuts[j])
            _replay(ct, mgr, p, c)
            _read_counters(mgr, out, j)
            p = c
        _replay(ct, mgr, p, e)
        return hi
    pre = (mgr.wall, mgr.n_migrations, mgr.n_evictions,
           mgr.bytes_migrated, mgr.bytes_evicted)
    tab, struct, zc_pos, zc_rid = _span_phase_a(ct, mgr, s, e,
                                                zc_mask, zc_key)
    op_end = _phase_b(ct, mgr, s, e, tab, struct, zc_pos, zc_rid, zc_key)
    _sample_cuts(tab, struct, pre, op_end, cuts[ci:hi], out[ci:hi], s)
    return hi


def _sample_cuts(tab, st: "SpanStruct", pre, op_end, cuts, out, s) -> None:
    """Counter snapshots at in-span cut positions, from Phase B's wall
    trajectory and integer prefix sums over Phase A's miss/victim
    streams.  ``op_end[k]`` is the wall after relative op ``k`` — the
    same float the scalar path's accumulator holds there — and every
    count/byte column is an exact integer cumsum, so each sampled row
    is byte-identical to a live manager read at that op boundary."""
    out[:, 0] = op_end[cuts - s - 1]
    m_pos = np.asarray(st.m_pos, dtype=np.int64)
    M = len(m_pos)
    if M == 0:
        out[:, 1:] = pre[1:]
        return
    ks = np.searchsorted(m_pos, cuts, side="left")
    out[:, 1] = pre[1] + ks
    nev = np.asarray(st.nev, dtype=np.int64)
    vend = np.concatenate(([0], np.cumsum(nev)))
    if st.m_nbytes is not None:
        m_nb = np.abs(np.asarray(st.m_nbytes, dtype=np.int64))
    else:
        m_nb = tab["size_arr"][np.asarray(st.m_rid, dtype=np.int64)]
    cmb = np.concatenate(([0], np.cumsum(m_nb)))
    out[:, 3] = pre[3] + cmb[ks]
    if len(st.victims):
        v_sz = tab["size_arr"][np.asarray(st.victims, dtype=np.int64)]
        cvb = np.concatenate(([0], np.cumsum(v_sz)))
    else:
        cvb = np.zeros(1, dtype=np.int64)
    ev = vend[ks]
    ev_bytes = cvb[ev]
    if st.pv_counts is not None:
        pvc_cum = np.concatenate(
            ([0], np.cumsum(np.asarray(st.pv_counts, dtype=np.int64))))
        if st.pv_victims:
            pv_sz = tab["size_arr"][np.asarray(st.pv_victims,
                                               dtype=np.int64)]
            pvb_cum = np.concatenate(([0], np.cumsum(pv_sz)))
        else:
            pvb_cum = np.zeros(1, dtype=np.int64)
        ev = ev + pvc_cum[ks]
        ev_bytes = ev_bytes + pvb_cum[pvc_cum[ks]]
    out[:, 2] = pre[2] + ev
    out[:, 4] = pre[4] + ev_bytes


def _exec_boundary(ct: CompiledTrace, mgr, k: int) -> None:
    code = ct.codes[k]
    rid = int(ct.rids[k])
    if code == OP_WRITEBACK:
        mgr.writeback(rid)
    elif code == OP_PIN:
        mgr.pin(rid)
    elif code == OP_UNPIN:
        mgr.unpin(rid)
    elif code == OP_SPILL:
        need = int(ct.hints[k])
        overlap = float(ct.fargs[k])
        while mgr.free < need and mgr.spill_oldest(overlap=overlap) \
                is not None:
            pass
    else:
        raise ValueError(f"opcode {int(code)} is not a boundary op")


def _replay(ct: CompiledTrace, mgr, s: int, e: int) -> None:
    """Scalar fallback: dispatch ops one by one through the manager."""
    codes = ct.codes
    rids = ct.rids
    for k in range(s, e):
        code = codes[k]
        if code == OP_TOUCH:
            mgr.touch(int(rids[k]), concurrency=int(ct.concs[k]),
                      page_hint=int(ct.hints[k]))
        elif code == OP_COMPUTE:
            mgr.advance(float(ct.fargs[k]))
        else:
            _exec_boundary(ct, mgr, k)


@dataclasses.dataclass
class SpanStruct:
    """Phase-A output for one span: the structural facts Phase B turns
    into float accounting."""

    m_pos: list | np.ndarray        # op index per miss
    m_rid: list | np.ndarray        # rid per miss
    nev: np.ndarray                 # blocking evictions per miss
    victims: list                   # blocking victims, flattened in order
    lastpos: dict | None = None     # LRU: rid -> last touch op index
    # per-miss migrated bytes, None = full range sizes; a NEGATIVE entry
    # is a deferred granule migration (the range did not become resident)
    m_nbytes: list | None = None
    pv_counts: list | None = None   # pre-evictions per miss; None = none
    pv_victims: list | None = None  # pre-eviction victims, flattened


def _run_span(ct: CompiledTrace, mgr, s: int, e: int,
              zc_mask, zc_key) -> None:
    if e <= s:
        return
    if e - s < FAST_SPAN_MIN:
        _replay(ct, mgr, s, e)
        return
    tab, struct, zc_pos, zc_rid = _span_phase_a(ct, mgr, s, e,
                                                zc_mask, zc_key)
    _phase_b(ct, mgr, s, e, tab, struct, zc_pos, zc_rid, zc_key)


def _span_phase_a(ct: CompiledTrace, mgr, s: int, e: int, zc_mask, zc_key):
    """Phase-A dispatch for one vectorisable span: resolve the span's
    hit/miss/victim structure (mutating residency/policy state) and hand
    back everything Phase B needs.  Returns (tab, struct, zc_pos, zc_rid).
    """
    _, _, tpos_np, trid_np, uniq, zc_pos, zc_rid = \
        ct.span(s, e, zc_mask, zc_key)
    tab = _tables(mgr.space, mgr.params)
    defer_on = bool(mgr.defer_granule) and mgr.defer_k > 0
    pw = mgr.previct_watermark
    struct = None
    if type(mgr.policy) is LRF and len(trid_np) and not defer_on:
        # vectorised LRF fast paths.  The span's unique-rid structure is
        # static per (s, e, zc_key), so it memoises in the span cache;
        # only the residency probe runs per execution.
        ukey = ("uniq", s, e, zc_key)
        uc = ct.span_cache.get(ukey)
        if uc is None:
            u, first_idx = np.unique(trid_np, return_index=True)
            uc = (u, u.tolist(), first_idx)
            ct.span_cache[ukey] = uc
        u, u_list, first_idx = uc
        resident = mgr.resident
        mask = None
        if len(u_list) > 256:
            # wide spans: a residency bitmap beats per-rid set probes
            mask = np.zeros(tab["n_ranges"], dtype=bool)
            if resident:
                mask[np.fromiter(resident, dtype=np.int64,
                                 count=len(resident))] = True
            miss_u = ~mask[u]
        else:
            miss_u = np.fromiter((r not in resident for r in u_list),
                                 dtype=bool, count=len(u_list))
        need = int(tab["size_arr"][u[miss_u]].sum())
        if need <= mgr.free and (
                pw <= 0.0 or need == 0
                or mgr.free - need >= pw * mgr.capacity):
            # no eviction possible — and, under a pre-eviction watermark,
            # free stays above the watermark at every prefix (free only
            # shrinks, monotonically, to its final value), so no previcts
            # fire either: misses are exactly the first touches of the
            # non-resident ranges, hits are LRF no-ops.  Sound with pinned
            # ranges too: pinned ⊆ resident (pin migrates first; every
            # eviction path picks victims from the policy queue, which
            # excludes pinned), so no miss rid is ever pinned and the
            # queue inserts match `_phase_a_lrf` exactly.
            struct = _phase_a_lrf_noevict(
                mgr, tpos_np, trid_np, first_idx[miss_u], need)
        elif pw <= 0.0 and not mgr.pinned:
            if mask is None:
                mask = np.zeros(tab["n_ranges"], dtype=bool)
                if resident:
                    mask[np.fromiter(resident, dtype=np.int64,
                                     count=len(resident))] = True
            # eviction-pressure span: solve the FIFO dynamics in closed
            # form under the every-touch-misses hypothesis and validate it
            # vectorised (holds for linear streaming AND full thrash);
            # falls back to the sequential loop on mixed hit/miss spans
            prev = None
            if not uniq:
                prev = ct.span_cache.get(("prev", s, e, zc_key))
                if prev is None:
                    order = np.argsort(trid_np, kind="stable")
                    srid = trid_np[order]
                    prev = np.full(len(trid_np), -1, dtype=np.int64)
                    same = srid[1:] == srid[:-1]
                    prev[order[1:][same]] = order[:-1][same]
                    ct.span_cache[("prev", s, e, zc_key)] = prev
            struct = _phase_a_lrf_streaming(
                mgr, tpos_np, ct.span_lists(s, e, zc_key)[1], trid_np,
                tab, mask, prev)
        elif pw <= 0.0:
            # pinned span under eviction pressure: sorted-array sweep
            # over the miss stream (closed-form FIFO eviction counts via
            # cumsum + searchsorted); returns None — falling through to
            # the sequential heap walk — when a victim re-touch or
            # this-span eviction demand breaks its preconditions
            struct = _phase_a_lrf_sweep(
                mgr, tpos_np, u, first_idx, miss_u, tab)
    if struct is None:
        # the sequential passes mutate live state as they go; snapshot so
        # a mid-span device-full error can be replayed through the scalar
        # path, which raises with fully consistent partial manager state
        tpos, trid = ct.span_lists(s, e, zc_key)
        snap = _snapshot(mgr)
        try:
            if defer_on or pw > 0.0:
                struct = _phase_a_var(mgr, tpos, trid, tab)
            elif type(mgr.policy) is LRF:
                if mgr.pinned:
                    # pinned span under eviction pressure (the no-evict
                    # fast path above handles the hit-dominated steady
                    # state); the heap variant skips hit runs instead of
                    # walking every touch
                    struct = _phase_a_lrf_runs(ct, mgr, s, e, zc_key,
                                               tpos_np, trid_np, tab)
                else:
                    struct = _phase_a_lrf(mgr, tpos, trid, tab)
            else:
                struct = _phase_a_generic(mgr, tpos, trid, tab)
        except RuntimeError:
            _restore(mgr, snap)
            _replay(ct, mgr, s, e)    # re-raises at the same op, scalar
            raise                     # unreachable: replay must raise too
    return tab, struct, zc_pos, zc_rid


# ------------------------------------------------------ phase A — structure

def _snapshot(mgr):
    policy = mgr.policy
    q = getattr(policy, "_q", None)
    if q is not None:
        pstate = ("q", list(q.items()))
    elif getattr(policy, "_order", None) is not None:
        pstate = ("order", list(policy._order.items()))
    elif getattr(policy, "_set", None) is not None:
        pstate = ("set", list(policy._set), policy._rng.getstate())
    else:
        import copy
        pstate = ("deep", copy.deepcopy(policy))
    return set(mgr.resident), mgr.free, dict(mgr._defer_count), pstate


def _restore(mgr, snap):
    resident, free, defer_count, pstate = snap
    mgr.resident.clear()
    mgr.resident.update(resident)
    mgr.free = free
    mgr._defer_count.clear()
    mgr._defer_count.update(defer_count)
    policy = mgr.policy
    if pstate[0] == "q":
        policy._q.clear()
        policy._q.update(pstate[1])
    elif pstate[0] == "order":
        policy._order.clear()
        policy._order.update(pstate[1])
    elif pstate[0] == "set":
        policy._set.clear()
        policy._set.update((r, None) for r in pstate[1])
        policy._rng.setstate(pstate[2])
    else:
        mgr.policy = pstate[1]


def _phase_a_lrf_noevict(mgr, tpos_np, trid_np, miss_first_idx, need):
    """Vectorised Phase A for LRF spans that cannot evict (the touched
    working set fits in free bytes): misses are the first occurrences of
    non-resident rids, in touch order; every other touch is a hit, which
    LRF ignores by construction."""
    idx = np.sort(miss_first_idx)
    m_rid = trid_np[idx]
    m_pos = tpos_np[idx]
    rid_list = m_rid.tolist()
    mgr.free -= need
    mgr.resident.update(rid_list)
    q = mgr.policy._q
    for rid in rid_list:
        q[rid] = 0.0
    return SpanStruct(m_pos, m_rid, np.zeros(len(idx), dtype=np.int64), [])


def _phase_a_lrf_streaming(mgr, tpos_np, trid, trid_np, tab, mask, prev):
    """Closed-form Phase A for all-miss spans under LRF.

    Hypothesis: every touch in the span is a miss.  LRF then degenerates
    to FIFO, the victim stream is exactly [current queue] + [migrated
    ranges, in touch order], and each migration's eviction count falls out
    of one ``searchsorted`` over the two byte cumsums.  The hypothesis is
    then validated vectorised — every re-touch (``prev``) and every
    initially-resident touch must have been evicted before its hit check —
    covering both linear streaming (Category I) and full cyclic thrash
    (Categories II/III at high DOS).  Returns None (no state mutated) when
    the span actually contains hits or would exhaust evictable ranges.
    """
    q = mgr.policy._q
    sizes_arr = tab["size_arr"]
    n = len(trid_np)
    n_q0 = len(q)
    if n_q0:
        cand = np.concatenate([np.fromiter(q, dtype=np.int64, count=n_q0),
                               trid_np])
    else:
        cand = trid_np
    cv = np.concatenate(([0], np.cumsum(sizes_arr[cand])))
    cs = np.cumsum(sizes_arr[trid_np])
    e_arr = np.searchsorted(cv, cs - mgr.free, side="left")
    if (e_arr > n_q0 + np.arange(n)).any():
        return None        # would need to evict not-yet-migrated ranges
    # eviction frontier *before* each touch's hit check
    e_prev = np.empty(n, dtype=np.int64)
    e_prev[0] = 0
    e_prev[1:] = e_arr[:-1]
    if prev is not None:
        nf = prev >= 0
        if nf.any() and (n_q0 + prev[nf] >= e_prev[nf]).any():
            return None    # a re-touched range would still be resident
    if n_q0:
        r0 = mask[trid_np]
        if prev is not None:
            r0 &= prev < 0
        ks = np.nonzero(r0)[0]
        if len(ks):
            q0pos = {rid: i for i, rid in enumerate(q)}
            for k, e in zip(ks.tolist(), e_prev[ks].tolist()):
                p = q0pos.get(trid[k])
                if p is None or p >= e:
                    return None   # an initially-resident touch would hit

    n_evt = int(e_arr[-1])
    victims = cand[:n_evt].tolist()
    nev = e_arr.copy()
    nev[1:] -= e_arr[:-1]

    # state update: the survivors are exactly cand[n_evt:], in order;
    # surviving pre-existing queue entries keep their timestamps
    mgr.free = int(mgr.free + int(cv[n_evt]) - int(cs[-1]))
    old_items = list(q.items())[n_evt:] if n_evt < n_q0 else []
    q.clear()
    for rid, t in old_items:
        q[rid] = t
    for rid in trid[max(n_evt - n_q0, 0):]:
        q[rid] = 0.0
    resident = mgr.resident
    resident.clear()
    resident.update(q)
    return SpanStruct(tpos_np, trid_np, nev, victims)


def _phase_a_lrf(mgr, tpos, trid, tab):
    """Integer-only hit/miss/victim resolution for the default LRF policy.

    Operates directly on the live policy queue (an OrderedDict whose key
    order IS the FIFO victim order); float timestamps are patched in
    phase B.  A miss rid is never queued (queue ⊆ resident), so insertion
    is a plain assignment.
    """
    q = mgr.policy._q
    popitem = q.popitem
    resident = mgr.resident
    res_add = resident.add
    res_disc = resident.discard
    pinned = mgr.pinned
    sizes = tab["sizes"]
    free = mgr.free
    miss_pos: list[int] = []
    miss_rid: list[int] = []
    vends: list[int] = []
    victims: list[int] = []
    mp = miss_pos.append
    ma = miss_rid.append
    na = vends.append
    va = victims.append
    n_victims = 0
    for i, rid in enumerate(trid):
        if rid in resident:
            continue
        nbytes = sizes[rid]
        while free < nbytes:
            if not q:
                raise RuntimeError(
                    "SVM: device full of pinned/unevictable ranges "
                    f"(free={free}, need more; pinned={len(pinned)})")
            victim, _ = popitem(False)
            res_disc(victim)
            free += sizes[victim]
            va(victim)
            n_victims += 1
        free -= nbytes
        res_add(rid)
        if rid not in pinned:
            q[rid] = 0.0
        mp(tpos[i])
        ma(rid)
        na(n_victims)
    mgr.free = free
    nev = np.diff(np.array(vends, dtype=np.int64), prepend=0)
    return SpanStruct(miss_pos, miss_rid, nev, victims)


def _phase_a_lrf_sweep(mgr, tpos_np, u, first_idx, miss_u, tab):
    """Sorted-array Phase A for pinned LRF spans under eviction pressure.

    When no evicted victim is touched anywhere in the span, the miss
    stream is exactly the first touches of the non-resident rids in
    ordinal order, and the victim stream is a prefix of the policy
    queue's FIFO order — so the per-miss eviction counts solve in closed
    form: with ``D[j]`` the cumulative miss bytes beyond the initial
    free pool and ``Vcum`` the queue's cumulative victim sizes, miss
    ``j`` needs the smallest ``k`` with ``Vcum[k-1] >= D[j]`` victims
    (`searchsorted`), which reproduces the scalar ``while free < nbytes``
    loop integer-exactly.  Sound with pinned ranges for the same reason
    as the no-evict path: pinned ⊆ resident, so no miss rid is pinned
    and every queue insert matches `_phase_a_lrf`.

    Returns None — callers fall through to the heap walk — when the
    span's own eviction demand reaches past the initial queue (a rid
    missed in-span would become a victim) or any victim has an in-span
    touch (its eviction would turn a later hit into a miss).
    """
    size_arr = tab["size_arr"]
    fi = first_idx[miss_u]
    order = np.argsort(fi)
    fi = fi[order]
    mrid = u[miss_u][order]
    if not len(mrid):
        return SpanStruct([], [], _EMPTY_I, [])
    D = np.cumsum(size_arr[mrid]) - mgr.free
    q = mgr.policy._q
    L = len(q)
    if int(D[-1]) > 0:
        if L == 0:
            return None                      # device full: heap path raises
        vq = np.fromiter(q.keys(), dtype=np.int64, count=L)
        Vcum = np.cumsum(size_arr[vq])
        kl = int(np.searchsorted(Vcum, D[-1], side="left")) + 1
        if kl > L:
            return None                      # demand reaches this span's misses
        # victim re-touch check: u is sorted, so one searchsorted probe
        vk = vq[:kl]
        hit = np.searchsorted(u, vk)
        if np.any((hit < len(u)) & (u[np.minimum(hit, len(u) - 1)] == vk)):
            return None
        K = np.where(D > 0, np.searchsorted(Vcum, D, side="left") + 1, 0)
        victims = vk.tolist()
        freed = int(Vcum[kl - 1])
    else:
        K = np.zeros(len(mrid), dtype=np.int64)
        victims = []
        freed = 0
    resident = mgr.resident
    for v in victims:
        del q[v]
    resident.difference_update(victims)
    mlist = mrid.tolist()
    resident.update(mlist)
    for rid in mlist:
        q[rid] = 0.0
    mgr.free = freed - int(D[-1])
    nev = np.diff(K, prepend=0)
    return SpanStruct(tpos_np[fi].tolist(), mlist, nev, victims)


def _phase_a_lrf_runs(ct, mgr, s, e, zc_key, tpos_np, trid_np, tab):
    """Heap-of-next-touches Phase A for LRF spans with pinned ranges.

    `_phase_a_lrf` walks every touch; on scheduler spans with pinned hot
    leaves almost all touches are hits, and an LRF hit is a no-op.  This
    variant visits only the misses: a min-heap keyed by span-local touch
    ordinal holds, for each non-resident rid with a future touch, its
    next touch.  A pop is always a miss (rids become resident only via
    pops, victims are re-pushed at their next future touch), and pops are
    strictly increasing in ordinal, so the miss/victim stream — and every
    state mutation — is identical to the sequential walk.
    """
    n = len(trid_np)
    if n == 0:
        return SpanStruct([], [], _EMPTY_I, [])
    key = ("runs", s, e, zc_key)
    positions = ct.span_cache.get(key)
    if positions is None:         # rid -> ascending touch ordinals
        order = np.argsort(trid_np, kind="stable")
        srid = trid_np[order]
        bounds = np.concatenate(
            ([0], np.nonzero(srid[1:] != srid[:-1])[0] + 1, [n]))
        positions = {int(srid[a]): order[a:b]
                     for a, b in zip(bounds[:-1], bounds[1:])}
        ct.span_cache[key] = positions
    resident = mgr.resident
    heap = [(int(fi[0]), rid) for rid, fi in positions.items()
            if rid not in resident]
    heapq.heapify(heap)
    q = mgr.policy._q
    popitem = q.popitem
    res_add = resident.add
    res_disc = resident.discard
    pinned = mgr.pinned
    sizes = tab["sizes"]
    free = mgr.free
    miss_pos: list[int] = []
    miss_rid: list[int] = []
    vends: list[int] = []
    victims: list[int] = []
    n_victims = 0
    while heap:
        i, rid = heapq.heappop(heap)
        nbytes = sizes[rid]
        while free < nbytes:
            if not q:
                raise RuntimeError(
                    "SVM: device full of pinned/unevictable ranges "
                    f"(free={free}, need more; pinned={len(pinned)})")
            victim, _ = popitem(False)
            res_disc(victim)
            free += sizes[victim]
            victims.append(victim)
            n_victims += 1
            vpos = positions.get(victim)
            if vpos is not None:
                k = int(np.searchsorted(vpos, i, side="right"))
                if k < len(vpos):
                    heapq.heappush(heap, (int(vpos[k]), victim))
        free -= nbytes
        res_add(rid)
        if rid not in pinned:
            q[rid] = 0.0
        miss_pos.append(int(tpos_np[i]))
        miss_rid.append(rid)
        vends.append(n_victims)
    mgr.free = free
    nev = np.diff(np.array(vends, dtype=np.int64), prepend=0)
    return SpanStruct(miss_pos, miss_rid, nev, victims)


def _phase_a_generic(mgr, tpos, trid, tab):
    """Policy-agnostic structure pass: same call sequence as the scalar path
    (victim → remove → insert), so stateful policies (CLOCK second-chance
    sweeps, RANDOM rng draws) stay in lockstep."""
    policy = mgr.policy
    on_touch = policy.on_touch
    track = isinstance(policy, LRU)
    lastpos: dict[int, int] = {}
    resident = mgr.resident
    pinned = mgr.pinned
    sizes = tab["sizes"]
    free = mgr.free
    miss_pos: list[int] = []
    miss_rid: list[int] = []
    vends: list[int] = []
    victims: list[int] = []
    n_victims = 0
    for i, rid in enumerate(trid):
        if rid in resident:
            on_touch(rid, 0.0)
            if track:
                lastpos[rid] = tpos[i]
            continue
        nbytes = sizes[rid]
        while free < nbytes:
            if len(policy) == 0:
                raise RuntimeError(
                    "SVM: device full of pinned/unevictable ranges "
                    f"(free={free}, need more; pinned={len(pinned)})")
            victim = policy.victim()
            policy.remove(victim)
            resident.discard(victim)
            free += sizes[victim]
            victims.append(victim)
            n_victims += 1
        free -= nbytes
        resident.add(rid)
        if rid not in pinned:
            policy.insert(rid, 0.0)
            if track:
                lastpos[rid] = tpos[i]
        miss_pos.append(tpos[i])
        miss_rid.append(rid)
        vends.append(n_victims)
    mgr.free = free
    nev = np.diff(np.array(vends, dtype=np.int64), prepend=0)
    return SpanStruct(miss_pos, miss_rid, nev, victims,
                      lastpos if track else None)


def _phase_a_var(mgr, tpos, trid, tab):
    """Sequential Phase A for the §4.2 driver variants: deferred
    granularity (the first ``defer_k - 1`` faults on a range migrate only
    a granule and leave it non-resident) and background pre-eviction below
    the free-space watermark (victims drained off the critical path after
    each migration).  LRF drives its queue directly; other policies go
    through the scalar call sequence so stateful policies stay in
    lockstep."""
    if type(mgr.policy) is LRF:
        return _phase_a_var_lrf(mgr, tpos, trid, tab)
    return _phase_a_var_generic(mgr, tpos, trid, tab)


def _phase_a_var_lrf(mgr, tpos, trid, tab):
    q = mgr.policy._q
    popitem = q.popitem
    resident = mgr.resident
    res_add = resident.add
    res_disc = resident.discard
    pinned = mgr.pinned
    sizes = tab["sizes"]
    free = mgr.free
    defer_g = mgr.defer_granule or 0
    defer_k = mgr.defer_k
    defer_on = bool(defer_g) and defer_k > 0
    dcount = mgr._defer_count
    dget = dcount.get
    pw_on = mgr.previct_watermark > 0.0
    target = mgr.previct_watermark * mgr.capacity
    miss_pos: list[int] = []
    miss_rid: list[int] = []
    m_nb: list[int] = []
    vend_pairs: list[tuple[int, int]] = []   # (miss idx, cum victims)
    victims: list[int] = []
    pv_counts: list[int] = []
    pv_victims: list[int] = []
    mp = miss_pos.append
    ma = miss_rid.append
    nba = m_nb.append
    vp = vend_pairs.append
    va = victims.append
    pca = pv_counts.append
    pva = pv_victims.append
    n_victims = 0
    for i, rid in enumerate(trid):
        if rid in resident:
            continue
        nbytes = sizes[rid]
        full = True
        if defer_on:
            c = dget(rid, 0) + 1
            dcount[rid] = c
            if c < defer_k:
                if defer_g < nbytes:
                    nbytes = defer_g
                full = False
            else:
                dcount.pop(rid, None)
        v0 = n_victims
        while free < nbytes:
            if not q:
                raise RuntimeError(
                    "SVM: device full of pinned/unevictable ranges "
                    f"(free={free}, need more; pinned={len(pinned)})")
            victim, _ = popitem(False)
            res_disc(victim)
            free += sizes[victim]
            va(victim)
            n_victims += 1
        if full:
            free -= nbytes
            res_add(rid)
            if rid not in pinned:
                q[rid] = 0.0
            nba(nbytes)
        else:
            nba(-nbytes)        # deferred granule: not resident
        mp(tpos[i])
        ma(rid)
        if n_victims != v0:
            vp((len(miss_pos) - 1, n_victims))
        if pw_on:
            pvn = 0
            while free < target and q:
                victim, _ = popitem(False)
                res_disc(victim)
                free += sizes[victim]
                pva(victim)
                pvn += 1
            pca(pvn)
    mgr.free = free
    nev = _nev_from_pairs(vend_pairs, len(miss_pos))
    return SpanStruct(miss_pos, miss_rid, nev, victims, None,
                      m_nb if defer_on else None,
                      pv_counts if pw_on else None,
                      pv_victims if pw_on else None)


def _phase_a_var_generic(mgr, tpos, trid, tab):
    policy = mgr.policy
    on_touch = policy.on_touch
    track = isinstance(policy, LRU)
    lastpos: dict[int, int] = {}
    resident = mgr.resident
    pinned = mgr.pinned
    sizes = tab["sizes"]
    free = mgr.free
    defer_g = mgr.defer_granule or 0
    defer_k = mgr.defer_k
    defer_on = bool(defer_g) and defer_k > 0
    dcount = mgr._defer_count
    pw_on = mgr.previct_watermark > 0.0
    target = mgr.previct_watermark * mgr.capacity
    miss_pos: list[int] = []
    miss_rid: list[int] = []
    m_nb: list[int] = []
    vends: list[int] = []
    victims: list[int] = []
    pv_counts: list[int] = []
    pv_victims: list[int] = []
    n_victims = 0
    for i, rid in enumerate(trid):
        if rid in resident:
            on_touch(rid, 0.0)
            if track:
                lastpos[rid] = tpos[i]
            continue
        nbytes = sizes[rid]
        full = True
        if defer_on:
            c = dcount.get(rid, 0) + 1
            dcount[rid] = c
            if c < defer_k:
                if defer_g < nbytes:
                    nbytes = defer_g
                full = False
            else:
                dcount.pop(rid, None)
        while free < nbytes:
            if len(policy) == 0:
                raise RuntimeError(
                    "SVM: device full of pinned/unevictable ranges "
                    f"(free={free}, need more; pinned={len(pinned)})")
            victim = policy.victim()
            policy.remove(victim)
            resident.discard(victim)
            free += sizes[victim]
            victims.append(victim)
            n_victims += 1
        if full:
            free -= nbytes
            resident.add(rid)
            if rid not in pinned:
                policy.insert(rid, 0.0)
                if track:
                    lastpos[rid] = tpos[i]
        miss_pos.append(tpos[i])
        miss_rid.append(rid)
        m_nb.append(nbytes if full else -nbytes)
        vends.append(n_victims)
        if pw_on:
            pvn = 0
            while free < target and len(policy) > 0:
                victim = policy.victim()
                policy.remove(victim)
                resident.discard(victim)
                free += sizes[victim]
                pv_victims.append(victim)
                pvn += 1
            pv_counts.append(pvn)
    mgr.free = free
    nev = np.diff(np.array(vends, dtype=np.int64), prepend=0)
    return SpanStruct(miss_pos, miss_rid, nev, victims,
                      lastpos if track else None,
                      m_nb if defer_on else None,
                      pv_counts if pw_on else None,
                      pv_victims if pw_on else None)


def _nev_from_pairs(vend_pairs, n_miss):
    """Dense per-miss blocking-eviction counts from the sparse
    (miss index, cumulative victims) pairs recorded in Phase A."""
    nev = np.zeros(n_miss, dtype=np.int64)
    if vend_pairs:
        idxs = [p[0] for p in vend_pairs]
        cums = np.array([p[1] for p in vend_pairs], dtype=np.int64)
        nev[idxs] = np.diff(cums, prepend=0)
    return nev


# ----------------------------------------------------- phase B — accounting

def _fold_evictions(acc, m_nev, starts, ec_v) -> None:
    """Fold each miss's blocking-eviction costs into its ``acc`` entry,
    preserving the scalar path's per-eviction left-to-right add order.

    Sweeps the eviction *ordinal* (all first evictions, then all
    seconds, ...) so each accumulator sees the same add chain as the
    scalar `+=` loop, vectorised across misses — one pass total for the
    dominant single-eviction case.  When only a few deep eviction chains
    remain (a capacity shrink blocking one miss on many victims), each
    survivor finishes with one exact sequential ``np.cumsum`` fold seeded
    from its current value instead of one vector pass per remaining
    ordinal — bit-identical, O(chains) numpy calls instead of
    O(max depth)."""
    if not len(ec_v):
        return
    sel = np.nonzero(m_nev > 0)[0]
    nmax = int(m_nev.max())
    j = 0
    while j < nmax:
        if j:
            sel = sel[m_nev[sel] > j]
            if not len(sel):
                return
            if len(sel) * 8 <= nmax - j:
                for i in sel.tolist():
                    st = int(starts[i]) + j
                    en = st + int(m_nev[i]) - j
                    acc[i] = np.cumsum(
                        np.concatenate(([acc[i]], ec_v[st:en])))[-1]
                return
        acc[sel] += ec_v[starts[sel] + j]
        j += 1


def _phase_b(ct, mgr, s, e, tab, st: SpanStruct, zc_pos, zc_rid,
             zc_key=None) -> np.ndarray:
    """Float accounting for one span.  Returns the per-op wall trajectory
    ``op_end`` (``op_end[k]`` = mgr.wall after relative op ``k``) so the
    fused-round path can sample mid-span cut points exactly."""
    if (len(zc_pos) == 0 and st.m_nbytes is None
            and (st.pv_counts is None or not any(st.pv_counts))):
        return _phase_b_fast(ct, mgr, s, e, tab, st.m_pos, st.m_rid,
                             st.nev, st.victims, st.lastpos)
    return _phase_b_general(ct, mgr, s, e, tab, st, zc_pos, zc_rid, zc_key)


def _phase_b_fast(ct, mgr, s, e, tab, miss_pos, miss_rid, nev, victims,
                  lastpos):
    """Vectorised, bit-exact float accounting for one plain span (full-range
    migrations, no pre-evictions, no zero-copy touches).

    Every accumulator fold is seeded with the manager's current value and
    realised with ``np.cumsum`` (an exact sequential fold), so the result
    equals the scalar path's `+=` chain bit for bit.
    """
    fargs = ct.fargs[s:e]
    M = len(miss_pos)
    cost = mgr.cost
    if M == 0:
        traj = np.cumsum(np.concatenate(([mgr.wall], fargs)))
        mgr.wall = float(traj[-1])
        mgr.compute_time = float(
            np.cumsum(np.concatenate(([mgr.compute_time], fargs)))[-1])
        if lastpos:
            q = getattr(mgr.policy, "_q", None)
            if q is not None:
                for rid, k in lastpos.items():
                    if rid in q:
                        q[rid] = float(traj[k - s + 1])
        return traj[1:]

    m_pos = np.asarray(miss_pos, dtype=np.int64)
    m_rid = np.asarray(miss_rid, dtype=np.int64)
    m_nev = np.asarray(nev, dtype=np.int64)
    v_rid = np.asarray(victims, dtype=np.int64)
    miss_rid_l = miss_rid.tolist() if isinstance(miss_rid, np.ndarray) \
        else miss_rid
    sizeidx = tab["sizeidx"]
    terms = tab["terms"][sizeidx[m_rid]]            # (M, 5)
    t1, t2, t3, t4, t5 = terms.T
    ec_v = tab["ecs"][sizeidx[v_rid]] if len(v_rid) else np.zeros(0)

    # fold eviction costs into each migration's alloc term in the scalar
    # path's per-eviction add order (`_fold_evictions`)
    alloc = t3.copy()
    ends = np.cumsum(m_nev)
    starts = ends - m_nev
    _fold_evictions(alloc, m_nev, starts, ec_v)
    total = (((t1 + t2) + alloc) + t4) + t5

    if mgr.parallel_evict:
        # §4.2 parallel implementation: overlap evictions with the blocked
        # migration (plus lock/rollback overhead)
        base = (((t1 + t2) + t3) + t4) + t5
        evw = np.zeros(M)
        _fold_evictions(evw, m_nev, starts, ec_v)
        total = np.where(m_nev > 0, np.maximum(base, evw) + 5e-6, base)

    # wall trajectory over the whole span (compute ops interleave misses;
    # hit ops contribute +0.0, which is add-identity for finite wall)
    deltas = fargs.copy()
    rel_pos = m_pos - s
    deltas[rel_pos] = total
    traj = np.cumsum(np.concatenate(([mgr.wall], deltas)))
    mgr.wall = float(traj[-1])
    mgr.compute_time = float(
        np.cumsum(np.concatenate(([mgr.compute_time], fargs)))[-1])

    # five-term cost ledger: one stacked exact fold, seeded with the
    # current accumulator values
    ledger = np.empty((M + 1, 5))
    ledger[0] = (cost.cpu_unmap, cost.sdma_setup, cost.alloc,
                 cost.cpu_update, cost.misc)
    ledger[1:, 0] = t1
    ledger[1:, 1] = t2
    ledger[1:, 2] = alloc
    ledger[1:, 3] = t4
    ledger[1:, 4] = t5
    (cost.cpu_unmap, cost.sdma_setup, cost.alloc, cost.cpu_update,
     cost.misc) = np.cumsum(ledger, axis=0)[-1].tolist()
    if len(ec_v):
        mgr.evict_cost_total = float(
            np.cumsum(np.concatenate(([mgr.evict_cost_total], ec_v)))[-1])

    # counters
    nmig0 = mgr.n_migrations
    mgr.n_migrations = nmig0 + M
    mgr.n_evictions += len(victims)
    msz = tab["size_arr"][m_rid]
    mgr.bytes_migrated += int(msz.sum())
    if len(v_rid):
        mgr.bytes_evicted += int(tab["size_arr"][v_rid].sum())
    mgr.faults_serviceable += M

    # duplicate faults: same deterministic jitter as SVMManager._noise
    dup = _synth_dup(ct, mgr, m_pos, nmig0, M)

    # trigger pages
    conc_m = ct.concs[m_pos]
    trig = tab["pages"][m_rid] + ct.hints[m_pos]
    high = conc_m >= 32
    if high.any():
        mgr.trigger_pages.update(
            np.concatenate([trig, trig[high] + 1]).tolist())
    else:
        mgr.trigger_pages.update(trig.tolist())

    # eviction notification (push-based listeners + epoch, fired at flush)
    if victims:
        mgr.eviction_epoch += len(victims)
        if mgr._evict_listeners:
            for v in victims:
                for cb in mgr._evict_listeners:
                    cb(v)

    # patch the (write-only) policy timestamps of surviving queue entries
    q = getattr(mgr.policy, "_q", None)
    if q is not None:
        if lastpos is None:           # LRF: inserts happen only on misses
            wall_at = traj[rel_pos + 1].tolist()
            for rid, w in zip(miss_rid_l, wall_at):
                if rid in q:
                    q[rid] = w
        else:
            for rid, k in lastpos.items():
                if rid in q:
                    q[rid] = float(traj[k - s + 1])

    if mgr.profile:
        _emit_profile(ct, mgr, s, tab, traj, m_pos, miss_rid_l, starts, ends,
                      victims, dup, trig)
    return traj[1:]


def _synth_dup(ct, mgr, m_pos, nmig0, M):
    """Duplicate-fault synthesis: same deterministic jitter stream as
    `SVMManager._noise`, vectorised over the span's migrations."""
    conc_m = ct.concs[m_pos]
    kk = np.arange(nmig0 + 1, nmig0 + M + 1, dtype=np.uint64)
    h = (kk * np.uint64(2654435761)
         + np.uint64((mgr._seed * 97) & 0xFFFFFFFF)) & np.uint64(0xFFFFFFFF)
    noise = 0.8 + 0.4 * (h.astype(np.float64) / float(0xFFFFFFFF))
    dup = (conc_m * noise).astype(np.int64) - 1
    np.clip(dup, 0, None, out=dup)
    mgr.faults_duplicate += int(dup.sum())
    return dup


def _phase_b_general(ct, mgr, s, e, tab, st: SpanStruct,
                     zc_pos, zc_rid, zc_key=None) -> None:
    """Bit-exact accounting for variant spans: deferred-granularity
    migrations (per-miss byte counts, non-resident granule copies),
    background pre-evictions (their `alloc`/wall contributions land at the
    exact scalar add positions via an expanded trajectory), and zero-copy
    touches (remote-access wall deltas + `zc` events in-span)."""
    fargs = ct.fargs[s:e]
    n_span = e - s
    cost = mgr.cost
    M = len(st.m_pos)
    Z = len(zc_pos)
    pvc = (np.asarray(st.pv_counts, dtype=np.int64)
           if st.pv_counts is not None else np.zeros(M, dtype=np.int64))
    P = int(pvc.sum()) if M else 0

    deltas = fargs.copy()
    if Z:
        zc_sizes = tab["size_arr"][zc_rid]
        zkey = ("zcc", int(zc_pos[0]), int(zc_pos[-1]), Z, zc_key,
                mgr.params)
        zcc = ct.span_cache.get(zkey)
        if zcc is None:       # pure function of the zc touch stream
            zcc = _zc_costs(tab, zc_sizes, mgr.params)
            ct.span_cache[zkey] = zcc
        deltas[zc_pos - s] = zcc

    if M:
        m_pos = np.asarray(st.m_pos, dtype=np.int64)
        m_rid = np.asarray(st.m_rid, dtype=np.int64)
        m_nev = np.asarray(st.nev, dtype=np.int64)
        v_rid = np.asarray(st.victims, dtype=np.int64)
        m_rel = m_pos - s
        sizeidx = tab["sizeidx"]
        if st.m_nbytes is None:
            m_nb = tab["size_arr"][m_rid]
            res_mask = None
            terms = tab["terms"][sizeidx[m_rid]]
        else:
            m_nb = np.asarray(st.m_nbytes, dtype=np.int64)
            res_mask = m_nb > 0
            np.abs(m_nb, out=m_nb)
            terms = _terms_for_sizes(tab, m_nb, mgr.params)
        t1, t2, t3, t4, t5 = terms.T
        ec_v = tab["ecs"][sizeidx[v_rid]] if len(v_rid) else np.zeros(0)

        alloc = t3.copy()
        ends = np.cumsum(m_nev)
        starts = ends - m_nev
        _fold_evictions(alloc, m_nev, starts, ec_v)
        total = (((t1 + t2) + alloc) + t4) + t5

        if mgr.parallel_evict:
            base = (((t1 + t2) + t3) + t4) + t5
            evw = np.zeros(M)
            _fold_evictions(evw, m_nev, starts, ec_v)
            total = np.where(m_nev > 0, np.maximum(base, evw) + 5e-6, base)
        deltas[m_rel] = total

    # wall trajectory: previct contributions are extra sequential adds
    # *inside* a miss op, so the trajectory is folded over an expanded
    # delta sequence and op boundaries are picked out of it
    if P:
        pv_vr = np.asarray(st.pv_victims, dtype=np.int64)
        pv_ec = tab["ecs"][tab["sizeidx"][pv_vr]]
        pv_wall = pv_ec * (1.0 - mgr.previct_overlap)
        pvc_at_op = np.zeros(n_span, dtype=np.int64)
        pvc_at_op[m_rel] = pvc
        cum_pv = np.cumsum(pvc_at_op)
        didx = np.arange(n_span) + (cum_pv - pvc_at_op)
        exp = np.zeros(n_span + P)
        exp[didx] = deltas
        miss_didx = didx[m_rel]
        pv_starts = np.cumsum(pvc) - pvc
        intra = np.arange(P) - np.repeat(pv_starts, pvc)
        pv_slots = np.repeat(miss_didx, pvc) + 1 + intra
        exp[pv_slots] = pv_wall
        traj = np.cumsum(np.concatenate(([mgr.wall], exp)))
        op_start = traj[didx]
        op_end = traj[didx + 1 + pvc_at_op]
        w_mid = traj[miss_didx + 1]
        pv_event_wall = traj[pv_slots]
    else:
        pv_ec = np.zeros(0)
        pv_vr = _EMPTY_I
        pv_event_wall = np.zeros(0)
        traj = np.cumsum(np.concatenate(([mgr.wall], deltas)))
        op_start = traj[:-1]
        op_end = traj[1:]
        w_mid = op_end[m_rel] if M else np.zeros(0)
    mgr.wall = float(traj[-1])
    mgr.compute_time = float(
        np.cumsum(np.concatenate(([mgr.compute_time], fargs)))[-1])

    if Z:
        mgr.n_zerocopy += Z
        mgr.bytes_zerocopy += int(zc_sizes.sum())

    dup = trig = None
    if M:
        # five-term ledger with previct `alloc` charges interleaved at
        # their scalar positions (zero rows elsewhere: +0.0 is add-identity
        # for the non-negative accumulators)
        miss_rows = np.arange(M) + (np.cumsum(pvc) - pvc)
        R = M + P
        ledger = np.zeros((R + 1, 5))
        ledger[0] = (cost.cpu_unmap, cost.sdma_setup, cost.alloc,
                     cost.cpu_update, cost.misc)
        ledger[miss_rows + 1, 0] = t1
        ledger[miss_rows + 1, 1] = t2
        ledger[miss_rows + 1, 2] = alloc
        ledger[miss_rows + 1, 3] = t4
        ledger[miss_rows + 1, 4] = t5
        if P:
            pv_rows = np.repeat(miss_rows, pvc) + 1 + intra
            ledger[pv_rows + 1, 2] = pv_ec
        (cost.cpu_unmap, cost.sdma_setup, cost.alloc, cost.cpu_update,
         cost.misc) = np.cumsum(ledger, axis=0)[-1].tolist()

        # evict_cost_total: per miss, blocking evictions then previcts —
        # scatter both streams into one sequence at their interleaved
        # positions (blocking ec j of miss i lands after all previcts of
        # earlier misses; previct j of miss i after miss i's blockers)
        if P == 0:
            ec_seq = ec_v
        elif len(ec_v) == 0:
            ec_seq = pv_ec
        else:
            ec_seq = np.empty(len(ec_v) + P)
            ec_seq[np.arange(len(ec_v))
                   + np.repeat(pv_starts, m_nev)] = ec_v
            ec_seq[np.arange(P) + np.repeat(ends, pvc)] = pv_ec
        if len(ec_seq):
            mgr.evict_cost_total = float(np.cumsum(
                np.concatenate(([mgr.evict_cost_total], ec_seq)))[-1])

        # counters
        nmig0 = mgr.n_migrations
        mgr.n_migrations = nmig0 + M
        mgr.n_evictions += len(st.victims) + P
        mgr.bytes_migrated += int(m_nb.sum())
        ev_bytes = 0
        if len(v_rid):
            ev_bytes += int(tab["size_arr"][v_rid].sum())
        if P:
            ev_bytes += int(tab["size_arr"][pv_vr].sum())
        mgr.bytes_evicted += ev_bytes
        mgr.faults_serviceable += M

        dup = _synth_dup(ct, mgr, m_pos, nmig0, M)

        conc_m = ct.concs[m_pos]
        trig = tab["pages"][m_rid] + ct.hints[m_pos]
        high = conc_m >= 32
        if high.any():
            mgr.trigger_pages.update(
                np.concatenate([trig, trig[high] + 1]).tolist())
        else:
            mgr.trigger_pages.update(trig.tolist())

        n_ev_total = len(st.victims) + P
        if n_ev_total:
            mgr.eviction_epoch += n_ev_total
            if mgr._evict_listeners:
                if P == 0:
                    ordered = st.victims
                elif not st.victims:
                    ordered = st.pv_victims
                else:
                    ordered = []
                    for i in range(M):
                        ordered.extend(
                            st.victims[starts[i]:ends[i]])
                        ordered.extend(
                            st.pv_victims[pv_starts[i]:pv_starts[i]
                                          + pvc[i]])
                for v in ordered:
                    for cb in mgr._evict_listeners:
                        cb(v)

    # patch the (write-only) policy timestamps of surviving queue entries
    q = getattr(mgr.policy, "_q", None)
    if q is not None:
        if st.lastpos is None:        # LRF: inserts happen only on misses
            if M:
                wm = w_mid.tolist()
                res_l = res_mask.tolist() if res_mask is not None else None
                m_rid_l = (st.m_rid.tolist()
                           if isinstance(st.m_rid, np.ndarray) else st.m_rid)
                for j, rid in enumerate(m_rid_l):
                    if res_l is not None and not res_l[j]:
                        continue      # deferred granule: never inserted
                    if rid in q:
                        q[rid] = wm[j]
        elif st.lastpos:
            pol_wall = op_end.copy()
            if M:
                pol_wall[m_rel] = w_mid
            for rid, k in st.lastpos.items():
                if rid in q:
                    q[rid] = float(pol_wall[k - s])

    if mgr.profile:
        _emit_profile_general(ct, mgr, s, tab, st, zc_pos, zc_rid,
                              op_start, op_end, w_mid, pv_event_wall,
                              dup, trig)
    return op_end


def _emit_profile(ct, mgr, s, tab, traj, m_pos, miss_rid, starts, ends,
                  victims, dup, trig):
    events = mgr.events
    density = mgr.density
    alloc_ids = tab["alloc_ids"]
    sizes = tab["sizes"]
    traj_l = traj.tolist()
    pos_l = (m_pos - s).tolist()
    starts_l = starts.tolist()
    ends_l = ends.tolist()
    dup_l = dup.tolist()
    trig_l = trig.tolist()
    for i, rid in enumerate(miss_rid):
        j = pos_l[i]
        w_before = traj_l[j]
        w_after = traj_l[j + 1]
        for vi in range(starts_l[i], ends_l[i]):
            v = victims[vi]
            events.append(Event(w_before, "evt", v, alloc_ids[v], sizes[v]))
        events.append(Event(w_after, "mig", rid, alloc_ids[rid], sizes[rid]))
        density.append(DensitySample(w_after, rid, alloc_ids[rid],
                                     1 + dup_l[i], trig_l[i]))


def _emit_profile_general(ct, mgr, s, tab, st: SpanStruct, zc_pos, zc_rid,
                          op_start, op_end, w_mid, pv_event_wall,
                          dup, trig):
    """Scalar-ordered event/density emission for variant spans: blocking
    evictions at the pre-migration wall, the migration at its mid-op wall,
    pre-evictions at their per-eviction walls, zero-copy events at their
    post-touch walls — merged in op order."""
    events = mgr.events
    density = mgr.density
    alloc_ids = tab["alloc_ids"]
    sizes = tab["sizes"]
    M = len(st.m_pos)
    victims = st.victims
    pv_victims = st.pv_victims or []
    m_rel = [p - s for p in (st.m_pos.tolist()
                             if isinstance(st.m_pos, np.ndarray)
                             else st.m_pos)]
    m_rid_l = (st.m_rid.tolist() if isinstance(st.m_rid, np.ndarray)
               else st.m_rid)
    zc_rel = (zc_pos - s).tolist()
    zc_rid_l = zc_rid.tolist()
    nev_l = st.nev.tolist() if M else []
    pvc_l = (st.pv_counts if st.pv_counts is not None else [0] * M)
    nb_l = (np.abs(np.asarray(st.m_nbytes, dtype=np.int64)).tolist()
            if st.m_nbytes is not None
            else [sizes[r] for r in m_rid_l])
    op_start_l = op_start.tolist()
    op_end_l = op_end.tolist()
    w_mid_l = w_mid.tolist() if M else []
    pv_wall_l = pv_event_wall.tolist()
    dup_l = dup.tolist() if dup is not None else []
    trig_l = trig.tolist() if trig is not None else []
    mi = zi = 0
    vcur = pvcur = 0
    while mi < M or zi < len(zc_rel):
        if zi >= len(zc_rel) or (mi < M and m_rel[mi] < zc_rel[zi]):
            p = m_rel[mi]
            rid = m_rid_l[mi]
            w0 = op_start_l[p]
            for _ in range(nev_l[mi]):
                v = victims[vcur]
                vcur += 1
                events.append(Event(w0, "evt", v, alloc_ids[v], sizes[v]))
            wm = w_mid_l[mi]
            events.append(Event(wm, "mig", rid, alloc_ids[rid], nb_l[mi]))
            density.append(DensitySample(wm, rid, alloc_ids[rid],
                                         1 + dup_l[mi], trig_l[mi]))
            for _ in range(pvc_l[mi]):
                v = pv_victims[pvcur]
                events.append(Event(pv_wall_l[pvcur], "evt", v,
                                    alloc_ids[v], sizes[v]))
                pvcur += 1
            mi += 1
        else:
            p = zc_rel[zi]
            rid = zc_rid_l[zi]
            events.append(Event(op_end_l[p], "zc", rid, alloc_ids[rid],
                                sizes[rid]))
            zi += 1

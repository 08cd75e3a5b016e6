"""Access-trace generators for the paper's workload suite (Table 2).

Each workload lays out its managed allocations and yields a lazy op trace
capturing the *access pattern class* the paper analyses.  Every workload
additionally implements ``emit_columns(space)`` — the columnar compile
tier: the engine's flat op columns are constructed directly with
`np.repeat`/`np.tile`/`np.arange` over range-id arrays, op-for-op
identical to lowering the ``trace()`` generator (which stays the golden
reference; see tests/test_columnar_traces.py) but without materialising
per-op tuples.

The pattern classes:

  Category I   — STREAM, Conv2d, BFS: linear streaming, no (or algorithmic)
                 reuse → permanent evictions only.
  Category II  — Jacobi2d: repeated linear traversal (two kernels per
                 iteration) → cyclic premature eviction under LRF.
  Category III — SGEMM/SYR2K: intense factor reuse (row-panel × all-columns)
                 → chain thrashing; MVT/GESUMMV: concurrent accesses
                 dispersed across all ranges (BLAS-2 thread-per-row) →
                 wavefront-retry thrashing.

Calibration notes (documented in EXPERIMENTS.md §Validation):
  * `concurrency` sets per-migration duplicate-fault counts (fault density),
    calibrated to paper Fig. 8/9 (STREAM≈200 … GESUMMV≈20).
  * Jacobi2d per-touch compute folds the fault/compute overlap a serial
    trace cannot express; the value (≈70 GB/s effective) is calibrated so
    the DOS=109 relative performance lands at the paper's 0.40.
  * Wave workloads (MVT/GESUMMV) amplify same-page XNACK replay with a
    static retry factor  retries = AMP·(WS/C_eff − 1)  (AMP=200, capped),
    reproducing the paper's ≈0.05 serviceable-faults-per-migration under
    thrash. The *onset* and *category* behaviour are structural (capacity
    pressure + LRF), only the replay multiplicity is calibrated.
"""

from __future__ import annotations

import math
from typing import Iterator

import numpy as np

from repro_torch.core.engine import ColumnEmitter, CompiledTrace
from repro_torch.core.ranges import AddressSpace, GB, MB
from repro_torch.core.simulator import Op, Workload

PEAK_FLOPS = 24e12       # MI250X GCD fp32 vector peak
HBM_BW = 1.6e12          # MI250X GCD HBM2e bandwidth

WAVE_RETRY_AMP = 200.0   # XNACK-replay amplification under thrash
WAVE_RETRY_CAP = 400


def _rids(space: AddressSpace, alloc) -> list[int]:
    return [r.rid for r in space.ranges_of(alloc)]


def _rid_arr(space: AddressSpace, alloc) -> np.ndarray:
    rs = space.ranges_of(alloc)   # rids are consecutive per allocation
    return np.arange(rs[0].rid, rs[-1].rid + 1, dtype=np.int64)


def _sizes(space: AddressSpace) -> np.ndarray:
    return space.size_array()


def _interleave(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a[0], b[0], a[1], b[1], … with the longer array's tail appended —
    the ``for i in range(max(la, lb)): if i < la … if i < lb …`` pattern."""
    m = min(len(a), len(b))
    out = np.empty(len(a) + len(b), dtype=np.int64)
    out[0:2 * m:2] = a[:m]
    out[1:2 * m:2] = b[:m]
    out[2 * m:] = a[m:] if len(a) > m else b[m:]
    return out


def _multi_arange(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Concatenation of ``arange(starts[i], starts[i] + lens[i])``."""
    total = int(lens.sum())
    cum = np.cumsum(lens) - lens
    return np.repeat(starts - cum, lens) + np.arange(total)


class Stream(Workload):
    """Triad a[i] = b[i] + s*c[i] — linear single pass, 3 equal allocations."""

    name = "stream"
    concurrency = 200

    def build(self, space: AddressSpace) -> None:
        third = self.total_bytes // 3
        self.a = space.alloc(third, "a")
        self.b = space.alloc(third, "b")
        self.c = space.alloc(third, "c")

    def trace(self, space: AddressSpace) -> Iterator[Op]:
        yield ("kernel", "triad")
        ra, rb, rc = (_rids(space, x) for x in (self.a, self.b, self.c))
        n = min(len(ra), len(rb), len(rc))
        for i in range(n):
            for rid in (rb[i], rc[i], ra[i]):
                yield ("touch", rid, self.concurrency, 0)
            nbytes = sum(space.ranges[r].size for r in (rb[i], rc[i], ra[i]))
            yield ("compute", nbytes / HBM_BW)

    def emit_columns(self, space: AddressSpace) -> CompiledTrace:
        em = ColumnEmitter()
        em.kernel()
        sz = _sizes(space)
        ra, rb, rc = (_rid_arr(space, x) for x in (self.a, self.b, self.c))
        n = min(len(ra), len(rb), len(rc))
        ra, rb, rc = ra[:n], rb[:n], rc[:n]
        em.rows(np.stack([rb, rc, ra], axis=1), self.concurrency,
                (sz[rb] + sz[rc] + sz[ra]) / HBM_BW)
        return em.finish()


class Conv2d(Workload):
    """Full 2-D convolution: linear in/out streams + small weight alloc."""

    name = "conv2d"
    concurrency = 130
    FLOPS_PER_BYTE = 12.0   # ~K*K MACs per element, K≈5

    def build(self, space: AddressSpace) -> None:
        w = min(64 * MB, max(2 * MB, self.total_bytes // 100))
        half = (self.total_bytes - w) // 2
        self.inp = space.alloc(half, "input")
        self.out = space.alloc(half, "output")
        self.wgt = space.alloc(w, "weights")

    def trace(self, space: AddressSpace) -> Iterator[Op]:
        yield ("kernel", "conv2d")
        for rid in _rids(space, self.wgt):
            yield ("touch", rid, self.concurrency, 0)
        ri, ro = _rids(space, self.inp), _rids(space, self.out)
        for i in range(min(len(ri), len(ro))):
            yield ("touch", ri[i], self.concurrency, 0)
            yield ("touch", ro[i], self.concurrency, 0)
            nb = space.ranges[ri[i]].size + space.ranges[ro[i]].size
            yield ("compute", nb * self.FLOPS_PER_BYTE / PEAK_FLOPS
                   + nb / HBM_BW)

    def emit_columns(self, space: AddressSpace) -> CompiledTrace:
        em = ColumnEmitter()
        em.kernel()
        em.touches(_rid_arr(space, self.wgt), self.concurrency)
        sz = _sizes(space)
        ri, ro = _rid_arr(space, self.inp), _rid_arr(space, self.out)
        n = min(len(ri), len(ro))
        ri, ro = ri[:n], ro[:n]
        nb = sz[ri] + sz[ro]
        em.rows(np.stack([ri, ro], axis=1), self.concurrency,
                nb * self.FLOPS_PER_BYTE / PEAK_FLOPS + nb / HBM_BW)
        return em.finish()


class Jacobi2d(Workload):
    """Two alternating 5-point stencil kernels over matrices A, B.

    Naive: both kernels traverse first→last row (paper Alg. 1) — under LRF
    this is cyclic reuse and every touch misses once oversubscribed.
    SVM-aware: the second kernel traverses last→first (paper Alg. 2),
    reusing the still-resident tail.
    """

    name = "jacobi2d"
    concurrency = 95
    ITERS = 2
    # seconds of compute per byte touched; folds fault/compute overlap —
    # calibrated to paper's 0.40 relative perf at DOS=109 (≈60 GB/s eff.)
    INTENSITY = 5.9e-11

    def __init__(self, total_bytes: int, svm_aware: bool = False):
        super().__init__(total_bytes)
        self.svm_aware = svm_aware
        if svm_aware:
            self.name = "jacobi2d-svm-aware"

    def build(self, space: AddressSpace) -> None:
        half = self.total_bytes // 2
        self.A = space.alloc(half, "A")
        self.B = space.alloc(half, "B")

    def trace(self, space: AddressSpace) -> Iterator[Op]:
        ra, rb = _rids(space, self.A), _rids(space, self.B)
        n = min(len(ra), len(rb))
        for it in range(self.ITERS):
            yield ("kernel", f"jacobi_k1_iter{it}")
            for i in range(n):  # B <- stencil(A): read A_i, write B_i
                yield ("touch", ra[i], self.concurrency, 0)
                yield ("touch", rb[i], self.concurrency, 0)
                nb = space.ranges[ra[i]].size + space.ranges[rb[i]].size
                yield ("compute", nb * self.INTENSITY)
            yield ("kernel", f"jacobi_k2_iter{it}")
            order = range(n - 1, -1, -1) if self.svm_aware else range(n)
            for i in order:  # A <- stencil(B)
                yield ("touch", rb[i], self.concurrency, 0)
                yield ("touch", ra[i], self.concurrency, 0)
                nb = space.ranges[ra[i]].size + space.ranges[rb[i]].size
                yield ("compute", nb * self.INTENSITY)

    def emit_columns(self, space: AddressSpace) -> CompiledTrace:
        em = ColumnEmitter()
        sz = _sizes(space)
        ra, rb = _rid_arr(space, self.A), _rid_arr(space, self.B)
        n = min(len(ra), len(rb))
        ra, rb = ra[:n], rb[:n]
        f = (sz[ra] + sz[rb]) * self.INTENSITY
        k1 = np.stack([ra, rb], axis=1)
        k2 = np.stack([rb, ra], axis=1)
        for _ in range(self.ITERS):
            em.kernel()
            em.rows(k1, self.concurrency, f)
            em.kernel()
            if self.svm_aware:
                em.rows(k2[::-1], self.concurrency, f[::-1])
            else:
                em.rows(k2, self.concurrency, f)
        return em.finish()

    def work_units(self) -> float:
        return float(self.total_bytes * 2 * self.ITERS)


class BFS(Workload):
    """EMOGI-style BFS: per-level linear windows over the edge list, sparse
    node accesses, frontier written back to the host each level."""

    name = "bfs"
    concurrency = 12
    LEVEL_FRACS = (0.04, 0.12, 0.30, 0.28, 0.15, 0.07, 0.03)

    def build(self, space: AddressSpace) -> None:
        self.nodes = space.alloc(int(self.total_bytes * 0.10), "nodes")
        self.edges = space.alloc(int(self.total_bytes * 0.85), "edges")
        self.front = space.alloc(
            max(2 * MB, int(self.total_bytes * 0.05)), "frontier")

    def trace(self, space: AddressSpace) -> Iterator[Op]:
        re = _rids(space, self.edges)
        rn = _rids(space, self.nodes)
        rf = _rids(space, self.front)
        off = 0
        for lvl, frac in enumerate(self.LEVEL_FRACS):
            yield ("kernel", f"bfs_level{lvl}")
            win = max(1, int(len(re) * frac))
            for j in range(win):  # linear window across edge ranges
                yield ("touch", re[(off + j) % len(re)], self.concurrency, lvl)
            off += win
            for j in range(0, len(rn), 3):  # sparse node accesses
                yield ("touch", rn[j], self.concurrency, lvl)
            nb = sum(space.ranges[re[(off - win + j) % len(re)]].size
                     for j in range(win))
            yield ("compute", nb * 2.0 / HBM_BW)
            for rid in rf:  # algorithmic device→host frontier output
                yield ("touch", rid, self.concurrency, lvl)
                yield ("writeback", rid)

    def emit_columns(self, space: AddressSpace) -> CompiledTrace:
        em = ColumnEmitter()
        sz = _sizes(space)
        re = _rid_arr(space, self.edges)
        rn = _rid_arr(space, self.nodes)
        rf = _rid_arr(space, self.front)
        off = 0
        for lvl, frac in enumerate(self.LEVEL_FRACS):
            em.kernel()
            win = max(1, int(len(re) * frac))
            w_rids = re[(off + np.arange(win)) % len(re)]
            em.touches(w_rids, self.concurrency, lvl)
            off += win
            em.touches(rn[::3], self.concurrency, lvl)
            em.compute(int(sz[w_rids].sum()) * 2.0 / HBM_BW)
            em.touch_writeback(rf, self.concurrency, lvl)
        return em.finish()

    def work_units(self) -> float:
        return float(self.total_bytes * sum(self.LEVEL_FRACS))


class _GemmLike(Workload):
    """Shared structure for SGEMM / SYR2K: migrate factors, then row-panel
    waves that re-traverse whole factor allocations (intense reuse)."""

    WAVE_ROWS = 256
    dtype_bytes = 4

    def __init__(self, total_bytes: int, svm_aware: bool = False):
        super().__init__(total_bytes)
        self.svm_aware = svm_aware
        if svm_aware:
            self.name = self.name + "-svm-aware"

    def build(self, space: AddressSpace) -> None:
        third = self.total_bytes // 3
        self.A = space.alloc(third, "A")
        self.B = space.alloc(third, "B")
        self.C = space.alloc(third, "C")
        self.n = max(1, int(math.isqrt(third // self.dtype_bytes)))

    def _waves(self) -> int:
        return max(1, math.ceil(self.n / self.WAVE_ROWS))

    def work_units(self) -> float:
        return 2.0 * float(self.n) ** 3

    def _panel(self, rids, w: int, waves: int):
        """Contiguous range slice for wave w's row panel (list or array)."""
        lo = int(w * len(rids) / waves)
        hi = max(lo + 1, int((w + 1) * len(rids) / waves))
        return rids[lo:hi]


class Sgemm(_GemmLike):
    """C = A·B. Naive (rocBLAS-profile-alike, paper §4.1): migrate both
    factors fully, then compute C row-panels, each re-reading all of B —
    LRF chain-thrashes the factors once C fills the device.
    SVM-aware: pin B on-device, stream A/C row panels with partial sums
    (paper's SGEMM-svm-aware; valid while B fits, i.e. DOS ≲ 300)."""

    name = "sgemm"
    concurrency = 40

    def trace(self, space: AddressSpace) -> Iterator[Op]:
        ra, rb, rc = (_rids(space, x) for x in (self.A, self.B, self.C))
        waves = self._waves()
        flops_per_wave = self.work_units() / waves

        if self.svm_aware:
            yield ("kernel", "sgemm_pin_B")
            for rid in rb:
                yield ("pin", rid)
        else:
            yield ("kernel", "sgemm_migrate_factors")
            for i in range(max(len(ra), len(rb))):
                if i < len(ra):
                    yield ("touch", ra[i], self.concurrency, 0)
                if i < len(rb):
                    yield ("touch", rb[i], self.concurrency, 0)

        yield ("kernel", "sgemm_compute")
        for w in range(waves):
            apanel = self._panel(ra, w, waves)
            cpanel = self._panel(rc, w, waves)
            for rid in apanel:                      # A row panel
                yield ("touch", rid, self.concurrency, 0)
            if not self.svm_aware:
                # Blocked-GEMM aggregate access: every wave of product
                # blocks re-reads all of B, and — once the accumulating
                # product rows overflow the device — also the LRF-churned
                # slice of A (paper Fig. 12a: BOTH factors thrash; §4.1:
                # "chain of thrashing over factor matrix elements"). The
                # churned slice grows with the overflow fraction: LRF keeps
                # evicting the oldest-faulted factor ranges (blind to their
                # reuse) and every re-migration displaces further factor
                # data.
                for rid in rb:                      # all of B, every wave
                    yield ("touch", rid, self.concurrency, 0)
                overflow = (self.A.size + self.B.size
                            + self.C.size * (w + 1) / waves
                            ) / space.capacity - 1.0
                frac = min(1.0, max(0.0, 2.0 * overflow))
                churn = int(frac * len(ra))
                for j in range(churn):              # churned A slice
                    yield ("touch", ra[(w + j) % len(ra)],
                           self.concurrency, 0)
            for rid in cpanel:                      # C output panel
                yield ("touch", rid, self.concurrency, 0)
            yield ("compute", flops_per_wave / PEAK_FLOPS)

    def emit_columns(self, space: AddressSpace) -> CompiledTrace:
        em = ColumnEmitter()
        ra, rb, rc = (_rid_arr(space, x) for x in (self.A, self.B, self.C))
        waves = self._waves()
        cval = (self.work_units() / waves) / PEAK_FLOPS
        conc = self.concurrency
        em.kernel()
        if self.svm_aware:
            em.pins(rb)
            em.kernel()
            self._emit_aware_waves(em, ra, rc, waves, conc, cval)
            return em.finish()
        em.touches(_interleave(ra, rb), conc)
        em.kernel()
        la = len(ra)
        for w in range(waves):
            em.touches(self._panel(ra, w, waves), conc)
            em.touches(rb, conc)
            overflow = (self.A.size + self.B.size
                        + self.C.size * (w + 1) / waves
                        ) / space.capacity - 1.0
            frac = min(1.0, max(0.0, 2.0 * overflow))
            churn = int(frac * la)
            if churn:
                em.touches(ra[(w + np.arange(churn)) % la], conc)
            em.touches(self._panel(rc, w, waves), conc)
            em.compute(cval)
        return em.finish()

    def _emit_aware_waves(self, em: ColumnEmitter, ra, rc, waves, conc,
                          cval) -> None:
        """All svm-aware waves ([A panel, C panel, compute] each) as one
        vectorised block.  Panel bounds replicate `_panel`'s float-division
        truncation exactly (quotients are far from integers relative to
        one ulp, so `astype(int64)` == `int()` op-for-op)."""
        from repro_torch.core.engine import OP_COMPUTE, OP_TOUCH

        w = np.arange(waves)
        la, lc = len(ra), len(rc)
        lo_a = (w * la / waves).astype(np.int64)
        hi_a = np.maximum(lo_a + 1, ((w + 1) * la / waves).astype(np.int64))
        lo_c = (w * lc / waves).astype(np.int64)
        hi_c = np.maximum(lo_c + 1, ((w + 1) * lc / waves).astype(np.int64))
        len_a, len_c = hi_a - lo_a, hi_c - lo_c
        per_wave = len_a + len_c + 1
        n = int(per_wave.sum())
        wave_off = np.cumsum(per_wave) - per_wave
        a_pos = _multi_arange(wave_off, len_a)
        c_pos = _multi_arange(wave_off + len_a, len_c)
        comp_pos = wave_off + len_a + len_c
        codes = np.full(n, OP_TOUCH, dtype=np.int8)
        codes[comp_pos] = OP_COMPUTE
        rids = np.empty(n, dtype=np.int64)
        rids[a_pos] = ra[_multi_arange(lo_a, len_a)]
        rids[c_pos] = rc[_multi_arange(lo_c, len_c)]
        rids[comp_pos] = -1
        concs = np.full(n, conc, dtype=np.int64)
        concs[comp_pos] = 0
        fargs = np.zeros(n)
        fargs[comp_pos] = cval
        em.raw(codes, rids, concs, np.zeros(n, dtype=np.int64), fargs)


class Syr2k(_GemmLike):
    """C = α·A·Bᵀ + α·B·Aᵀ + C — both factors fully re-traversed per
    row-panel wave (even more reuse than SGEMM)."""

    name = "syr2k"
    concurrency = 45

    def trace(self, space: AddressSpace) -> Iterator[Op]:
        ra, rb, rc = (_rids(space, x) for x in (self.A, self.B, self.C))
        waves = self._waves()
        flops_per_wave = 2.0 * self.work_units() / waves
        yield ("kernel", "syr2k_migrate_factors")
        for i in range(max(len(ra), len(rb))):
            if i < len(ra):
                yield ("touch", ra[i], self.concurrency, 0)
            if i < len(rb):
                yield ("touch", rb[i], self.concurrency, 0)
        yield ("kernel", "syr2k_compute")
        for w in range(waves):
            for rid in self._panel(ra, w, waves) + self._panel(rb, w, waves):
                yield ("touch", rid, self.concurrency, 0)
            for rid in ra:
                yield ("touch", rid, self.concurrency, 0)
            for rid in rb:
                yield ("touch", rid, self.concurrency, 0)
            for rid in self._panel(rc, w, waves):
                yield ("touch", rid, self.concurrency, 0)
            yield ("compute", flops_per_wave / PEAK_FLOPS)

    def emit_columns(self, space: AddressSpace) -> CompiledTrace:
        em = ColumnEmitter()
        ra, rb, rc = (_rid_arr(space, x) for x in (self.A, self.B, self.C))
        waves = self._waves()
        cval = (2.0 * self.work_units() / waves) / PEAK_FLOPS
        conc = self.concurrency
        em.kernel()
        em.touches(_interleave(ra, rb), conc)
        em.kernel()
        for w in range(waves):
            em.touches(np.concatenate([self._panel(ra, w, waves),
                                       self._panel(rb, w, waves)]), conc)
            em.touches(ra, conc)
            em.touches(rb, conc)
            em.touches(self._panel(rc, w, waves), conc)
            em.compute(cval)
        return em.finish()


def _wave_retries(ws_bytes: int, other_bytes: int, capacity: int) -> int:
    """Static XNACK-replay amplification for dispersed-access waves."""
    c_eff = max(capacity - other_bytes, 1)
    ratio = ws_bytes / c_eff
    if ratio <= 1.0:
        return 1
    return min(WAVE_RETRY_CAP, max(1, round(WAVE_RETRY_AMP * (ratio - 1.0))))


class Mvt(Workload):
    """x1 = A·y1 then x2 = Aᵀ·y2 — the transpose pass disperses concurrent
    accesses across every range of A (paper's spatial Category-III type)."""

    name = "mvt"
    concurrency = 25
    WAVE_COLS = 8192
    dtype_bytes = 4

    def __init__(self, total_bytes: int, retry_override: int | None = None):
        super().__init__(total_bytes)
        self.retry_override = retry_override

    def build(self, space: AddressSpace) -> None:
        vec = max(2 * MB, int(self.total_bytes * 0.005))
        self.A = space.alloc(self.total_bytes - 4 * vec, "A")
        self.vecs = [space.alloc(vec, f"v{i}") for i in range(4)]
        self.n = max(1, int(math.isqrt(self.A.size // self.dtype_bytes)))

    def trace(self, space: AddressSpace) -> Iterator[Op]:
        ra = _rids(space, self.A)
        for v in self.vecs:
            for rid in _rids(space, v):
                yield ("touch", rid, self.concurrency, 0)
        yield ("kernel", "mvt_row_pass")  # x1 = A·y1 — linear
        for rid in ra:
            yield ("touch", rid, self.concurrency, 0)
        yield ("compute", 2.0 * self.A.size / self.dtype_bytes / PEAK_FLOPS)
        yield ("kernel", "mvt_col_pass")  # x2 = Aᵀ·y2 — dispersed waves
        waves = max(1, math.ceil(self.n / self.WAVE_COLS))
        other = sum(v.size for v in self.vecs)
        retries = (self.retry_override if self.retry_override is not None
                   else _wave_retries(self.A.size, other, space.capacity))
        for w in range(waves):
            for _ in range(retries):
                for rid in ra:
                    yield ("touch", rid, self.concurrency, 1 + w)
            yield ("compute",
                   2.0 * self.A.size / self.dtype_bytes / PEAK_FLOPS / waves)

    def emit_columns(self, space: AddressSpace) -> CompiledTrace:
        em = ColumnEmitter()
        conc = self.concurrency
        for v in self.vecs:
            em.touches(_rid_arr(space, v), conc)
        ra = _rid_arr(space, self.A)
        em.kernel()
        em.touches(ra, conc)
        em.compute(2.0 * self.A.size / self.dtype_bytes / PEAK_FLOPS)
        em.kernel()
        waves = max(1, math.ceil(self.n / self.WAVE_COLS))
        other = sum(v.size for v in self.vecs)
        retries = (self.retry_override if self.retry_override is not None
                   else _wave_retries(self.A.size, other, space.capacity))
        cval = 2.0 * self.A.size / self.dtype_bytes / PEAK_FLOPS / waves
        tiled = np.tile(ra, retries)
        for w in range(waves):
            em.touches(tiled, conc, 1 + w)
            em.compute(cval)
        return em.finish()

    def work_units(self) -> float:
        return float(2 * self.A.size)


class Gesummv(Workload):
    """y = α·A·x + β·B·x — thread-per-row over TWO large matrices: waves of
    concurrent accesses dispersed across all ranges of A and B (the paper's
    worst thrasher)."""

    name = "gesummv"
    concurrency = 20
    WAVE_ROWS = 16384
    dtype_bytes = 4

    def __init__(self, total_bytes: int, retry_override: int | None = None):
        super().__init__(total_bytes)
        self.retry_override = retry_override

    def build(self, space: AddressSpace) -> None:
        vec = max(2 * MB, int(self.total_bytes * 0.004))
        half = (self.total_bytes - 3 * vec) // 2
        self.A = space.alloc(half, "A")
        self.B = space.alloc(half, "B")
        self.vecs = [space.alloc(vec, f"v{i}") for i in range(3)]
        self.n = max(1, int(math.isqrt(half // self.dtype_bytes)))

    def trace(self, space: AddressSpace) -> Iterator[Op]:
        ra, rb = _rids(space, self.A), _rids(space, self.B)
        for v in self.vecs:
            for rid in _rids(space, v):
                yield ("touch", rid, self.concurrency, 0)
        yield ("kernel", "gesummv")
        waves = max(1, math.ceil(self.n / self.WAVE_ROWS))
        ws = self.A.size + self.B.size
        other = sum(v.size for v in self.vecs)
        retries = (self.retry_override if self.retry_override is not None
                   else _wave_retries(ws, other, space.capacity))
        flops = 4.0 * ws / self.dtype_bytes
        for w in range(waves):
            for _ in range(retries):
                for i in range(max(len(ra), len(rb))):
                    if i < len(ra):
                        yield ("touch", ra[i], self.concurrency, 1 + w)
                    if i < len(rb):
                        yield ("touch", rb[i], self.concurrency, 1 + w)
            yield ("compute", flops / PEAK_FLOPS / waves)

    def emit_columns(self, space: AddressSpace) -> CompiledTrace:
        em = ColumnEmitter()
        conc = self.concurrency
        for v in self.vecs:
            em.touches(_rid_arr(space, v), conc)
        em.kernel()
        ra, rb = _rid_arr(space, self.A), _rid_arr(space, self.B)
        waves = max(1, math.ceil(self.n / self.WAVE_ROWS))
        ws = self.A.size + self.B.size
        other = sum(v.size for v in self.vecs)
        retries = (self.retry_override if self.retry_override is not None
                   else _wave_retries(ws, other, space.capacity))
        flops = 4.0 * ws / self.dtype_bytes
        cval = flops / PEAK_FLOPS / waves
        tiled = np.tile(_interleave(ra, rb), retries)
        for w in range(waves):
            em.touches(tiled, conc, 1 + w)
            em.compute(cval)
        return em.finish()

    def work_units(self) -> float:
        return float(self.A.size + self.B.size)


class HotSet(Workload):
    """Seeded synthetic hot-set trace (cache-algorithm-simulator style):
    random touches over one allocation where a ``hot_frac`` window of the
    ranges receives ``hot_prob`` of the accesses.

    ``mode``:

      * ``static``      — one hot window for the whole trace (the
                          baseline every eviction policy should ace),
      * ``dynamic``      — the window jumps to a fresh seeded-random
                          position each phase (working-set drift),
      * ``oscillating``  — the window ping-pongs between two fixed
                          positions each phase: the phase-change
                          adversary for schedulers and fused rounds
                          (every flip invalidates the resident hot set).

    The full touch sequence is drawn **once** with a seeded generator and
    shared by ``trace()`` and ``emit_columns`` — generator-vs-columnar
    parity holds by construction (and is tested).  One kernel marker and
    one compute op per phase."""

    name = "hotset"
    concurrency = 32
    MODES = ("static", "dynamic", "oscillating")

    def __init__(self, total_bytes: int, mode: str = "static",
                 hot_frac: float = 0.125, hot_prob: float = 0.9,
                 phases: int = 8, ops: int = 4096, seed: int = 0):
        super().__init__(total_bytes)
        if mode not in self.MODES:
            raise ValueError(f"unknown hot-set mode {mode!r}; "
                             f"available: {self.MODES}")
        self.mode = mode
        self.name = f"hotset-{mode}"
        self.hot_frac = hot_frac
        self.hot_prob = hot_prob
        self.phases = max(1, int(phases)) if mode != "static" else 1
        self.ops = int(ops)
        self.seed = seed
        self._seq: tuple | None = None

    def build(self, space: AddressSpace) -> None:
        self.data = space.alloc(self.total_bytes, "data")

    def _sequence(self, space: AddressSpace):
        """(touch rids, phase op bounds, per-phase compute seconds) —
        drawn once, then shared by both trace tiers."""
        if self._seq is not None:
            return self._seq
        rids = _rid_arr(space, self.data)
        n = len(rids)
        rng = np.random.default_rng(self.seed)
        nhot = max(1, int(round(n * self.hot_frac)))
        if self.mode == "static":
            starts = np.array([int(rng.integers(n))], dtype=np.int64)
        elif self.mode == "dynamic":
            starts = rng.integers(0, n, size=self.phases).astype(np.int64)
        else:                              # oscillating: ping-pong
            a, b = 0, n // 2
            starts = np.array(
                [a if p % 2 == 0 else b for p in range(self.phases)],
                dtype=np.int64)
        per = math.ceil(self.ops / self.phases)
        pidx = np.minimum(np.arange(self.ops) // per, self.phases - 1)
        hot = rng.random(self.ops) < self.hot_prob
        cold_pos = rng.integers(0, n, size=self.ops)
        hot_off = rng.integers(0, nhot, size=self.ops)
        pos = np.where(hot, (starts[pidx] + hot_off) % n, cold_pos)
        seq = rids[pos]
        bounds = np.minimum(np.arange(self.phases + 1) * per, self.ops)
        sz = _sizes(space)
        comp = np.array([float(sz[seq[a:b]].sum()) / HBM_BW
                         for a, b in zip(bounds[:-1], bounds[1:])])
        self._seq = (seq, bounds, comp)
        return self._seq

    def trace(self, space: AddressSpace) -> Iterator[Op]:
        seq, bounds, comp = self._sequence(space)
        conc = self.concurrency
        for p in range(len(bounds) - 1):
            yield ("kernel", f"hotset_p{p}")
            for rid in seq[bounds[p]:bounds[p + 1]].tolist():
                yield ("touch", rid, conc, 0)
            yield ("compute", comp[p])

    def emit_columns(self, space: AddressSpace) -> CompiledTrace:
        em = ColumnEmitter()
        seq, bounds, comp = self._sequence(space)
        for p in range(len(bounds) - 1):
            em.kernel()
            em.touches(seq[bounds[p]:bounds[p + 1]], self.concurrency)
            em.compute(comp[p])
        return em.finish()

    def work_units(self) -> float:
        return float(self.ops)


WORKLOADS: dict[str, type[Workload]] = {
    "stream": Stream,
    "conv2d": Conv2d,
    "jacobi2d": Jacobi2d,
    "bfs": BFS,
    "sgemm": Sgemm,
    "syr2k": Syr2k,
    "mvt": Mvt,
    "gesummv": Gesummv,
    "hotset": HotSet,
}


def make_workload(name: str, total_bytes: int, **kw) -> Workload:
    """Instantiate a Table-2 workload by name at the given footprint."""
    try:
        cls = WORKLOADS[name]
    except KeyError:
        raise ValueError(f"unknown workload {name!r}; "
                         f"available: {sorted(WORKLOADS)}") from None
    return cls(total_bytes, **kw)

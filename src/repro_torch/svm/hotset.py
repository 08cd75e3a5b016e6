"""Hot-set estimation from compiled-trace touch columns — the port's copy
of ``repro.svm.hotset``.

The paper's central finding is that SVM's aggressive whole-range
prefetch, in tandem with eviction, thrashes under oversubscription — and
the scheduler compounds it by admitting tenants by *total plan bytes*,
not by what they actually keep resident.  The engine's compiled traces
are exactly the access logs the DL-prefetch line of work learns from
(arXiv 2203.12672), so the measured alternative needs no new telemetry:
a `HotSetProfile` is derived **from the touch/rid columns of a
`CompiledTrace`** in one vectorised NumPy pass —

  * per-rid touch frequency (how often a range is accessed over the
    profiled window),
  * a reuse-interval histogram: for every re-touch of a rid, the bytes
    touched in between — log2-bucketed, the classic working-set curve,
  * per-rid mean/min reuse interval in bytes: ranges whose reuse
    interval exceeds the pool window cannot stay resident no matter what
    the eviction policy does (they *stream*); ranges under it form the
    measured hot set,
  * ``resident_bytes(window)``: the estimated resident working set at a
    given pressure — hot bytes plus one streaming buffer (the largest
    cold range, the room a cyclic scan needs in flight).

Profiles are a pure function of the trace's *relative* rid layout (rids
are stored relative to ``rid_base``), so congruent tenants — equal plan
`geometry()` — share one profile via `ProfileCache`, exactly like the
relocating `SegmentCache` shares compiled segments.

Consumers:

  * `StreamingExecutor(prefetch_mode="measured")` — pins only leaves
    above a touch-frequency threshold instead of prefetching every next
    layer (docs/prefetching.md),
  * `PoolScheduler(admit_by="measured")` — admission caps *estimated
    resident* bytes instead of total plan bytes,
  * `simulate(measured_pin=...)` — the sweep axis comparing measured
    against the paper's aggressive default on the hot-set adversaries.

This module never drives a manager: it only reads frozen op columns.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.engine import ColumnEmitter, CompiledTrace

#: log2 byte buckets of the reuse-interval histogram (2^0 .. 2^47)
REUSE_BUCKETS = 48


@dataclasses.dataclass(frozen=True)
class HotSetProfile:
    """Per-rid touch statistics over one profiled trace window.

    All rids are **relative** to the ``rid_base`` the profile was built
    with, so a profile computed for one tenant applies verbatim to every
    congruent tenant (same relative layout at a different pool offset).
    Arrays are aligned: entry ``i`` describes relative rid ``rids[i]``.
    """

    rids: np.ndarray          # int64, ascending — relative rids touched
    freq: np.ndarray          # int64 — touches per rid in the window
    sizes: np.ndarray         # int64 — bytes per rid
    reuse_min: np.ndarray     # float64 — min bytes between re-touches
    reuse_mean: np.ndarray    # float64 — mean bytes between re-touches
    reuse_hist: np.ndarray    # int64[REUSE_BUCKETS] — log2-bucketed
    n_touches: int            # total touches in the window
    touched_bytes: int        # sum of sizes over touched rids

    def __post_init__(self) -> None:
        for arr in (self.rids, self.freq, self.sizes, self.reuse_min,
                    self.reuse_mean, self.reuse_hist):
            arr.flags.writeable = False  # svmlint: disable=frozen-mutation -- freezing the profile's own freshly-built arrays (shared across congruent tenants), not un-freezing trace columns

    @classmethod
    def from_touches(cls, rid_seq: np.ndarray, size_arr: np.ndarray,
                     rid_base: int = 0) -> "HotSetProfile":
        """Profile a touch-ordered rid sequence in one NumPy pass.

        ``rid_seq`` is the absolute-rid touch column; ``size_arr`` maps
        absolute rid -> range bytes.  A rid touched once has infinite
        reuse interval (it never demonstrably re-uses its residency)."""
        seq = np.asarray(rid_seq, dtype=np.int64)
        n = len(seq)
        if n == 0:
            z = np.zeros(0, dtype=np.int64)
            return cls(rids=z, freq=z.copy(), sizes=z.copy(),
                       reuse_min=np.zeros(0), reuse_mean=np.zeros(0),
                       reuse_hist=np.zeros(REUSE_BUCKETS, dtype=np.int64),
                       n_touches=0, touched_bytes=0)
        sizes_t = np.asarray(size_arr, dtype=np.int64)[seq]
        u, inv, cnt = np.unique(seq, return_inverse=True,
                                return_counts=True)
        # previous-occurrence index per touch: stable sort groups equal
        # rids in touch order, so within a group each entry's predecessor
        # is that rid's previous touch
        order = np.argsort(seq, kind="stable")
        prev = np.full(n, -1, dtype=np.int64)
        same = seq[order[1:]] == seq[order[:-1]]
        prev[order[1:][same]] = order[:-1][same]
        # bytes touched strictly between a touch and its predecessor:
        # prefix sums of the per-touch sizes, exclusive on both ends
        cum = np.concatenate((np.zeros(1, dtype=np.int64),
                              np.cumsum(sizes_t)))
        idx = np.nonzero(prev >= 0)[0]
        gaps = (cum[idx] - cum[prev[idx] + 1]).astype(np.float64)
        reuse_min = np.full(len(u), np.inf)
        reuse_sum = np.zeros(len(u))
        reuse_cnt = np.zeros(len(u), dtype=np.int64)
        if len(idx):
            np.minimum.at(reuse_min, inv[idx], gaps)
            np.add.at(reuse_sum, inv[idx], gaps)
            np.add.at(reuse_cnt, inv[idx], np.ones(len(idx),
                                                   dtype=np.int64))
        reuse_mean = np.where(reuse_cnt > 0,
                              reuse_sum / np.maximum(reuse_cnt, 1),
                              np.inf)
        hist = np.zeros(REUSE_BUCKETS, dtype=np.int64)
        if len(gaps):
            buckets = np.clip(np.log2(gaps + 1.0).astype(np.int64), 0,
                              REUSE_BUCKETS - 1)
            hist = np.bincount(buckets,
                               minlength=REUSE_BUCKETS).astype(np.int64)
        usz = np.asarray(size_arr, dtype=np.int64)[u]
        return cls(rids=u - rid_base, freq=cnt.astype(np.int64),
                   sizes=usz, reuse_min=reuse_min, reuse_mean=reuse_mean,
                   reuse_hist=hist, n_touches=int(n),
                   touched_bytes=int(usz.sum()))

    @classmethod
    def from_trace(cls, ct: CompiledTrace, size_arr: np.ndarray,
                   rid_base: int = 0) -> "HotSetProfile":
        """Profile a compiled trace's touch columns (read-only)."""
        _, rid_col = ct.touch_columns()
        return cls.from_touches(rid_col, size_arr, rid_base=rid_base)

    # ----------------------------------------------------------- queries

    def hot_mask(self, window_bytes: float) -> np.ndarray:
        """Which touched rids can stay resident at the given pressure:
        mean reuse interval within the window (bytes).  Mean, not min —
        a streaming range that once re-touches back-to-back should not
        be promoted by a single lucky interval."""
        return self.reuse_mean <= float(window_bytes)

    def hot_bytes(self, window_bytes: float) -> int:
        """Bytes of the measured hot set at the given pressure."""
        return int(self.sizes[self.hot_mask(window_bytes)].sum())

    def resident_bytes(self, window_bytes: float) -> int:
        """Estimated resident working set at the given pressure: the hot
        set stays resident; everything else streams through one buffer
        sized by the largest cold range (the in-flight migration room a
        cyclic scan needs).  Untouched plan bytes cost nothing — that is
        the whole point of measuring."""
        hot = self.hot_mask(window_bytes)
        cold = self.sizes[~hot]
        buf = int(cold.max()) if len(cold) else 0
        return int(self.sizes[hot].sum()) + buf

    def select_hot_rids(self, window_bytes: float,
                        budget_bytes: float) -> np.ndarray:
        """The measured-prefetch pick: hot rids (by `hot_mask`), highest
        touch frequency first, cut off where cumulative bytes exceed
        ``budget_bytes``.  Returns *relative* rids, ascending — a
        deterministic set for any congruent tenant."""
        hot = np.nonzero(self.hot_mask(window_bytes))[0]
        if not len(hot):
            return np.zeros(0, dtype=np.int64)
        # stable order: frequency desc, then rid asc for ties
        order = hot[np.lexsort((self.rids[hot], -self.freq[hot]))]
        keep = order[np.cumsum(self.sizes[order]) <= float(budget_bytes)]
        return np.sort(self.rids[keep])


class ProfileCache:
    """Geometry-keyed profile memo: congruent tenants (equal plan
    geometry / equal `TraceKey`) share one `HotSetProfile` instead of
    re-deriving it per tenant.  Pure dict + counters — profiles are
    immutable, so sharing needs no relocation step."""

    def __init__(self) -> None:
        self._entries: dict = {}
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    def get_or_build(self, key, build) -> HotSetProfile:
        prof = self._entries.get(key)
        if prof is not None:
            self.hits += 1
            return prof
        self.misses += 1
        prof = self._entries[key] = build()
        return prof

    def stats(self) -> dict:
        return {"entries": len(self._entries), "hits": self.hits,
                "misses": self.misses}


def token_trace(leaf_ranges: dict, layer_paths, concurrency: int = 64,
                tokens: int = 1) -> CompiledTrace:
    """Lower ``tokens`` decode tokens of a spec-shaped fetch schedule
    into a compiled trace (touch columns only — no compute timing is
    needed to profile reuse).  ``tokens >= 2`` captures the cross-token
    reuse interval of every leaf, which one token cannot see."""
    em = ColumnEmitter()
    rid_cols = [np.asarray([rid for p in paths for rid in leaf_ranges[p]],
                           dtype=np.int64)
                for paths in layer_paths]
    for _ in range(max(1, int(tokens))):
        for rids in rid_cols:
            em.touches(rids, concurrency)
    return em.finish()


def spec_profile(spec, *, cache: ProfileCache | None = None,
                 concurrency: int = 64, tokens: int = 2) -> HotSetProfile:
    """Measured profile for a `ModelSpec`-shaped object (``leaves`` +
    ``layer_paths``), planned into a throwaway address space and
    profiled over ``tokens`` decode tokens.  With a ``cache``, congruent
    specs (same spec hash ⇒ same plan geometry by construction) build
    once and share."""
    def build() -> HotSetProfile:
        from repro_torch.svm.planner import plan_leaf_ranges

        plan = plan_leaf_ranges(list(spec.leaves),
                                max(int(spec.total_bytes), 1))
        ct = token_trace(plan.leaf_ranges, spec.layer_paths,
                         concurrency=concurrency, tokens=tokens)
        size_arr = np.asarray([r.end - r.start
                               for r in plan.space.ranges],
                              dtype=np.int64)
        return HotSetProfile.from_trace(ct, size_arr,
                                        rid_base=plan.rid_base)

    if cache is None:
        return build()
    return cache.get_or_build((spec, int(tokens)), build)

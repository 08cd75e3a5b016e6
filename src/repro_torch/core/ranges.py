"""Range construction — the SVM management unit (paper §2.1).

SVM manages unified memory in *ranges*: contiguous virtual spans produced by
splitting each managed allocation at device-alignment boundaries.

    alignment = pow2_floor(svm_capacity / 32), clamped to >= 2 MB
    (a 48 GB-class device => 1 GB alignment)

Ranges are additionally clipped to allocation boundaries, so an allocation
that crosses alignment boundaries comprises multiple ranges (paper Fig. 2:
three 1.5 GB allocations at a 175 MB base offset => 7 ranges, smallest
175 MB, largest 1 GB).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

KB = 1024
MB = 1024 * KB
GB = 1024 * MB

MIN_ALIGNMENT = 2 * MB
PAGE = 4 * KB  # host/device page size (faults are page-granular)
# managed allocations are placed after the platform's prior runtime
# reservations (paper Fig. 2) — the single source for every default base
DEFAULT_BASE = 175 * MB


def pow2_floor(x: int) -> int:
    """Largest power of two <= x (x >= 1)."""
    if x < 1:
        raise ValueError(f"pow2_floor requires x >= 1, got {x}")
    return 1 << (x.bit_length() - 1)


def svm_alignment(capacity_bytes: int) -> int:
    """Device alignment from SVM-managed capacity (paper §2.1)."""
    return max(MIN_ALIGNMENT, pow2_floor(capacity_bytes // 32))


@dataclasses.dataclass(frozen=True)
class Range:
    """A contiguous span of virtual pages — SVM's unit of migration/eviction."""

    rid: int
    alloc_id: int
    start: int  # virtual byte address, inclusive
    end: int    # virtual byte address, exclusive

    @property
    def size(self) -> int:
        return self.end - self.start

    @property
    def num_pages(self) -> int:
        return -(-self.size // PAGE)

    def contains(self, addr: int) -> bool:
        return self.start <= addr < self.end

    def __repr__(self) -> str:  # compact for profiles
        return f"R{self.rid}[a{self.alloc_id}:{self.start:#x}+{self.size >> 20}MB]"


@dataclasses.dataclass(frozen=True)
class Allocation:
    """One managed-memory allocation (hipMallocManaged analogue)."""

    alloc_id: int
    name: str
    start: int
    size: int

    @property
    def end(self) -> int:
        return self.start + self.size


def split_allocation(
    alloc: Allocation, alignment: int, first_rid: int
) -> list[Range]:
    """Split an allocation into ranges at alignment boundaries (paper §2.1).

    Every alignment boundary strictly inside the allocation starts a new
    range; range edges are clipped to the allocation's own boundaries.
    """
    cuts = [alloc.start]
    # first alignment boundary strictly greater than alloc.start
    b = (alloc.start // alignment + 1) * alignment
    while b < alloc.end:
        cuts.append(b)
        b += alignment
    cuts.append(alloc.end)
    return [
        Range(rid=first_rid + i, alloc_id=alloc.alloc_id, start=s, end=e)
        for i, (s, e) in enumerate(zip(cuts[:-1], cuts[1:]))
    ]


class AddressSpace:
    """The unified virtual address space: allocations and their ranges.

    Allocations are placed contiguously from ``base`` (the paper's platform
    places managed allocations after prior runtime reservations, which is why
    Fig. 2 shows non-aligned range edges — a 175 MB base reproduces it).
    """

    def __init__(self, capacity_bytes: int, base: int = 0,
                 alignment: int | None = None):
        self.capacity = capacity_bytes
        self.alignment = alignment or svm_alignment(capacity_bytes)
        self.base = base
        self._cursor = base
        self.allocations: list[Allocation] = []
        self.ranges: list[Range] = []
        self._ranges_by_alloc: dict[int, list[Range]] = {}
        self._size_arr: np.ndarray | None = None

    def size_array(self) -> np.ndarray:
        """Per-rid range sizes as int64 (cached; rids index `ranges`)."""
        arr = self._size_arr
        if arr is None or len(arr) != len(self.ranges):
            arr = np.array([r.size for r in self.ranges], dtype=np.int64)
            self._size_arr = arr
        return arr

    def pad_to_alignment(self) -> int:
        """Advance the allocation cursor to the next alignment boundary.

        The padded gap is unmanaged (no allocation, no ranges) — it models
        per-tenant placement padding in a shared pool: plans started on an
        alignment boundary have identical range geometry regardless of
        what was allocated before them, which is what makes compiled
        segments relocatable between same-architecture tenants.  Returns
        the number of padding bytes skipped."""
        pad = -self._cursor % self.alignment
        self._cursor += pad
        return pad

    def alloc(self, size: int, name: str = "") -> Allocation:
        a = Allocation(
            alloc_id=len(self.allocations),
            name=name or f"alloc{len(self.allocations)}",
            start=self._cursor,
            size=size,
        )
        self._cursor += size
        self.allocations.append(a)
        rs = split_allocation(a, self.alignment, first_rid=len(self.ranges))
        self.ranges.extend(rs)
        self._ranges_by_alloc[a.alloc_id] = rs
        return a

    def ranges_of(self, alloc: Allocation | int) -> list[Range]:
        aid = alloc if isinstance(alloc, int) else alloc.alloc_id
        return self._ranges_by_alloc[aid]

    def range_at(self, addr: int) -> Range:
        """Range containing a virtual address (binary search)."""
        lo, hi = 0, len(self.ranges) - 1
        while lo <= hi:
            mid = (lo + hi) // 2
            r = self.ranges[mid]
            if addr < r.start:
                hi = mid - 1
            elif addr >= r.end:
                lo = mid + 1
            else:
                return r
        raise KeyError(f"address {addr:#x} not in any managed range")

    def ranges_overlapping(self, start: int, end: int) -> Iterator[Range]:
        """All ranges intersecting [start, end)."""
        if end <= start:
            return
        r = self.range_at(start)
        idx = r.rid
        while idx < len(self.ranges) and self.ranges[idx].start < end:
            yield self.ranges[idx]
            idx += 1

    @property
    def total_managed(self) -> int:
        return self._cursor - self.base

    def dos(self) -> float:
        """Degree of oversubscription (%): used / available * 100 (paper §3.1)."""
        return self.total_managed / self.capacity * 100.0

"""Eviction policies over SVM ranges.

The paper's SVM uses **Least Recently Faulted (LRF)**: the victim is the
range whose last *serviceable fault* (≈ migration time) is oldest. Crucially
LRF never observes on-device reuse — a range that is being intensely read by
the kernel keeps its stale fault timestamp, which is the root cause of the
premature-eviction pathology for Category-III workloads (§3.2, §4.2).

Alternatives implemented for §4.2 ("Eviction Policy") and beyond-paper
comparisons:
  * LRU    — oracle-ish: victim is least recently *touched* (the paper deems
             true LRU too costly on hardware; we provide it as an upper bound).
  * CLOCK  — hot/cold second-chance bits, settable cheaply device-side; the
             paper's suggested practical middle ground.
  * RANDOM — baseline control.
"""

from __future__ import annotations

import random
from collections import OrderedDict


class EvictionPolicy:
    """Tracks candidate (resident, evictable) ranges and picks victims."""

    name = "base"

    def insert(self, rid: int, t: float) -> None:
        raise NotImplementedError

    def remove(self, rid: int) -> None:
        raise NotImplementedError

    def on_fault(self, rid: int, t: float) -> None:
        """A serviceable fault was recorded for a resident range."""

    def on_touch(self, rid: int, t: float) -> None:
        """The kernel touched a resident range (invisible to real LRF)."""

    def victim(self) -> int:
        raise NotImplementedError

    def __contains__(self, rid: int) -> bool:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError


class LRF(EvictionPolicy):
    """Least Recently Faulted — the paper's SVM policy (§2.2).

    Timestamps update only on serviceable faults. Since a serviceable fault
    immediately precedes the range's migration, LRF degenerates to FIFO in
    migration order, which is exactly the pathology the paper analyses.
    """

    name = "lrf"

    def __init__(self) -> None:
        self._q: OrderedDict[int, float] = OrderedDict()

    def insert(self, rid: int, t: float) -> None:
        self._q.pop(rid, None)
        self._q[rid] = t

    def remove(self, rid: int) -> None:
        self._q.pop(rid, None)

    def on_fault(self, rid: int, t: float) -> None:
        if rid in self._q:
            self._q.move_to_end(rid)
            self._q[rid] = t

    def victim(self) -> int:
        return next(iter(self._q))

    def __contains__(self, rid: int) -> bool:
        return rid in self._q

    def __len__(self) -> int:
        return len(self._q)


class LRU(EvictionPolicy):
    """Least Recently Used — observes device-side touches (upper bound)."""

    name = "lru"

    def __init__(self) -> None:
        self._q: OrderedDict[int, float] = OrderedDict()

    def insert(self, rid: int, t: float) -> None:
        self._q.pop(rid, None)
        self._q[rid] = t

    def remove(self, rid: int) -> None:
        self._q.pop(rid, None)

    def on_fault(self, rid: int, t: float) -> None:
        self.on_touch(rid, t)

    def on_touch(self, rid: int, t: float) -> None:
        if rid in self._q:
            self._q.move_to_end(rid)
            self._q[rid] = t

    def victim(self) -> int:
        return next(iter(self._q))

    def __contains__(self, rid: int) -> bool:
        return rid in self._q

    def __len__(self) -> int:
        return len(self._q)


class Clock(EvictionPolicy):
    """Second-chance CLOCK over ranges (paper §4.2's practical suggestion).

    Touches set a per-range reference bit (device-side metadata copy, no
    host round-trip). The victim scan clears bits until it finds a cold
    range.
    """

    name = "clock"

    def __init__(self) -> None:
        self._order: OrderedDict[int, bool] = OrderedDict()  # rid -> refbit

    def insert(self, rid: int, t: float) -> None:
        self._order.pop(rid, None)
        self._order[rid] = False

    def remove(self, rid: int) -> None:
        self._order.pop(rid, None)

    def on_fault(self, rid: int, t: float) -> None:
        self.on_touch(rid, t)

    def on_touch(self, rid: int, t: float) -> None:
        if rid in self._order:
            self._order[rid] = True

    def victim(self) -> int:
        # sweep: clear hot bits, giving each a second chance
        while True:
            rid, hot = next(iter(self._order.items()))
            if not hot:
                return rid
            self._order[rid] = False
            self._order.move_to_end(rid)

    def __contains__(self, rid: int) -> bool:
        return rid in self._order

    def __len__(self) -> int:
        return len(self._order)


class RandomPolicy(EvictionPolicy):
    name = "random"

    def __init__(self, seed: int = 0) -> None:
        self._rng = random.Random(seed)
        self._set: dict[int, None] = {}

    def insert(self, rid: int, t: float) -> None:
        self._set[rid] = None

    def remove(self, rid: int) -> None:
        self._set.pop(rid, None)

    def victim(self) -> int:
        return self._rng.choice(list(self._set))

    def __contains__(self, rid: int) -> bool:
        return rid in self._set

    def __len__(self) -> int:
        return len(self._set)


POLICIES = {p.name: p for p in (LRF, LRU, Clock, RandomPolicy)}


def make_policy(name: str) -> EvictionPolicy:
    """A fresh eviction-policy instance by name (lrf/lru/clock/random)."""
    try:
        return POLICIES[name]()
    except KeyError:
        raise ValueError(f"unknown eviction policy {name!r}; "
                         f"available: {sorted(POLICIES)}") from None

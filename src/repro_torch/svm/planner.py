"""Range planning over model parameters — the port's copy of
``repro.svm.planner``, walking torch param trees with
`repro_torch.bridge.leaf_sizes`.

Each parameter leaf is one managed allocation (the hipMallocManaged
analogue); the paper's alignment rule splits it into SVM ranges. The plan
maps leaves <-> range ids so the streaming executor can drive the
SVMManager's fault/migration/eviction machinery with real tensors.

Shared-pool planning (multi-tenant serving): `plan_leaf_ranges` can plan
into an **existing** `AddressSpace`, appending this tenant's allocations
after whatever is already placed there.  With ``align_start=True`` the
plan begins on an alignment boundary, so every same-architecture tenant
gets a congruent range layout (identical per-leaf range counts and
relative rids) — the precondition for relocating compiled trace segments
between tenants (`CompiledTrace.relocate`)."""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.bridge import leaf_sizes as tree_leaf_sizes
from repro_torch.core import AddressSpace, SVMManager
from repro_torch.core.costmodel import H100_HOST, CostParams
from repro_torch.core.ranges import DEFAULT_BASE


@dataclasses.dataclass
class ParamRanges:
    """The leaf ↔ range mapping for one planned parameter set.

    ``space`` may be private to this plan or shared with other tenants'
    plans (shared-pool serving); ``rid_base`` is the first range id this
    plan owns, and ``geometry()`` fingerprints the plan's relative range
    layout (equal geometry ⇒ compiled segments are relocatable between
    the two plans)."""

    space: AddressSpace
    leaf_ranges: dict[str, list[int]]      # leaf path -> range ids
    leaf_bytes: dict[str, int]
    hbm_budget: int
    rid_base: int = 0
    rid_to_leaf: dict[int, str] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        if not self.rid_to_leaf:
            self.rid_to_leaf = {rid: path
                                for path, rids in self.leaf_ranges.items()
                                for rid in rids}

    @property
    def total_bytes(self) -> int:
        return sum(self.leaf_bytes.values())

    def dos(self) -> float:
        """This plan's own degree of oversubscription (%) against the
        budget (a shared space's aggregate DOS is ``space.dos()``)."""
        return self.total_bytes / self.hbm_budget * 100.0

    def geometry(self) -> tuple:
        """Relative range layout: per-leaf (path, size, rid offsets from
        ``rid_base``).  Two plans with equal geometry are congruent — a
        segment recorded against one relocates onto the other by a pure
        rid shift."""
        return tuple(
            (path, self.leaf_bytes[path],
             tuple(rid - self.rid_base for rid in rids))
            for path, rids in self.leaf_ranges.items())

    def manager(self, *, policy: str = "lrf",
                params: CostParams = H100_HOST,
                **kw) -> SVMManager:
        """A fresh `SVMManager` over this plan's address space."""
        return SVMManager(self.space, policy=policy, params=params, **kw)

    def clone_into(self, space: AddressSpace) -> "ParamRanges":
        """A congruent copy of this plan at ``space``'s current cursor.

        The shared-pool fast path for repeated architectures: this plan's
        allocations and ranges replicate under constant address / rid /
        alloc-id shifts (both plans start on an alignment boundary of the
        same space, so every alignment cut lands at the same relative
        offset), skipping the per-leaf ``alloc``/`split_allocation` walk.
        Requires ``self`` to have been planned into the same ``space``
        with ``align_start=True`` — exactly how `PoolScheduler` plans
        tenants.  Congruence (`geometry()` equality) holds by
        construction."""
        from repro_torch.core.ranges import Allocation, Range

        space.pad_to_alignment()
        n_r = sum(len(rids) for rids in self.leaf_ranges.values())
        proto_ranges = space.ranges[self.rid_base:self.rid_base + n_r]
        aid0 = proto_ranges[0].alloc_id
        d_addr = space._cursor - proto_ranges[0].start
        d_rid = len(space.ranges) - self.rid_base
        d_aid = len(space.allocations) - aid0
        new_ranges = [Range(rid=r.rid + d_rid, alloc_id=r.alloc_id + d_aid,
                            start=r.start + d_addr, end=r.end + d_addr)
                      for r in proto_ranges]
        space.ranges.extend(new_ranges)
        for a in space.allocations[aid0:aid0 + len(self.leaf_bytes)]:
            space.allocations.append(Allocation(
                alloc_id=a.alloc_id + d_aid, name=a.name,
                start=a.start + d_addr, size=a.size))
            space._ranges_by_alloc[a.alloc_id + d_aid] = [
                new_ranges[r.rid - self.rid_base]
                for r in space._ranges_by_alloc[a.alloc_id]]
            space._cursor += a.size
        return ParamRanges(
            space=space,
            leaf_ranges={path: [rid + d_rid for rid in rids]
                         for path, rids in self.leaf_ranges.items()},
            leaf_bytes=dict(self.leaf_bytes),
            hbm_budget=self.hbm_budget,
            rid_base=self.rid_base + d_rid)


def plan_leaf_ranges(leaves: Sequence[tuple[str, int]], hbm_budget: int,
                     base: int = DEFAULT_BASE, *,
                     space: AddressSpace | None = None,
                     align_start: bool = False) -> ParamRanges:
    """Plan named byte-sized leaves into managed allocations + ranges.

    ``leaves`` is ``[(path, nbytes), ...]`` in fetch order.  Pass an
    existing ``space`` to co-tenant this plan with others in one shared
    pool; ``align_start=True`` pads the space's cursor to an alignment
    boundary first so congruent specs produce congruent plans."""
    if space is None:
        space = AddressSpace(hbm_budget, base=base)
    if align_start:
        space.pad_to_alignment()
    rid_base = len(space.ranges)
    leaf_ranges: dict[str, list[int]] = {}
    leaf_bytes: dict[str, int] = {}
    for path, nbytes in leaves:
        alloc = space.alloc(max(int(nbytes), 1), name=path)
        leaf_ranges[path] = [r.rid for r in space.ranges_of(alloc)]
        leaf_bytes[path] = int(nbytes)
    return ParamRanges(space=space, leaf_ranges=leaf_ranges,
                       leaf_bytes=leaf_bytes, hbm_budget=hbm_budget,
                       rid_base=rid_base)


def plan_param_ranges(params: dict, hbm_budget: int,
                      base: int = DEFAULT_BASE, *,
                      space: AddressSpace | None = None,
                      align_start: bool = False) -> ParamRanges:
    """Build the unified address space + range table for a param tree
    (nested dicts of tensors; leaves in `repro_torch.bridge.leaves`
    order, which is JAX's flattening order)."""
    return plan_leaf_ranges(tree_leaf_sizes(params), hbm_budget, base,
                            space=space, align_start=align_start)

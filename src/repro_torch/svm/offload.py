"""Activation offload scheduling — the paper's Jacobi2d insight applied to
training.

Forward writes per-layer activations into a fixed device pool; a second
pass re-reads them. The *order* of the second pass decides everything under
LRF/FIFO eviction (paper §3.2/§4.1):

  * "forward" (naive) — the second pass re-reads activations in FORWARD
    order. This is the access shape of remat-segment recomputation replays
    and pipeline-parallel microbatch replays, and it is exactly the
    paper's naive Jacobi2d: a cyclic traversal where FIFO evicts each
    activation right before it is needed — every read misses.
  * "reverse" (svm-aware) — the second pass runs last→first (what plain
    backprop does naturally, and what an SVM-aware recompute/pipeline
    schedule should do): the resident tail is consumed first, each spilled
    activation migrates back exactly once, and eager spill during forward
    moves evictions off the critical path (paper Alg. 2 + §4.2 parallel
    eviction).

Both passes are **emitted as ops** (touch / compute / spill) through a
`repro_torch.core.engine.TraceSession` and replayed on the batched engine —
the eager-spill loop is the `OP_SPILL` boundary op (drain `spill_oldest`
victims until the next activation fits).  ``engine="scalar"`` replays the
same recorded ops op-for-op through the manager — the imperative reference
path, byte-identical by the engine's equivalence guarantee.

The port's copy of ``repro.svm.offload``; its default cost model is the
H100 preset (`H100_HOST`).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import AddressSpace, SVMManager, TraceSession
from repro_torch.core.costmodel import CostParams, H100_HOST


@dataclasses.dataclass
class OffloadPlan:
    n_layers: int
    act_bytes: int              # bytes per layer-boundary activation
    budget_bytes: int           # device pool for activations
    order: str                  # "forward" (naive) | "reverse" (svm-aware)
    spill_overlap: float = 0.85  # eager-spill fraction hidden by compute

    @property
    def resident_layers(self) -> int:
        return max(1, self.budget_bytes // self.act_bytes)


def plan_offload(n_layers: int, act_bytes: int, budget_bytes: int,
                 svm_aware: bool = True) -> OffloadPlan:
    """An offload plan whose consume pass runs reverse (svm-aware) or
    forward (the naive cyclic-traversal baseline)."""
    return OffloadPlan(n_layers, act_bytes, budget_bytes,
                       "reverse" if svm_aware else "forward")


def record_offload(session: TraceSession, plan: OffloadPlan,
                   rids: list[int], *,
                   compute_per_layer_s: float = 0.0) -> None:
    """Record produce + consume as ops, one range per activation.

    Forward: (svm-aware only) an eager-spill op making room for the next
    activation — §4.2 parallel eviction, mostly off the critical path —
    then a write-allocate touch and the layer's compute.  Second pass:
    re-read touches in the plan's order, at backward compute cost."""
    for i in range(plan.n_layers):
        if plan.order == "reverse":
            session.spill(plan.act_bytes, overlap=plan.spill_overlap)
        session.touch(rids[i], concurrency=8)  # write-allocate
        session.compute(compute_per_layer_s)
    order = (range(plan.n_layers) if plan.order == "forward"
             else range(plan.n_layers - 1, -1, -1))
    for i in order:
        session.touch(rids[i], concurrency=8)
        session.compute(compute_per_layer_s * 2.0)


def simulate_offload(plan: OffloadPlan, *,
                     params: CostParams = H100_HOST,
                     compute_per_layer_s: float = 0.0,
                     engine: str = "session",
                     session_stats: dict | None = None) -> dict:
    """Run produce+consume through the SVM manager, one range per
    activation — recorded as ops and replayed as one compiled segment
    (``engine="session"``) or op-for-op (``engine="scalar"``)."""
    if engine not in ("session", "scalar"):
        raise ValueError(f"unknown engine {engine!r}; "
                         "available: 'session', 'scalar'")
    space = AddressSpace(plan.budget_bytes, base=0,
                         alignment=max(plan.act_bytes, 2 * 1024 * 1024))
    allocs = [space.alloc(plan.act_bytes, f"act{i}")
              for i in range(plan.n_layers)]
    rids = [space.ranges_of(a)[0].rid for a in allocs]
    mgr = SVMManager(space, policy="lrf", params=params)

    session = TraceSession(mgr, scalar=(engine == "scalar"))
    record_offload(session, plan, rids,
                   compute_per_layer_s=compute_per_layer_s)
    session.flush()
    if session_stats is not None:
        session_stats.update(session.stats())

    s = mgr.summary()
    s["order"] = plan.order
    s["resident_layers"] = plan.resident_layers
    return s

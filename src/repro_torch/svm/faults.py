"""Deterministic fault injection for the serving stack (chaos layer).

The paper's central finding — aggressive prefetch + eviction silently
degrades into thrashing under oversubscription — is exactly the failure
mode a production pool must *survive at runtime*.  This module supplies
the hazards; `PoolScheduler` supplies the recovery (docs/robustness.md).

A `FaultPlan` is a frozen, seeded schedule of `FaultEvent`s keyed by the
**global decoded-token counter** (the scheduler's deterministic progress
clock — never the host clock), covering four hazard classes:

  * ``capacity_loss`` / ``capacity_restore`` — a co-tenant grabs (or
    returns) pool bytes mid-run; applied via the public
    `SVMManager.resize_capacity` hook, forcing emergency eviction.
  * ``migration_fault`` — the next decoded token's migration raises
    `MigrationError` for the first ``fail_attempts`` attempts; recovered
    by the shared bounded-retry utility (`repro_torch.ft.retry`), backoff
    charged to the simulated clock.
  * ``slow_page`` / ``slow_page_end`` — a window of multiplicative
    migration-cost perturbation (UVM studies report order-of-magnitude
    migration-latency variance).
  * ``crash`` — the next decoding request dies mid-decode; recovered by
    eagerly draining its ranges and resuming from its `TraceSession`
    carried state.

The `FaultInjector` is pure bookkeeping: it consumes the plan against
the token counter and hands events back to the scheduler, which applies
every one of them through *public* manager/scheduler hooks only — this
module never drives a manager and is svmlint-clean by construction.
Same plan + same request mix ⇒ bit-identical runs.

The port's copy of ``repro.svm.faults``, with the same seeded draws.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

#: hazard vocabulary; "env" kinds perturb the environment, "token" kinds
#: target the next decoded token
ENV_KINDS = ("capacity_loss", "capacity_restore",
             "slow_page", "slow_page_end")
TOKEN_KINDS = ("migration_fault", "crash")
HAZARD_KINDS = ENV_KINDS + TOKEN_KINDS


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled hazard.

    ``at_tokens`` — fire once the global decoded-token counter reaches
    this value.  ``frac`` — capacity fraction of the *original* pool
    (capacity events) or migration-cost multiplier (slow-page events).
    ``fail_attempts`` — how many consecutive attempts the armed
    migration fault kills (recoverable while < the retry budget)."""

    at_tokens: int
    kind: str
    frac: float = 1.0
    fail_attempts: int = 1

    def __post_init__(self) -> None:
        if self.kind not in HAZARD_KINDS:
            raise ValueError(f"unknown hazard kind {self.kind!r}; "
                             f"available: {HAZARD_KINDS}")
        if self.at_tokens < 0:
            raise ValueError("at_tokens must be >= 0")
        if self.frac <= 0.0:
            raise ValueError("frac must be positive")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A frozen, seeded hazard schedule (see module docstring)."""

    events: tuple[FaultEvent, ...]
    seed: int = 0
    name: str = "custom"

    @classmethod
    def default(cls, seed: int = 0, *, n_requests: int = 64,
                tokens: int = 32, intensity: float = 1.0) -> "FaultPlan":
        """The default chaos mix over an ``n_requests × tokens`` run:
        one transient capacity dip (lose 35 % of the pool for ~15 % of
        the run), one 3× slow-page window (~10 % of the run), a handful
        of recoverable migration faults, and one mid-decode crash.
        Event positions are drawn from ``default_rng(seed)``; everything
        lands in the first 85 % of the token horizon so the whole plan
        is guaranteed to fire."""
        horizon = max(int(n_requests * tokens), 8)
        rng = np.random.default_rng(seed)

        def at(lo: float, hi: float) -> int:
            return int(horizon * (lo + (hi - lo) * float(rng.random())))

        events = []
        t_cap = at(0.15, 0.25)
        events.append(FaultEvent(t_cap, "capacity_loss", frac=0.65))
        events.append(FaultEvent(t_cap + max(1, int(horizon * 0.15)),
                                 "capacity_restore", frac=1.0))
        t_slow = at(0.45, 0.55)
        events.append(FaultEvent(t_slow, "slow_page", frac=3.0))
        events.append(FaultEvent(t_slow + max(1, int(horizon * 0.10)),
                                 "slow_page_end"))
        n_mf = max(1, int(round(3 * intensity)))
        for t in sorted(int(v) for v in
                        rng.integers(1, int(horizon * 0.85), size=n_mf)):
            events.append(FaultEvent(t, "migration_fault",
                                     fail_attempts=2))
        events.append(FaultEvent(at(0.55, 0.75), "crash"))
        events.sort(key=lambda e: (e.at_tokens, e.kind))
        return cls(events=tuple(events), seed=seed, name="default")


class FaultInjector:
    """Consumes a `FaultPlan` against the scheduler's token counter.

    Pure bookkeeping — the scheduler applies each returned event through
    public hooks.  Environment events (capacity, slow-page) drain
    eagerly via `due_env`; token-targeted events (migration fault,
    crash) pop **one per decoded token** via `pop_token_event`, so a
    burst of same-position token events lands on consecutive tokens
    instead of collapsing onto one."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        ordered = sorted(plan.events, key=lambda e: (e.at_tokens, e.kind))
        self._env = [e for e in ordered if e.kind in ENV_KINDS]
        self._tok = [e for e in ordered if e.kind in TOKEN_KINDS]
        self._env_idx = 0
        self._tok_idx = 0
        self.applied: list[FaultEvent] = []

    # ------------------------------------------------------------ queries

    @property
    def remaining(self) -> int:
        return (len(self._env) - self._env_idx) \
            + (len(self._tok) - self._tok_idx)

    def next_at(self) -> float:
        """Token position of the earliest unapplied event (``inf`` when
        the plan is drained) — the scheduler's fused-round lookahead."""
        nxt = math.inf
        if self._env_idx < len(self._env):
            nxt = min(nxt, self._env[self._env_idx].at_tokens)
        if self._tok_idx < len(self._tok):
            nxt = min(nxt, self._tok[self._tok_idx].at_tokens)
        return nxt

    # ------------------------------------------------------------ pumping

    def due_env(self, tokens: int) -> list[FaultEvent]:
        """Pop every environment event due at ``tokens``."""
        out = []
        while self._env_idx < len(self._env) and \
                self._env[self._env_idx].at_tokens <= tokens:
            ev = self._env[self._env_idx]
            self._env_idx += 1
            self.applied.append(ev)
            out.append(ev)
        return out

    def pop_token_event(self, tokens: int) -> FaultEvent | None:
        """Pop at most one token-targeted event due at ``tokens``."""
        if self._tok_idx < len(self._tok) and \
                self._tok[self._tok_idx].at_tokens <= tokens:
            ev = self._tok[self._tok_idx]
            self._tok_idx += 1
            self.applied.append(ev)
            return ev
        return None

    def stats(self) -> dict:
        return {
            "plan": self.plan.name,
            "seed": self.plan.seed,
            "events_total": len(self.plan.events),
            "events_applied": len(self.applied),
            "events_remaining": self.remaining,
        }

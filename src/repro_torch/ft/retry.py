"""Bounded retry with exponential backoff — the one retry primitive.

The port's copy of ``repro.ft.retry``. Every recovery loop of the port
(chaos-layer migration-fault recovery in `repro_torch.svm.scheduler`)
runs on this module, so retry behaviour is bounded and deterministic by
construction — the svmlint ``bounded-retry`` rule rejects ad-hoc
unbounded retry loops.

Two shapes:

  * `retry_call(fn, policy=...)` — the inverted form: the utility owns
    the loop, calls ``fn(attempt)`` up to ``policy.max_attempts`` times,
    and invokes ``on_backoff(attempt, delay_s)`` between attempts.  The
    caller decides what a backoff *costs*: the chaos scheduler charges
    the simulated clock (`SVMManager.inject_latency`), a real service
    would sleep.  Exhaustion raises `RetryError` (chained to the last
    failure).
  * `RetryBudget` — the incremental form for long-lived loops that
    cannot be inverted (the supervisor's step loop): an attempt ledger
    over the same `RetryPolicy`, spending one backoff delay per recorded
    failure and reporting exhaustion.

The backoff schedule is a pure function of the policy (no RNG, no wall
clock), so a fixed seed upstream gives bit-identical recovery timing.
"""

from __future__ import annotations

import dataclasses


class RetryError(RuntimeError):
    """Retry budget exhausted; ``last`` holds the final failure."""

    def __init__(self, attempts: int, last: BaseException | None = None):
        super().__init__(
            f"retry budget exhausted after {attempts} attempt(s)"
            + (f": {last!r}" if last is not None else ""))
        self.attempts = attempts
        self.last = last


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff: attempt ``k`` (1-based) waits
    ``base_delay_s * factor**(k-1)`` seconds, capped at ``max_delay_s``,
    for at most ``max_attempts`` attempts total."""

    max_attempts: int = 4
    base_delay_s: float = 1e-3
    factor: float = 2.0
    max_delay_s: float = float("inf")

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.base_delay_s < 0.0 or self.factor <= 0.0:
            raise ValueError("backoff delays must be non-negative")

    def delay(self, attempt: int) -> float:
        """Backoff after failed attempt ``attempt`` (1-based)."""
        d = self.base_delay_s * self.factor ** (max(attempt, 1) - 1)
        return min(d, self.max_delay_s)

    def schedule(self) -> tuple[float, ...]:
        """The full deterministic backoff schedule: the delay charged
        after each failed attempt that still has budget left."""
        return tuple(self.delay(k) for k in range(1, self.max_attempts))


DEFAULT_RETRY = RetryPolicy()


def retry_call(fn, *, policy: RetryPolicy = DEFAULT_RETRY,
               retry_on: tuple = (Exception,), on_backoff=None):
    """Call ``fn(attempt)`` (1-based) until it returns, retrying on
    ``retry_on`` with the policy's backoff; ``on_backoff(attempt,
    delay_s)`` charges each wait to whatever clock the caller owns.
    Raises `RetryError` (from the last failure) once the budget is
    spent."""
    last: BaseException | None = None
    # the attempt budget: at most policy.max_attempts invocations
    for attempt in range(1, policy.max_attempts + 1):
        try:
            return fn(attempt)
        except retry_on as e:
            last = e
            if attempt >= policy.max_attempts:
                raise RetryError(attempt, e) from e
            d = policy.delay(attempt)
            if on_backoff is not None:
                on_backoff(attempt, d)
    raise RetryError(policy.max_attempts, last)   # pragma: no cover


class RetryBudget:
    """Incremental attempt ledger over a `RetryPolicy`, for loops that
    cannot be inverted into `retry_call` (e.g. the supervisor's
    checkpoint/restart loop): `spend()` records one failed attempt and
    returns its backoff delay; `exhausted` reports when the budget is
    gone; `reset()` re-arms after sustained success."""

    def __init__(self, policy: RetryPolicy = DEFAULT_RETRY):
        self.policy = policy
        self.attempts = 0
        self.backoff_s = 0.0

    @property
    def remaining(self) -> int:
        return max(0, self.policy.max_attempts - self.attempts)

    @property
    def exhausted(self) -> bool:
        return self.attempts >= self.policy.max_attempts

    def spend(self) -> float:
        """Record one failed attempt; returns the backoff delay to
        charge before the next try."""
        self.attempts += 1
        d = self.policy.delay(self.attempts)
        self.backoff_s += d
        return d

    def reset(self) -> None:
        self.attempts = 0

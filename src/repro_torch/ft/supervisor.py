"""Fault tolerance of the training loop — the port's copy of
``repro.ft.supervisor``, on the port's checkpoint and retry.

Three mechanisms, as in the reference:

  1. **Checkpoint/restart** — the TrainSupervisor drives the step loop with
     periodic async checkpoints and restarts from the latest committed step
     after any failure (simulated here via exception injection). The step
     is functional and the data pipeline step-addressable, so a restart
     resumes where the last checkpoint left off.
  2. **Straggler mitigation** — per-step wall times feed a median-relative
     slowness check; hosts that exceed `threshold x median` for `patience`
     consecutive steps are flagged for eviction from the next elastic plan.
  3. **Elastic re-mesh** — on pod loss, `plan_elastic_remesh` computes the
     survivor mesh (dropping the pod axis entry) and the per-parameter
     resharding plan: ZeRO/FSDP shards owned by the dead pod are recovered
     from the last checkpoint, everything else reshapes in place. Global
     batch is preserved by raising per-pod microbatching. It is plain
     arithmetic on shapes, on a mesh's (shape, axes) as
     ``launch/mesh.py`` builds it.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable, Iterator

from repro_torch.checkpoint import CheckpointManager
from repro_torch.ft.retry import RetryBudget, RetryPolicy

PyTree = Any


# ------------------------------------------------------------- stragglers

class StragglerMonitor:
    """Per-step wall times feed a median-relative slowness check; each
    host's strike counting runs on a `RetryBudget` (``max_attempts =
    patience``): a slow step spends one attempt, a normal step re-arms,
    and an exhausted budget flags the host for the next elastic plan."""

    def __init__(self, threshold: float = 1.8, patience: int = 3,
                 window: int = 32):
        self.threshold = threshold
        self.patience = patience
        self.window = window
        self.history: dict[int, list[float]] = {}
        self._budgets: dict[int, RetryBudget] = {}

    @property
    def strikes(self) -> dict[int, int]:
        """Consecutive slow-step strikes per host (budget attempts)."""
        return {h: b.attempts for h, b in self._budgets.items()}

    def _budget(self, host: int) -> RetryBudget:
        b = self._budgets.get(host)
        if b is None:
            b = self._budgets[host] = RetryBudget(
                RetryPolicy(max_attempts=max(1, self.patience)))
        return b

    def record(self, host: int, step_time: float) -> None:
        self.history.setdefault(host, []).append(step_time)
        self.history[host] = self.history[host][-self.window:]

    def flagged(self) -> list[int]:
        if len(self.history) < 2:
            return []
        med = statistics.median(
            t for ts in self.history.values() for t in ts)
        out = []
        for host, ts in self.history.items():
            b = self._budget(host)
            if ts and ts[-1] > self.threshold * med:
                b.spend()
            else:
                b.reset()
            if b.exhausted:
                out.append(host)
        return out


# ------------------------------------------------------------ elastic mesh

@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    old_shape: tuple[int, ...]
    new_shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    lost_pods: tuple[int, ...]
    microbatch_scale: int          # multiply microbatches to keep batch
    resharding: str                # "restore_from_checkpoint" | "in_place"

    @property
    def surviving_chips(self) -> int:
        n = 1
        for s in self.new_shape:
            n *= s
        return n


def plan_elastic_remesh(shape: tuple[int, ...], axes: tuple[str, ...],
                        lost_pods: tuple[int, ...],
                        zero_sharded: bool) -> ElasticPlan:
    """Survivor mesh after losing pods. The pod axis is pure DP(+ZeRO), so
    the program is identical on the survivor mesh; ZeRO state owned by dead
    pods exists only in the checkpoint -> restore path required."""
    if "pod" not in axes:
        raise ValueError("elastic re-mesh requires a pod axis")
    pidx = axes.index("pod")
    pods = shape[pidx]
    survivors = pods - len(lost_pods)
    if survivors < 1:
        raise ValueError("no surviving pods")
    new_shape = list(shape)
    new_shape[pidx] = survivors
    scale = -(-pods // survivors)
    return ElasticPlan(
        old_shape=tuple(shape),
        new_shape=tuple(new_shape),
        axis_names=axes,
        lost_pods=tuple(lost_pods),
        microbatch_scale=scale,
        resharding="restore_from_checkpoint" if zero_sharded else "in_place",
    )


# ------------------------------------------------------------- supervisor

class TrainSupervisor:
    """Runs a step function under checkpoint/restart + straggler watch.

    Restart accounting runs on the shared `RetryBudget`
    (``max_attempts = max_restarts``): every failure spends one attempt
    and its deterministic exponential-backoff delay is ledgered in
    ``budget.backoff_s``; once the budget is exhausted the original
    failure re-raises."""

    def __init__(self, ckpt: CheckpointManager, *, max_restarts: int = 3,
                 retry_policy: RetryPolicy | None = None):
        self.ckpt = ckpt
        self.max_restarts = max_restarts
        if retry_policy is None:
            retry_policy = RetryPolicy(
                max_attempts=max(1, max_restarts), base_delay_s=1.0,
                max_delay_s=60.0)
        self.budget = RetryBudget(retry_policy)
        self.monitor = StragglerMonitor()
        self.log: list[str] = []

    @property
    def restarts(self) -> int:
        return self.budget.attempts

    def run(
        self,
        init_state: PyTree,
        step_fn: Callable[[int, PyTree], PyTree],
        steps: int,
        *,
        failure_injector: Callable[[int], None] | None = None,
    ) -> tuple[int, PyTree]:
        state = init_state
        step = 0
        restored = self.ckpt.restore_latest(init_state)
        if restored is not None:
            step, state = restored
            self.log.append(f"resumed from step {step}")
        while step < steps:
            try:
                if failure_injector is not None:
                    failure_injector(step)
                t0 = time.time()
                state = step_fn(step, state)
                self.monitor.record(0, time.time() - t0)
                step += 1
                self.ckpt.maybe_save(step, state, blocking=True)
            except Exception as e:  # noqa: BLE001 — restart path
                self.log.append(f"failure at step {step}: {e!r}")
                if self.max_restarts < 1 or self.budget.exhausted:
                    raise
                delay = self.budget.spend()
                self.log.append(
                    f"backoff {delay:g}s "
                    f"({self.budget.remaining} restart(s) left)")
                restored = self.ckpt.restore_latest(init_state)
                if restored is None:
                    state, step = init_state, 0
                else:
                    step, state = restored
                self.log.append(f"restarted from step {step}")
        self.ckpt.wait()
        return step, state

"""The elastic parallelism policy: the port of
``kubeml_tpu/scheduler/policy.py``.

``ThroughputBasedPolicy`` compares each epoch's elapsed time with the
job's previous epoch: within 1.05x of it the job doubles its workers,
1.2x or slower it halves them, in between it holds. Worker counts move in
powers of two (1, 2, 4, 8, ...) up to the cap floored to a power of two.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Protocol, Tuple

from ..api.types import JobState
from .decisions import DecisionLog, REASONS, ScaleDecision

# an epoch within 1.05x of the cached time scales up; one 1.2x or slower
# scales down
SPEEDUP_THRESHOLD = 1.05
SLOWDOWN_THRESHOLD = 1.2

# how many finished job ids to remember for stale-update dropping
FINISHED_MEMORY = 1024


def next_power_up(p: int, cap: int) -> int:
    """Next topology-legal level above p (doubles, capped)."""
    if p < 1:
        return 1
    n = 1
    while n <= p:
        n *= 2
    return min(n, cap)


def next_power_down(p: int) -> int:
    """Next topology-legal level below p (halves, floor 1)."""
    if p <= 1:
        return 1
    n = 1
    while n * 2 < p:
        n *= 2
    return n


class SchedulerPolicy(Protocol):
    """The scheduler's policy interface."""

    def calculate_parallelism(self, task) -> Optional[Tuple[int, bool]]:
        """Returns (parallelism, is_new_task), or None to drop a stale update."""
        ...

    def task_finished(self, job_id: str) -> None: ...


class ThroughputBasedPolicy:
    """Per-job epoch-time cache driving topology-legal scale decisions."""

    def __init__(self, default_parallelism: int, max_parallelism: int, limit_parallelism: bool = False):
        self.default_parallelism = default_parallelism
        # floor the cap to a power of two so scale-up never lands on a
        # topology-illegal level (e.g. cap 6 -> levels 1,2,4)
        self.max_parallelism = next_power_down(max(1, max_parallelism) + 1)
        # limit_parallelism (LIMIT_PARALLELISM) freezes scale-up
        self.limit_parallelism = limit_parallelism
        self._time_cache: Dict[str, float] = {}
        # insertion-ordered bounded set of finished job ids (stale-update guard)
        self._finished: Dict[str, None] = {}
        self._lock = threading.Lock()
        # scale-decision audit trail (scheduler.decisions): bound by the
        # scheduler; None = decisions are not recorded (bare policy in tests)
        self.decision_log: Optional[DecisionLog] = None

    def bind_decision_log(self, log: DecisionLog) -> None:
        self.decision_log = log

    def _record(self, job_id: str, from_p: int, to_p: int, reason: str,
                cached: Optional[float], elapsed: Optional[float]) -> None:
        """Audit one outcome (no-op without a bound log). Inputs that the
        JSON wire cannot carry (the infinity cache seed, the <0 first-call
        elapsed sentinel) are recorded as None."""
        if self.decision_log is None:
            return
        if cached is not None and cached == float("inf"):
            cached = None
        self.decision_log.record(ScaleDecision(
            job_id=job_id, from_p=from_p, to_p=to_p,
            direction=REASONS[reason][0], reason=reason,
            cached=cached, elapsed=elapsed,
            speedup_threshold=SPEEDUP_THRESHOLD,
            slowdown_threshold=SLOWDOWN_THRESHOLD,
            cap=self.max_parallelism,
            limit_parallelism=self.limit_parallelism,
        ))

    def calculate_parallelism(self, task) -> Optional[Tuple[int, bool]]:
        """Returns (parallelism, is_new), or ``None`` when the update is stale
        (its job already finished) and must be dropped. is_new is decided by
        the task itself (a fresh submission has no elapsed time yet), NOT by
        cache state. Finished-job bookkeeping lives here, under the same lock
        as the cache, so a concurrent task_finished can never interleave
        between a staleness check and a cache reseed."""
        job_id = task.job_id
        state: JobState = task.state
        with self._lock:
            if state.elapsed_time < 0:
                # fresh submission: start at the request's default (policy.go:58-64)
                self._finished.pop(job_id, None)  # allow job-id reuse
                p = task.parameters.options.default_parallelism or self.default_parallelism
                p = max(1, min(p, self.max_parallelism))
                self._time_cache[job_id] = float("inf")
                self._record(job_id, 0, p, "new-task", None, None)
                return p, True
            if job_id in self._finished:
                p = max(0, state.parallelism)
                self._record(job_id, p, p, "stale-drop", None,
                             state.elapsed_time)
                return None
            cached = self._time_cache.get(job_id)
            if cached is None:
                # unseen live job (e.g. policy swapped mid-run): keep the current
                # parallelism but reseed the cache so elasticity resumes next
                # epoch.
                self._time_cache[job_id] = state.elapsed_time
                p = max(1, state.parallelism)
                self._record(job_id, p, p, "reseed", None, state.elapsed_time)
                return p, False
            p = max(1, state.parallelism)
            elapsed = state.elapsed_time
            if elapsed <= cached * SPEEDUP_THRESHOLD and not self.limit_parallelism:
                new_p = next_power_up(p, self.max_parallelism)
                reason = "speedup" if new_p > p else "at-cap"
            elif elapsed >= cached * SLOWDOWN_THRESHOLD:
                new_p = next_power_down(p)
                reason = "slowdown" if new_p < p else "at-floor"
            else:
                new_p = p
                reason = ("limited" if (self.limit_parallelism
                                        and elapsed <= cached * SPEEDUP_THRESHOLD)
                          else "steady")
            self._time_cache[job_id] = elapsed
            self._record(job_id, p, new_p, reason, cached, elapsed)
            return new_p, False

    def task_finished(self, job_id: str) -> None:
        with self._lock:
            self._time_cache.pop(job_id, None)
            self._finished[job_id] = None
            while len(self._finished) > FINISHED_MEMORY:
                self._finished.pop(next(iter(self._finished)))

"""The scale-decision audit trail of the elastic parallelism policy: the
port of ``kubeml_tpu/scheduler/decisions.py``.

Every ``calculate_parallelism`` outcome (scale up, scale down, hold, a
fresh start, a cache reseed, a stale-update drop) is recorded with the
inputs the policy read (cached epoch time, this epoch's elapsed time, the
two thresholds, the power-of-two cap, the limit flag) and a reason from a
closed vocabulary (:data:`REASONS`; ``record`` refuses any other). A job
keeps its ``per_job`` newest decisions and the log ``max_jobs`` jobs;
:meth:`DecisionLog.counts` is a separate cumulative counter keyed
``(direction, reason)`` (``kubeml_scale_decisions_total``), which
eviction never lowers.
"""

from __future__ import annotations

import threading
import time
from collections import Counter, OrderedDict, deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# transition directions (the from->to shape of a decision)
DIRECTIONS = ("up", "down", "hold", "new", "reseed", "drop")

# the closed reason vocabulary: {reason: (direction, meaning)}. A reason
# emitted by the policy but absent here fails loudly at record time; a
# reason listed here the policy can never emit fails the drift-guard test.
REASONS: Dict[str, Tuple[str, str]] = {
    "new-task": ("new", "fresh submission: start at the requested/default "
                        "parallelism, epoch-time cache seeded at infinity"),
    "speedup": ("up", "epoch stayed within the speedup threshold of the "
                      "cached time: double (topology-legal) workers"),
    "at-cap": ("hold", "epoch earned a scale-up but parallelism already "
                       "sits at the pow2-floored cap"),
    "limited": ("hold", "epoch earned a scale-up but LIMIT_PARALLELISM "
                        "freezes growth"),
    "slowdown": ("down", "epoch exceeded the slowdown threshold of the "
                         "cached time: halve workers"),
    "at-floor": ("hold", "epoch earned a scale-down but parallelism is "
                         "already 1"),
    "steady": ("hold", "epoch landed in the dead zone between the "
                       "thresholds: keep parallelism"),
    "reseed": ("reseed", "live job unseen by this policy (e.g. policy "
                         "swapped mid-run): keep parallelism, reseed the "
                         "epoch-time cache"),
    "stale-drop": ("drop", "the job already finished: drop the queued "
                           "epoch-end update instead of rescheduling it"),
}

# bounded-retention defaults (overridable via KUBEML_DECISION_LOG_* /
# api.config.Config.decision_log_size / decision_log_jobs)
DEFAULT_PER_JOB = 64
DEFAULT_MAX_JOBS = 256


@dataclass
class ScaleDecision:
    """One audited policy outcome. ``from_p``/``to_p`` are the transition;
    ``inputs`` carries everything the policy read to decide it."""

    job_id: str
    from_p: int
    to_p: int
    direction: str
    reason: str
    # decision inputs: cached epoch seconds (None on the first report —
    # the cache seeds at infinity, which JSON cannot carry), this epoch's
    # elapsed seconds (None for a fresh submission), thresholds, cap, flag
    cached: Optional[float] = None
    elapsed: Optional[float] = None
    speedup_threshold: float = 0.0
    slowdown_threshold: float = 0.0
    cap: int = 0
    limit_parallelism: bool = False
    t: float = field(default_factory=time.time)
    seq: int = 0  # per-job monotonic sequence, assigned by the log

    def to_dict(self) -> dict:
        return {
            "job_id": self.job_id,
            "seq": self.seq,
            "t": self.t,
            "from": self.from_p,
            "to": self.to_p,
            "direction": self.direction,
            "reason": self.reason,
            "inputs": {
                "cached": self.cached,
                "elapsed": self.elapsed,
                "speedup_threshold": self.speedup_threshold,
                "slowdown_threshold": self.slowdown_threshold,
                "cap": self.cap,
                "limit_parallelism": self.limit_parallelism,
            },
        }


class DecisionLog:
    """Bounded per-job ring of :class:`ScaleDecision` + cumulative
    ``(direction, reason)`` counters (thread-safe; the policy records under
    its own lock and the exposition reads concurrently)."""

    def __init__(self, per_job: int = DEFAULT_PER_JOB,
                 max_jobs: int = DEFAULT_MAX_JOBS):
        self.per_job = max(1, int(per_job))
        self.max_jobs = max(1, int(max_jobs))
        self._jobs: "OrderedDict[str, deque]" = OrderedDict()
        # per-job ever-recorded counters; outlives ring eviction (bounded
        # at 8x max_jobs by recency — an int per id, far cheaper than rings)
        self._seq: "OrderedDict[str, int]" = OrderedDict()
        self._counts: Counter = Counter()
        self._lock = threading.Lock()

    def record(self, d: ScaleDecision) -> ScaleDecision:
        """Validate + append one decision; returns it with ``seq`` set."""
        if d.reason not in REASONS:
            raise ValueError(
                f"unenumerated scale-decision reason {d.reason!r} "
                f"(add it to scheduler.decisions.REASONS)")
        expect_dir = REASONS[d.reason][0]
        if d.direction != expect_dir:
            raise ValueError(
                f"reason {d.reason!r} maps to direction {expect_dir!r}, "
                f"got {d.direction!r}")
        with self._lock:
            ring = self._jobs.get(d.job_id)
            if ring is None:
                # ring eviction keeps the SEQ counter: a long-lived job
                # whose ring was evicted by newer jobs must not restart at
                # seq 1 (the per-job sequence is documented monotonic and
                # total() counts ever-recorded). The counter map has its
                # own, far larger recency bound below.
                while len(self._jobs) >= self.max_jobs:
                    self._jobs.popitem(last=False)
                ring = self._jobs[d.job_id] = deque(maxlen=self.per_job)
            else:
                self._jobs.move_to_end(d.job_id)  # recency, not insertion
            d.seq = self._seq.get(d.job_id, 0) + 1
            self._seq[d.job_id] = d.seq
            self._seq.move_to_end(d.job_id)
            while len(self._seq) > self.max_jobs * 8:
                self._seq.popitem(last=False)
            ring.append(d)
            self._counts[(d.direction, d.reason)] += 1
        return d

    def for_job(self, job_id: str) -> List[dict]:
        """The retained decisions of one job, oldest first (JSON-ready)."""
        with self._lock:
            ring = self._jobs.get(job_id)
            return [d.to_dict() for d in ring] if ring else []

    def jobs(self) -> List[str]:
        with self._lock:
            return list(self._jobs)

    def counts(self) -> Dict[Tuple[str, str], int]:
        """Cumulative {(direction, reason): n} — the counter export; never
        decremented by retention eviction."""
        with self._lock:
            return dict(self._counts)

    def total(self, job_id: str) -> int:
        """Decisions EVER recorded for a job (>= len(for_job) once the ring
        wraps)."""
        with self._lock:
            return self._seq.get(job_id, 0)

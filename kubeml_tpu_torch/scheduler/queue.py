"""The scheduler's work queue: the port of ``kubeml_tpu/scheduler/queue.py``.

It holds new train tasks and the epoch-end re-evaluation requests of
running jobs; the scheduler loop pops one at a time, blocking on a
condition variable. Pop order is (priority class, highest first; the
tenant with the fewest device-seconds charged so far
(:class:`TenantUsage`); arrival order). One class of one tenant is a plain
FIFO.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from ..api.types import TrainTask


class TenantUsage:
    """Accumulated device-seconds per tenant — the fair-share currency.

    Charged by the scheduler on every epoch-end report (parallelism x epoch
    seconds: what the tenant actually held, not what it asked for). Decay is
    absent: fair share lasts the life of the process; a restart
    forgives."""

    def __init__(self):
        self._seconds: Dict[str, float] = {}
        self._lock = threading.Lock()

    def charge(self, tenant: str, device_seconds: float) -> None:
        if device_seconds <= 0:
            return
        with self._lock:
            self._seconds[tenant] = self._seconds.get(tenant, 0.0) + float(
                device_seconds)

    def get(self, tenant: str) -> float:
        with self._lock:
            return self._seconds.get(tenant, 0.0)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._seconds)


def task_priority(task: TrainTask) -> int:
    try:
        return int(task.parameters.options.priority)
    except (AttributeError, TypeError, ValueError):
        return 0


def task_tenant(task: TrainTask) -> str:
    try:
        return str(task.parameters.options.tenant or "")
    except AttributeError:
        return ""


class TaskQueue:
    def __init__(self, usage: Optional[TenantUsage] = None):
        # entries in arrival order: [(seq, task)]; selection scans — queue
        # depths are human-scale (jobs, not requests), so O(n) pop beats a
        # heap that cannot express the usage-dependent tenant tie-break
        self._q: List[tuple] = []
        self._seq = 0
        self.usage = usage or TenantUsage()
        self._cond = threading.Condition()

    def push(self, task: TrainTask) -> None:
        with self._cond:
            self._q.append((self._seq, task))
            self._seq += 1
            self._cond.notify()

    def _select(self) -> int:
        """Index of the entry to pop next (caller holds the lock):
        highest priority class; within it the least-charged tenant; within
        the tenant, arrival order."""
        best = 0
        best_key = None
        for i, (seq, task) in enumerate(self._q):
            key = (-task_priority(task),
                   self.usage.get(task_tenant(task)),
                   seq)
            if best_key is None or key < best_key:
                best, best_key = i, key
        return best

    def pop(self, timeout: Optional[float] = None) -> Optional[TrainTask]:
        """Pop the next item by (priority, fair share, FIFO), blocking up to
        ``timeout`` seconds; None if empty."""
        with self._cond:
            if not self._q:
                self._cond.wait(timeout)
            if not self._q:
                return None
            return self._q.pop(self._select())[1]

    def job_ids(self) -> set:
        """Snapshot of the job ids currently queued (duplicate-submit guard)."""
        with self._cond:
            return {t.job_id for _, t in self._q}

    def depths(self) -> Dict[int, int]:
        """{priority class: queued count} — the per-priority queue gauges."""
        out: Dict[int, int] = {}
        with self._cond:
            for _, t in self._q:
                p = task_priority(t)
                out[p] = out.get(p, 0) + 1
        return out

    def snapshot(self) -> List[dict]:
        """Queued entries in pop order (the `kubeml jobs` listing)."""
        with self._cond:
            entries = list(self._q)
        entries.sort(key=lambda e: (-task_priority(e[1]),
                                    self.usage.get(task_tenant(e[1])),
                                    e[0]))
        return [{
            "job_id": t.job_id,
            "status": "queued",
            "priority": task_priority(t),
            "tenant": task_tenant(t),
            "function": t.parameters.function_name,
            "resume": bool(t.parameters.options.resume),
        } for _, t in entries]

    def __len__(self) -> int:
        with self._cond:
            return len(self._q)

"""The parameter server's span collector: the port of
``kubeml_tpu/ps/traces.py``.

Job runners and followers POST their finished spans to the parameter
server (``/traces/{task_id}``, ``ps.transport``) when a job ends; the
controller's ``GET /tasks/{id}/trace`` merges them with the control
plane's own spans into one tree, which ``kubeml trace <task-id>`` writes
as one Chrome/Perfetto file. Bounded per task and across tasks; the
oldest task is evicted first.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List

# traces are a debugging record, not a database
MAX_TASKS = 64
MAX_SPANS_PER_TASK = 50_000


class TraceStore:
    """Thread-safe {task_id: [span dicts]} under a task and a span cap."""

    def __init__(self, max_tasks: int = MAX_TASKS,
                 max_spans_per_task: int = MAX_SPANS_PER_TASK):
        self.max_tasks = max_tasks
        self.max_spans_per_task = max_spans_per_task
        self._tasks: "OrderedDict[str, List[dict]]" = OrderedDict()
        # {task: {service: data-plane counter snapshot}} delivered with the
        # spans (the per-process byte budgets of `kubeml profile`)
        self._counters: Dict[str, Dict[str, dict]] = {}
        self._dropped: Dict[str, int] = {}
        self._lock = threading.Lock()

    def _bucket(self, task_id: str) -> List[dict]:
        """The task's spans, made (evicting the oldest task past the cap)
        when new; the caller holds the lock."""
        bucket = self._tasks.get(task_id)
        if bucket is None:
            bucket = self._tasks[task_id] = []
            while len(self._tasks) > self.max_tasks:
                evicted, _ = self._tasks.popitem(last=False)
                self._dropped.pop(evicted, None)
                self._counters.pop(evicted, None)
        return bucket

    def add(self, task_id: str, spans: List[dict]) -> int:
        """Append a task's spans; returns how many were kept."""
        kept = 0
        with self._lock:
            bucket = self._bucket(task_id)
            for s in spans:
                if not isinstance(s, dict):
                    continue
                if len(bucket) < self.max_spans_per_task:
                    bucket.append(s)
                    kept += 1
                else:
                    self._dropped[task_id] = self._dropped.get(task_id, 0) + 1
        return kept

    def add_counters(self, task_id: str, service: str,
                     counters: dict) -> None:
        """Attach a process's counter snapshot to a task (the latest per
        service wins), under the same eviction as the spans."""
        if not isinstance(counters, dict):
            return
        with self._lock:
            self._bucket(task_id)
            self._counters.setdefault(task_id, {})[str(service)] = counters

    def get(self, task_id: str) -> List[dict]:
        with self._lock:
            return list(self._tasks.get(task_id, ()))

    def get_counters(self, task_id: str) -> Dict[str, dict]:
        with self._lock:
            return {svc: dict(c)
                    for svc, c in self._counters.get(task_id, {}).items()}

    def dropped(self, task_id: str) -> int:
        with self._lock:
            return self._dropped.get(task_id, 0)

    def clear(self, task_id: str) -> None:
        with self._lock:
            self._tasks.pop(task_id, None)
            self._counters.pop(task_id, None)
            self._dropped.pop(task_id, None)

"""Failure injection and worker-health tracking: the port's copy of
``kubeml_tpu/engine/failures.py``.

* :class:`FailureInjector` - deterministic chaos: marks workers failed per
  round by probability and/or an explicit schedule, drawing from the same
  numpy random stream as the JAX package's, so the masks are identical
  for the same seed. The K-AVG engine leaves masked workers out of the
  weight average.
* :class:`WorkerHealth` - consecutive-failure tracking; a worker dead for
  ``threshold`` straight rounds is reported persistent, and the job
  shrinks its parallelism at the epoch boundary.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set

import numpy as np

class FailureInjector:
    """Chaos source for K-AVG rounds.

    ``prob``: per-worker per-round failure probability.
    ``schedule``: {round_index: [worker indices]} forced failures (global round
    counter across the job, not per-epoch).
    ``keep_one_alive``: never fail every worker at once (the all-dead round is
    a hard MergeError by design — set False to test exactly that).
    """

    def __init__(
        self,
        prob: float = 0.0,
        schedule: Optional[Dict[int, Sequence[int]]] = None,
        seed: int = 0,
        keep_one_alive: bool = True,
    ):
        if not (0.0 <= prob <= 1.0):
            raise ValueError("prob must be in [0, 1]")
        self.prob = prob
        self.schedule = {int(k): set(v) for k, v in (schedule or {}).items()}
        self.keep_one_alive = keep_one_alive
        self._rng = np.random.default_rng(seed)
        self._round = 0

    def mask(self, n_workers: int) -> np.ndarray:
        """Worker mask for the next round: 1.0 healthy, 0.0 failed."""
        m = np.ones(n_workers, np.float32)
        if self.prob > 0.0:
            m[self._rng.random(n_workers) < self.prob] = 0.0
        for w in self.schedule.get(self._round, ()):
            if 0 <= w < n_workers:
                m[w] = 0.0
        if self.keep_one_alive and m.sum() == 0.0:
            m[int(self._rng.integers(n_workers))] = 1.0
        self._round += 1
        return m


class WorkerHealth:
    """Consecutive-failure bookkeeping across sync rounds.

    ``update(mask)`` returns the workers that just crossed the persistence
    threshold; ``suggest_parallelism(n)`` is the health-shrunk worker count for
    the next epoch's resize."""

    def __init__(self, threshold: int = 3):
        if threshold < 1:
            raise ValueError("threshold must be >= 1")
        self.threshold = threshold
        self._consecutive: Dict[int, int] = {}
        self._persistent: Set[int] = set()

    def update(self, mask: np.ndarray) -> List[int]:
        newly_persistent = []
        for w, healthy in enumerate(np.asarray(mask)):
            if healthy > 0.0:
                self._consecutive[w] = 0
                self._persistent.discard(w)
            else:
                c = self._consecutive.get(w, 0) + 1
                self._consecutive[w] = c
                if c == self.threshold and w not in self._persistent:
                    self._persistent.add(w)
                    newly_persistent.append(w)
        return newly_persistent

    @property
    def persistent(self) -> Set[int]:
        return set(self._persistent)

    def reset(self) -> None:
        self._consecutive.clear()
        self._persistent.clear()

    def suggest_parallelism(self, current: int) -> int:
        """Shrink by the number of persistently dead workers (floor 1). After a
        resize worker indices are renumbered, so bookkeeping resets."""
        dead = len([w for w in self._persistent if w < current])
        return max(1, current - dead)

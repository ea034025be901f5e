"""Preemption controller: reclaim training capacity under serving
pressure. The port of ``kubeml_tpu/scheduler/preemption.py``, with the
same decisions on the same telemetry.

* **watch** — poll the resident decoders' telemetry
  (``ParameterServer.serving_telemetry``) every ``KUBEML_PREEMPT_INTERVAL``
  seconds; serving is *overloaded* when any signal crosses its threshold
  (queued rows >= ``KUBEML_PREEMPT_QUEUE_DEPTH``, 429 rate >=
  ``KUBEML_PREEMPT_OVERLOAD_RATE``/s, request p99 >= ``KUBEML_PREEMPT_P99``
  when set);
* **reclaim** — after ``KUBEML_PREEMPT_SUSTAIN`` consecutive overloaded
  polls, preempt the LOWEST-priority running job (ties: the tenant with the
  most accumulated device-seconds yields first, then the job id); at most
  one preemption per ``KUBEML_PREEMPT_COOLDOWN`` seconds;
* **requeue** — the yielded job arrives PARKED (``Scheduler.job_preempted``
  -> :meth:`PreemptionController.park`); after
  ``KUBEML_PREEMPT_RESUME_SUSTAIN`` consecutive calm polls every parked
  job is resubmitted with ``resume=True`` under its own id. The journal
  keeps a parked job across a control-plane crash.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, Optional

from ..api.config import Config, get_config
from ..api.errors import KubeMLError
from ..api.types import JobStateEnum, TrainRequest
from ..serving.stats import Series

log = logging.getLogger("kubeml.preemption")

# window the 429-rate signal is computed over: matches the serving stats
# ring window so the controller and the decoders' own overload_per_second
# gauge describe the same quantity
SIGNAL_WINDOW_S = 10.0


class PreemptionController:
    def __init__(self, scheduler, ps, config: Optional[Config] = None):
        self.cfg = config or get_config()
        self.scheduler = scheduler
        self.ps = ps
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        # {job_id: resume TrainRequest} — yielded jobs waiting for calm
        self._parked: Dict[str, TrainRequest] = {}
        self._overloaded_polls = 0
        self._calm_polls = 0
        self._last_preempt = 0.0
        # each poll records the summed cumulative 429 counter; the rate is
        # a windowed query over this ring
        self._overload_series = Series(capacity=1024)

    # --- lifecycle ---

    def start(self) -> "PreemptionController":
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="preemption", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.cfg.preempt_interval):
            try:
                self.tick()
            except Exception:
                log.exception("preemption tick failed")

    # --- signals ---

    def signals(self) -> dict:
        """One poll of the serving overload signals, aggregated across the
        resident decoders: worst-case queue depth and p99, and the windowed
        429 rate — a time-series query over the polled cumulative counter
        (Series.rate with burst-aware elapsed-span semantics: a burst
        shorter than the window reads as its burst rate, which is what the
        old per-poll counter delta provided)."""
        try:
            telemetry = self.ps.serving_telemetry() or {}
        except Exception:
            telemetry = {}
        queue_depth = max((s.get("queue_depth", 0.0)
                           for s in telemetry.values()), default=0.0)
        p99 = max((s.get("latency_p99_seconds", 0.0)
                   for s in telemetry.values()), default=0.0)
        overloads = sum(s.get("requests_overload", 0.0)
                        for s in telemetry.values())
        now = time.monotonic()
        self._overload_series.observe(overloads, t=now)
        # reset="clamp": this series SUMS per-decoder counters, and a
        # decoder-cache eviction shrinks the sum without any new 429s —
        # Prometheus reset semantics would read the survivors' full value
        # as a fresh burst and preempt a healthy training job (the old
        # hand-rolled delta clamped negatives for the same reason)
        rate = self._overload_series.rate(SIGNAL_WINDOW_S, now=now,
                                          span="elapsed", reset="clamp")
        # per-poll burst floor: once the series is older than the window
        # the elapsed span IS the window, which dilutes a burst landing in
        # one poll ~window/interval-fold — the newest sample pair's own
        # delta rate keeps the old per-poll sensitivity (clamped, same
        # eviction reasoning as above)
        recent = self._overload_series.samples(SIGNAL_WINDOW_S, now=now)
        if len(recent) >= 2:
            dt = max(recent[-1][0] - recent[-2][0], 1e-3)
            rate = max(rate, max(0.0, recent[-1][1] - recent[-2][1]) / dt)
        # prefer the decoders' own windowed rate when higher (their ring
        # sees every 429 the instant it happens; the poll only sees the
        # counter at poll resolution)
        rate = max(rate, sum(s.get("overload_per_second", 0.0)
                             for s in telemetry.values()))
        return {"queue_depth": queue_depth, "p99": p99,
                "overload_rate": rate}

    def overloaded(self, sig: dict) -> bool:
        cfg = self.cfg
        if cfg.preempt_queue_depth > 0 and sig["queue_depth"] >= cfg.preempt_queue_depth:
            return True
        if cfg.preempt_overload_rate > 0 and sig["overload_rate"] >= cfg.preempt_overload_rate:
            return True
        if cfg.preempt_p99 > 0 and sig["p99"] >= cfg.preempt_p99:
            return True
        return False

    # --- decisions ---

    def tick(self) -> None:
        sig = self.signals()
        if self.overloaded(sig):
            self._overloaded_polls += 1
            self._calm_polls = 0
        else:
            self._calm_polls += 1
            self._overloaded_polls = 0
        if (self._overloaded_polls >= self.cfg.preempt_sustain
                and time.time() - self._last_preempt >= self.cfg.preempt_cooldown):
            victim = self.pick_victim()
            if victim is not None:
                log.warning(
                    "serving overloaded (queue=%d, 429/s=%.1f, p99=%.3fs): "
                    "preempting job %s (priority %d, tenant %r)",
                    int(sig["queue_depth"]), sig["overload_rate"], sig["p99"],
                    victim["job_id"], victim["priority"], victim["tenant"])
                try:
                    self.ps.preempt_task(victim["job_id"],
                                         reason="serving-overload")
                    self._last_preempt = time.time()
                except KubeMLError as e:
                    log.warning("preempting %s failed: %s",
                                victim["job_id"], e.message)
        if self._calm_polls >= self.cfg.preempt_resume_sustain:
            self.requeue_parked()

    def pick_victim(self) -> Optional[dict]:
        """The lowest-priority running job; within a class the tenant with
        the most accumulated device-seconds yields first (fair share), then
        job id for determinism. Jobs already mid-yield are skipped."""
        try:
            # live records only: the per-tick poll must not pay the journal
            # glob + checkpoint-metadata reads of the full operator listing
            jobs = self.ps.jobs_snapshot(include_journal=False)
        except Exception:
            return None
        running = [j for j in jobs
                   if j.get("status") == JobStateEnum.RUNNING
                   and not j.get("preempting")]
        if not running:
            return None
        usage = self.scheduler.usage
        return min(running,
                   key=lambda j: (j.get("priority", 0),
                                  -usage.get(j.get("tenant", "")),
                                  j.get("job_id", "")))

    # --- parked jobs ---

    def park(self, job_id: str, request: TrainRequest) -> None:
        """Hold a yielded job until pressure clears (scheduler.job_preempted)."""
        with self._lock:
            self._parked[job_id] = request
        log.info("parked preempted job %s until serving pressure clears "
                 "(%d parked)", job_id, len(self._parked))

    def parked_ids(self) -> list:
        with self._lock:
            return sorted(self._parked)

    def requeue_parked(self) -> int:
        """Resubmit every parked job with resume=True. A 409 (the id is
        still being torn down) keeps the job parked for the next calm tick.
        Returns how many requeued."""
        with self._lock:
            items = list(self._parked.items())
        n = 0
        for job_id, req in items:
            req.options.resume = True
            req.job_id = job_id
            try:
                self.scheduler.submit_train(req)
            except KubeMLError as e:
                log.warning("requeue of parked job %s deferred: %s",
                            job_id, e.message)
                continue
            with self._lock:
                self._parked.pop(job_id, None)
            n += 1
            log.info("requeued preempted job %s (resume=True)", job_id)
        return n

"""The scheduler: the port of ``kubeml_tpu/scheduler/scheduler.py``.

It consumes the task queue on a thread of its own. A new train request
gets an 8-character job id and is queued; the loop pops it, asks the
policy for its parallelism and starts it on the parameter server. A
running job queues an epoch-end re-evaluation and blocks until the loop's
answer reaches it through the PS (``ParameterServer.update_task``).

The submitting request's trace context rides the task across the queue
(``TrainTask.trace_parent``); the loop binds it again and opens a
``scheduler.schedule`` span under it, so the parameter server's
``/start`` and every hop after it stitch under the request.

A request the cluster cannot run (``TrainOptions.check_ported`` over the
parameter server's ranks: an SPMD mesh that does not divide them) is
refused with a 400 at submission. A preempted job is requeued at once
with ``resume=True``, or, with a preemption controller bound
(``preemption``, ``KUBEML_PREEMPT_MONITOR``), parked until serving
pressure clears.
"""

from __future__ import annotations

import logging
import threading
import uuid
from typing import Optional

import torch

from ..api.config import Config, get_config
from ..api.errors import KubeMLError
from ..api.types import JobState, TrainRequest, TrainTask
from ..utils import tracing
from .decisions import DecisionLog
from .policy import SchedulerPolicy, ThroughputBasedPolicy
from .queue import TaskQueue, TenantUsage, task_tenant

log = logging.getLogger("kubeml.scheduler")


def create_job_id() -> str:
    """An 8-character job id."""
    return uuid.uuid4().hex[:8]


class Scheduler:
    def __init__(self, ps, policy: Optional[SchedulerPolicy] = None,
                 config: Optional[Config] = None,
                 max_parallelism: Optional[int] = None):
        self.cfg = config or get_config()
        self.ps = ps
        if max_parallelism is None:
            max_parallelism = self.cfg.max_parallelism
        if max_parallelism is None:
            # a floor of 8: workers pack onto one card, so elasticity must
            # not collapse to 1 because one card is visible
            max_parallelism = max(8, torch.cuda.device_count())
        self.policy = policy or ThroughputBasedPolicy(
            default_parallelism=4, max_parallelism=max_parallelism,
            limit_parallelism=self.cfg.limit_parallelism)
        # device-seconds per tenant, charged from every epoch-end report
        self.usage = TenantUsage()
        # the preemption controller (scheduler/preemption.py) when the
        # monitor runs: it parks preempted jobs; None requeues them at once
        self.preemption = None
        self.queue = TaskQueue(usage=self.usage)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # ids alive anywhere in the pipeline (queued, popped, running): the
        # duplicate-submit guard covers the pop -> start window too
        self._active_ids: set = set()
        self._active_lock = threading.Lock()
        self.decisions = DecisionLog(per_job=self.cfg.decision_log_size,
                                     max_jobs=self.cfg.decision_log_jobs)
        if hasattr(self.policy, "bind_decision_log"):
            self.policy.bind_decision_log(self.decisions)
        try:
            ps.metrics.set_queue_source(self.queue.depths)
            ps.metrics.set_decision_source(self.decisions.counts)
        except AttributeError:
            pass  # a PS double without a metrics registry

    # --- the public surface ---

    def submit_train(self, request: TrainRequest) -> str:
        """``/train``: validate, mint the job id (or keep the client's, 409
        while a job of that id is queued or running), queue."""
        try:
            request.validate()
        except ValueError as e:
            raise KubeMLError(str(e), 400)
        request.options.check_ported(getattr(self.ps, "world", 1))
        with self._active_lock:
            if request.job_id and (
                    request.job_id in self._active_ids
                    or any(t.job_id == request.job_id
                           for t in self.ps.list_tasks())):
                raise KubeMLError(f"job {request.job_id!r} is still active",
                                  409)
            job_id = request.job_id or create_job_id()
            self._active_ids.add(job_id)
        # the queue loses the thread: the request's context rides the task
        ctx = tracing.current_context()
        self.queue.push(TrainTask(
            job_id=job_id, parameters=request, state=JobState(),
            trace_parent=ctx.traceparent() if ctx else ""))
        log.info("queued train task %s (%s on %s)", job_id,
                 request.function_name, request.dataset)
        return job_id

    def update_job(self, task: TrainTask) -> None:
        """``/job``: a running job asks for its next epoch's parallelism;
        the report charges its tenant parallelism x elapsed seconds."""
        if task.state.elapsed_time > 0 and task.state.parallelism > 0:
            self.usage.charge(task_tenant(task),
                              task.state.parallelism * task.state.elapsed_time)
        self.queue.push(task)

    def finish_job(self, job_id: str) -> None:
        """``/finish/{taskId}``: the policy forgets the job (and drops its
        stale epoch-end updates still queued)."""
        self.policy.task_finished(job_id)
        with self._active_lock:
            self._active_ids.discard(job_id)

    def job_preempted(self, task: TrainTask) -> None:
        """A preempted job's slot freed: park it with the preemption
        controller when one is bound, else requeue it with ``resume=True``,
        under the task's trace context either way (the resumed job's
        spans continue its trace). A failure is logged; the journal keeps
        the job for the next boot."""
        req = TrainRequest.from_dict(task.parameters.to_dict())
        req.job_id = task.job_id
        req.options.resume = True
        if self.preemption is not None:
            self.preemption.park(task.job_id, req,
                                 trace_parent=task.trace_parent)
            return
        try:
            with tracing.use_context(tracing.parse_traceparent(
                    task.trace_parent)):
                self.submit_train(req)
            log.info("requeued preempted job %s (resume=True)", task.job_id)
        except KubeMLError as e:
            log.warning("requeue of preempted job %s deferred: %s",
                        task.job_id, e.message)

    def jobs_snapshot(self) -> list:
        """The queued entries in pop order."""
        return self.queue.snapshot()

    def job_decisions(self, job_id: str) -> dict:
        """``GET /jobs/{id}/decisions``: a job's retained scale decisions,
        oldest first; ``total`` counts every decision recorded."""
        return {"job_id": job_id,
                "decisions": self.decisions.for_job(job_id),
                "total": self.decisions.total(job_id)}

    def infer(self, model_id: str, data):
        """``/infer``: straight to the PS, past the queue."""
        return self.ps.infer(model_id, data)

    def generate(self, req):
        """``/generate``: straight to the PS, past the queue."""
        return self.ps.generate(req.model_id, req)

    # --- the loop ---

    def start(self) -> "Scheduler":
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, name="scheduler",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.is_set():
            task = self.queue.pop(timeout=0.1)
            if task is None:
                continue
            try:
                self._schedule(task)
            except Exception:
                log.exception("scheduling task %s failed", task.job_id)

    def _schedule(self, task: TrainTask) -> None:
        # the submitter's context, carried on the task, is this span's
        # parent and that of the hops it makes (the PS's /start, /update)
        with tracing.use_context(tracing.parse_traceparent(
                task.trace_parent)):
            with tracing.get_tracer().span("scheduler.schedule",
                                           service="scheduler",
                                           job=task.job_id):
                self._schedule_inner(task)

    def _schedule_inner(self, task: TrainTask) -> None:
        decision = self.policy.calculate_parallelism(task)
        if decision is None:
            log.debug("dropping stale update for finished job %s",
                      task.job_id)
            return
        parallelism, is_new = decision
        task.state.parallelism = parallelism
        if is_new:
            log.info("starting job %s with parallelism %d", task.job_id,
                     parallelism)
            try:
                self.ps.start_task(task)
            except Exception:
                # no job thread, so no finish callback: free the id
                self.finish_job(task.job_id)
                raise
        else:
            log.debug("job %s parallelism -> %d", task.job_id, parallelism)
            self.ps.update_task(task.job_id, parallelism)

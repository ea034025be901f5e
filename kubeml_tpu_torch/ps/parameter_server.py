"""The parameter server: the port of ``kubeml_tpu/ps/parameter_server.py``
(threaded jobs, on one card or over the ranks of a process group).

The training lifecycle:

* :meth:`ParameterServer.start_task` (``/start``) reserves the job's slot
  (a duplicate id is a 400), journals the request, loads the function and
  runs the job class of the request's engine (``engine.job_class_for``: a
  K-AVG :class:`~kubeml_tpu_torch.engine.job.TrainJob` or an
  :class:`~kubeml_tpu_torch.engine.spmd_job.SPMDJob`) on a thread of its
  own; a start that fails leaves a failed history;
* at each epoch's end the job thread asks the scheduler for its next
  parallelism and waits for :meth:`update_task` (``/update/{jobId}``), at
  most ``update_timeout`` seconds, then keeps what it has;
* :meth:`stop_task` stops a job at its next round edge;
  :meth:`preempt_task` makes it write a resume checkpoint and leave with
  the ``preempted`` status, after which the scheduler requeues it with
  ``resume=True``; a job that has not yielded within the grace is
  abandoned (its journal entry kept);
* :meth:`list_tasks`, :meth:`jobs_snapshot` (with the journaled jobs that
  are not live), :meth:`get_task`, :meth:`wait`, :meth:`prune_tasks`,
  :meth:`stop_running_jobs` (shutdown: journals kept for the next boot);
* :meth:`infer` on a live job answers from the job's merged weights of
  its last completed round (``TrainJob.infer``; an SPMD job answers
  between its steps, and with 409 while it trains over ranks).

Over ranks (``dist``, a ``DistContext`` of several ranks; JAX :173-230,
583-667) the server runs on rank 0 and every other rank runs
``engine.follower.run_follower``. A job thread takes ``_dist_lock`` (the
ranks must issue their collectives in one order, so jobs over ranks run
one at a time), announces the task (``{"cmd": "train"}`` on the store),
waits at most ``dist_ack_timeout`` seconds for each follower's
acknowledgement that it built the job, broadcasts ``go`` (or, when one
could not, fails the job with a history naming "could not start"), arms
the stall watchdog (``utils.watchdog.arm_stall_watchdog``) and runs the
job. :meth:`announce_shutdown` releases the followers after
:meth:`stop_running_jobs`. The port has no heartbeat monitor of hung
threaded jobs; a job over ranks has the watchdog on every rank instead.

The serving half serves a finished job from its exported checkpoint:

* :meth:`ParameterServer.generate` (JAX ``:1213``) loads the ``final``
  export (or, under ``serving_quantize="int8"``, a ``final-int8`` export
  at least as fresh), flat or sharded, whichever of the two is newer
  (a sharded one assembled on the host, ``storage.sharded_checkpoint``),
  re-laid out by the function's ``serving_remap`` when it has one
  (``apply_remap_host``), through the job's registered function into a
  4-entry host cache keyed by the file's mtime, and serves it through a
  resident decoder from a 2-entry cache keyed the same way: the
  :class:`~kubeml_tpu_torch.serving.PagedBatchingDecoder`, or the dense
  :class:`~kubeml_tpu_torch.serving.BatchingDecoder` for a model with no
  paged decode path (MoE) and under ``serving_paged=False`` (JAX
  ``:1349-1383``); with ``serving_batcher=False`` each request runs the
  one-shot ``generate_from_request``. A re-saved checkpoint builds a new
  decoder and retires the one it displaces, and a closed decoder is
  rebuilt. The cache holds the host tree: each decoder gets a module of
  its own built from it (the engine quantizes its module in place), moved
  to the server's device. ``generate`` on a live job is the job's
  ``TrainJob.generate`` (the one-shot path on its published weights);
* :meth:`ParameterServer.infer` (JAX ``:1906``) runs a finished model's
  ``infer`` (a K-AVG job such as LeNet or ResNet) on the server's device;
* :meth:`drain_serving`, :meth:`restore_serving` and
  :meth:`restored_snapshot` (JAX ``:1609-1721``) move live requests
  across a restart as KMS1 frames (``<model>-<request>.kms`` in
  ``snap_dir``);
* the resident decoders' ``telemetry()`` feeds ``metrics.render()``.

Speculative decoding follows ``serving_spec``; a spec configuration the
engine rejects (a ``ValueError`` or ``KubeMLError`` from the spec
arguments, or a draft model that does not load) degrades to plain decode
with a warning. Anything else raised while building a decoder propagates.

Not ported yet, each refused with a 400 that names it: standalone job
runners (``standalone_jobs``; over ranks JAX's own refusal), meshes
(``serving_mesh``: meshed serving, ROADMAP Queue 1 item 1.4), and serving
a job's epoch checkpoints before its final export. The heartbeat monitor
of hung threaded jobs, traces and the time-series store are not ported
either. An unknown id is a 404. The server runs on the card unless given
``device="cpu"``.
"""

from __future__ import annotations

import inspect
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..api.config import Config, get_config
from ..api.errors import (CheckpointNotFoundError, JobNotFoundError,
                          KubeMLError, StorageError)
from ..api.types import (GenerateRequest, History, JobState, JobStateEnum,
                         TrainTask, generate_timeout)
from ..engine import job_class_for
from ..engine.job import TrainJob
from ..functions.registry import FunctionRegistry
from ..interop.from_flax import from_flax, from_flax_variables
from ..models.generation import (generate_from_request,
                                 supports_paged_decode)
from ..models.layers import load_tree
from ..serving import BatchingDecoder, PagedBatchingDecoder, kvsnap
from ..serving.quant import (INT8_TAG, QuantizedTensor, from_storage_tree,
                             is_quantized_storage, is_quantized_tree)
from ..storage.checkpoint import FINAL_TAG, CheckpointStore
from ..storage.sharded_checkpoint import (ShardedCheckpointStore,
                                          apply_remap_host)
from ..storage.history import HistoryStore
from ..storage.store import ShardStore
from ..utils.device import resolve_device
from .journal import JobJournal
from .metrics import MetricsRegistry

log = logging.getLogger("kubeml.ps")

# finished-job serving cache: whole weight trees, keep only a few
SERVING_CACHE_SIZE = 4
# resident decoders: each holds a KV arena on the card
DECODER_CACHE_SIZE = 2


def _not_ported(what: str) -> KubeMLError:
    return KubeMLError(f"{what} is not ported to kubeml_tpu_torch yet", 400)


@dataclass
class _UpdateBox:
    """One pending epoch-end answer of the scheduler."""

    event: threading.Event = field(default_factory=threading.Event)
    parallelism: int = 0


@dataclass
class _JobRecord:
    task: TrainTask
    job: Optional[TrainJob]  # a TrainJob or an SPMDJob; None while starting
    thread: Optional[threading.Thread]
    update_box: Optional[_UpdateBox] = None
    # keep the journal entry at the finish (shutdown, preemption): the
    # next boot resubmits the job with resume=True
    keep_journal: bool = False
    # wall time of the first preempt request (None: never preempted)
    preempt_t0: Optional[float] = None


class ParameterServer:
    def __init__(self, registry: Optional[FunctionRegistry] = None,
                 config: Optional[Config] = None,
                 metrics: Optional[MetricsRegistry] = None, device=None,
                 store: Optional[ShardStore] = None,
                 history_store: Optional[HistoryStore] = None, dist=None):
        self.cfg = config or get_config()
        self.registry = registry or FunctionRegistry(config=self.cfg)
        self.store = store or ShardStore(config=self.cfg)
        self.history_store = history_store or HistoryStore(config=self.cfg)
        self.metrics = metrics or MetricsRegistry()
        self.metrics.set_serving_source(self._serving_telemetry)
        self.device = resolve_device(device)
        self.scheduler = None  # bound after construction
        self._jobs: Dict[str, _JobRecord] = {}
        self._ckpt_store = CheckpointStore(config=self.cfg)
        # accepted jobs persist until they finish: a restart resubmits them
        self._journal = JobJournal(config=self.cfg)
        self._serving_cache: Dict[str, tuple] = {}  # (model, tree, mtime)
        self._decoders: Dict[str, tuple] = {}  # (decoder, mtime)
        # requests replayed from snap_dir: {"model", "request_id", "file",
        # "entry", "decoder"}
        self._restored: List[dict] = []
        self._lock = threading.RLock()
        # over ranks: this server runs on rank 0 and announces each job to
        # the followers; jobs over ranks run one at a time (_dist_lock)
        self.dist = dist if dist is not None and dist.size > 1 else None
        self._dist_lock = threading.Lock()
        self._dist_run = 0  # per-announcement nonce of the ack keys

    @property
    def world(self) -> int:
        """The ranks a job of this server runs over."""
        return 1 if self.dist is None else self.dist.size

    def bind_scheduler(self, scheduler) -> None:
        self.scheduler = scheduler

    # --- the training lifecycle ---

    def start_task(self, task: TrainTask) -> None:
        """``/start``: reserve the slot, load the function, start the job
        on a thread of its own. A failed start leaves a failed history."""
        if self.cfg.standalone_jobs:
            if self.dist is not None:
                raise KubeMLError(
                    "standalone job runners are a single-host deployment "
                    "mode; training over ranks runs jobs threaded on every "
                    "rank", 400)
            raise _not_ported("standalone job runners (STANDALONE_JOBS)")
        req = task.parameters
        placeholder = self._reserve_slot(task)
        try:
            model = self.registry.load(req.function_name)
            model._set_params(lr=req.lr, batch_size=req.batch_size, epoch=0,
                              k=req.options.k, task="train")
            req.options.default_parallelism = (
                task.state.parallelism or req.options.default_parallelism)
            job = job_class_for(req.options)(
                task.job_id, req, model, store=self.store,
                history_store=self.history_store,
                checkpoint_store=self._ckpt_store,
                on_epoch_end=lambda state, jid=task.job_id:
                    self._epoch_end(jid, state),
                on_metrics=self.metrics.update, device=self.device,
                dist=self.dist)
        except Exception as e:
            self._fail_start(task, e)
            raise
        runner = self._run_job if self.dist is None else self._run_job_dist
        thread = threading.Thread(target=runner,
                                  args=(task, job, placeholder),
                                  name=f"job-{task.job_id}", daemon=True)
        placeholder.job = job
        placeholder.thread = thread
        task.status = JobStateEnum.RUNNING
        self.metrics.task_started("train")
        thread.start()

    def _reserve_slot(self, task: TrainTask) -> _JobRecord:
        """Take the job's index slot (a duplicate id is a 400), drop a
        cached finished model of a reused id, journal the request."""
        placeholder = _JobRecord(task=task, job=None, thread=None)
        with self._lock:
            if task.job_id in self._jobs:
                raise KubeMLError(f"job {task.job_id} already exists", 400)
            self._jobs[task.job_id] = placeholder
            self._serving_cache.pop(task.job_id, None)
        try:
            self._journal.record(task.job_id, task.parameters)
        except Exception:
            log.exception("journaling job %s failed (non-fatal)", task.job_id)
        return placeholder

    def _ensure_failure_history(self, job_id: str, request,
                                error: str) -> None:
        """A dead job's history exists afterwards (pollers key off it);
        one the job saved itself is kept."""
        try:
            self.history_store.get(job_id)
        except Exception:
            self.history_store.save(History(
                id=job_id, task={"request": request.to_dict(),
                                 "error": error}))

    def _fail_start(self, task: TrainTask, error: Exception) -> None:
        """A failed start: FAILED, slot freed, journal cleared, and a
        failed history saved (over any earlier run's under the same id)."""
        task.status = JobStateEnum.FAILED
        with self._lock:
            self._jobs.pop(task.job_id, None)
        try:
            self._journal.clear(task.job_id)
        except Exception:
            pass
        self.history_store.save(History(
            id=task.job_id,
            task={"request": task.parameters.to_dict(), "error": str(error)}))

    def _run_job(self, task: TrainTask, job: TrainJob,
                 record: Optional[_JobRecord] = None) -> None:
        try:
            job.train()
            if job.preempted:
                # parked with a resume checkpoint: the journal entry stays
                task.status = JobStateEnum.PREEMPTED
                if record is not None:
                    record.keep_journal = True
            else:
                task.status = (JobStateEnum.STOPPED
                               if job.stop_event.is_set()
                               else JobStateEnum.FINISHED)
            if record is not None and task.status == JobStateEnum.FINISHED:
                # finished during a shutdown: not resubmitted at the boot
                record.keep_journal = False
        except Exception as e:
            task.status = JobStateEnum.FAILED
            log.error("job %s failed: %s", task.job_id, e)
        finally:
            # expect: a thread abandoned by the preempt grace must not tear
            # down a resubmitted job that reused the id
            self._finish(task.job_id, expect=record)

    def _run_job_dist(self, task: TrainTask, job,
                      record: Optional[_JobRecord] = None) -> None:
        """The job thread over ranks (JAX :583-637): serialized on the
        dist lock, the task announced to the followers, each follower's
        acknowledgement that it built the job awaited before anyone
        enters a collective (a follower without the function or the
        dataset fails the job here, instead of leaving the leader in a
        collective it joined alone), then the job under the stall
        watchdog."""
        from ..utils.watchdog import arm_stall_watchdog

        with self._dist_lock:
            run = self._dist_run
            self._dist_run += 1
            self.dist.broadcast_obj({"cmd": "train", "task": task.to_dict(),
                                     "run": run})
            errs = []
            for rank in range(1, self.dist.size):
                ack = self.dist.get(f"kubeml/ack/{run}/{rank}",
                                    timeout_s=self.cfg.dist_ack_timeout)
                if ack is None:
                    errs.append(f"rank {rank}: no job-start ack (timeout)")
                elif ack != "ok":
                    errs.append(f"rank {rank}: {ack}")
            self.dist.broadcast_obj({"go": not errs})
            if errs:
                err = ("follower(s) could not start the job: "
                       + "; ".join(errs))
                log.error("job %s aborted before start: %s", task.job_id,
                          err)
                task.status = JobStateEnum.FAILED
                self._ensure_failure_history(task.job_id, task.parameters,
                                             err)
                self._finish(task.job_id, expect=record)
                return

            def on_stall(reason: str) -> None:
                if record is not None:
                    record.keep_journal = True
                self._ensure_failure_history(task.job_id, task.parameters,
                                             reason)

            # stamped now: the thread may have queued on the dist lock
            # behind a long job
            job.heartbeat = time.time()
            guard = arm_stall_watchdog(job, self.cfg.function_timeout,
                                       f"dist job {task.job_id} (leader)",
                                       on_stall=on_stall)
            try:
                self._run_job(task, job, record)
            finally:
                guard.set()

    def _finish(self, job_id: str,
                expect: Optional[_JobRecord] = None) -> bool:
        """A job's teardown: its gauges cleared, the scheduler told (and
        a preempted job handed back for its requeue), the slot freed."""
        with self._lock:
            record = self._jobs.get(job_id)
            if record is None or (expect is not None
                                  and record is not expect):
                return False
            self._jobs.pop(job_id, None)
        if not record.keep_journal:
            try:
                self._journal.clear(job_id)
            except Exception:
                log.exception("clearing journal for %s failed (non-fatal)",
                              job_id)
        self.metrics.clear(job_id)
        self.metrics.task_finished("train")
        if record.preempt_t0 is not None:
            self.metrics.observe_yield(time.time() - record.preempt_t0)
        if self.scheduler is not None:
            try:
                self.scheduler.finish_job(job_id)
            except Exception:
                log.exception("notifying scheduler of %s finish failed",
                              job_id)
            if record.task.status == JobStateEnum.PREEMPTED:
                try:
                    self.scheduler.job_preempted(record.task)
                except Exception:
                    log.exception("requeue of preempted job %s failed "
                                  "(the journal keeps it for the next "
                                  "boot)", job_id)
        if record.update_box is not None:
            # a job thread waiting for the scheduler's answer goes on
            record.update_box.event.set()
        return True

    # --- the elastic round trip ---

    def _epoch_end(self, job_id: str, state: JobState) -> int:
        """On the job thread: ask the scheduler, wait for its answer."""
        if self.scheduler is None:
            return state.parallelism
        with self._lock:
            record = self._jobs.get(job_id)
            if record is None or (record.job is not None
                                  and record.job.stop_event.is_set()):
                # a stopping job asks nobody (the scheduler may be gone)
                return state.parallelism
            box = _UpdateBox(parallelism=state.parallelism)
            record.update_box = box
            task = record.task
        task.state = state
        self.scheduler.update_job(task)
        timeout = self.cfg.update_timeout
        if not box.event.wait(timeout):
            log.warning("job %s: the scheduler answered no parallelism "
                        "update within %.0fs (KUBEML_UPDATE_TIMEOUT); keeping "
                        "parallelism %d", job_id, timeout, state.parallelism)
            return state.parallelism
        return box.parallelism

    def update_task(self, job_id: str, parallelism: int) -> None:
        """``/update/{jobId}``: the scheduler's answer, to the waiting job
        thread."""
        with self._lock:
            record = self._jobs.get(job_id)
        if record is None:
            raise JobNotFoundError(job_id)
        box = record.update_box
        if box is None:
            log.warning("job %s: update with no pending epoch-end request",
                        job_id)
            return
        box.parallelism = parallelism
        box.event.set()

    # --- queries and control ---

    def list_tasks(self) -> List[TrainTask]:
        """``/tasks``."""
        with self._lock:
            return [r.task for r in self._jobs.values()]

    def _resume_epoch(self, job_id: str) -> int:
        """The epoch a resumed job would restart at, from the checkpoints'
        metadata only."""
        try:
            tags = self._ckpt_store.tags(job_id)
            last = self._ckpt_store.latest_epoch(job_id)
            start = 0 if last is None else last + 1
            if FINAL_TAG in tags:
                start = max(start, int(self._ckpt_store.read_meta(
                    job_id, FINAL_TAG).get("epoch", 0)))
            return start
        except Exception:
            return 0

    def jobs_snapshot(self, include_journal: bool = True) -> List[dict]:
        """The PS half of ``kubeml jobs``: the live records, then the
        journaled jobs that are not live (preempted or interrupted), with
        the epoch a resume restarts at."""
        out = []
        with self._lock:
            records = list(self._jobs.items())
        live = set()
        for jid, r in records:
            live.add(jid)
            opts = r.task.parameters.options
            out.append({
                "job_id": jid, "status": r.task.status,
                "priority": int(getattr(opts, "priority", 0)),
                "tenant": str(getattr(opts, "tenant", "")),
                "function": r.task.parameters.function_name,
                "parallelism": r.task.state.parallelism,
                "preempting": r.preempt_t0 is not None})
        if not include_journal:
            return out
        try:
            pending = self._journal.pending(quarantine=False)
        except Exception:
            pending = []
        for entry in pending:
            jid = entry.get("job_id", "")
            if not jid or jid in live:
                continue
            req = entry.get("request", {}) or {}
            opts = req.get("options", {}) or {}
            out.append({
                "job_id": jid, "status": JobStateEnum.PREEMPTED,
                "priority": int(opts.get("priority", 0) or 0),
                "tenant": str(opts.get("tenant", "") or ""),
                "function": req.get("function_name", ""),
                "resume_epoch": self._resume_epoch(jid)})
        return out

    def get_task(self, job_id: str) -> TrainTask:
        with self._lock:
            record = self._jobs.get(job_id)
        if record is None:
            raise JobNotFoundError(job_id)
        return record.task

    def preempt_task(self, job_id: str, reason: str = "operator",
                     grace: Optional[float] = None) -> None:
        """``/preempt/{jobId}``: the job leaves at its next round edge
        with a resume checkpoint and the ``preempted`` status; its journal
        entry is kept however the yield ends. A job still running after
        ``grace`` seconds (``preempt_grace``) is abandoned."""
        with self._lock:
            record = self._jobs.get(job_id)
        if record is None:
            raise JobNotFoundError(job_id)
        if grace is None:
            grace = self.cfg.preempt_grace
        first = record.preempt_t0 is None
        if first:
            record.preempt_t0 = time.time()
        record.keep_journal = True
        if record.job is None:
            if first:
                record.preempt_t0 = None
            raise KubeMLError(f"job {job_id} is still starting", 409)
        record.job.preempt()
        if record.update_box is not None:
            # the yield must not wait out the scheduler's answer
            record.update_box.event.set()
        if first:
            self.metrics.preemption(reason)
            log.info("preempting job %s (%s; grace %.0fs)", job_id, reason,
                     grace)
            threading.Thread(target=self._preempt_grace_watch,
                             args=(job_id, record, grace),
                             name=f"preempt-grace-{job_id}",
                             daemon=True).start()

    def _preempt_grace_watch(self, job_id: str, record: _JobRecord,
                             grace: float) -> None:
        """A preempted job that has not freed its slot within ``grace`` is
        abandoned with the ``preempted`` status (its thread stopped
        cooperatively): the journal entry and its newest checkpoint keep
        it resumable."""
        deadline = record.preempt_t0 + max(0.0, grace)
        while time.time() < deadline:
            with self._lock:
                if self._jobs.get(job_id) is not record:
                    return  # yielded in time
            time.sleep(min(0.2, max(0.01, deadline - time.time())))
        with self._lock:
            if self._jobs.get(job_id) is not record:
                return
        log.warning("job %s did not yield within the %.0fs preempt grace; "
                    "abandoning it (it resumes from its newest "
                    "checkpoint)", job_id, grace)
        self.metrics.preemption("hard-kill")
        record.task.status = JobStateEnum.PREEMPTED
        try:
            record.job.stop()
        except Exception:
            pass
        self._finish(job_id, expect=record)

    def stop_task(self, job_id: str) -> None:
        """``/stop/{jobId}``: the job stops at its next round edge."""
        with self._lock:
            record = self._jobs.get(job_id)
        if record is None:
            raise JobNotFoundError(job_id)
        if record.job is None:
            raise KubeMLError(f"job {job_id} is still starting", 409)
        record.job.stop()

    def wait(self, job_id: str, timeout: Optional[float] = None) -> bool:
        """Join a job's thread; True once it has ended (or no such job)."""
        with self._lock:
            record = self._jobs.get(job_id)
        if record is None:
            return True
        if record.thread is None:
            return False  # still starting
        try:
            record.thread.join(timeout)
        except RuntimeError:
            return False  # created but not started yet
        return not record.thread.is_alive()

    def prune_tasks(self) -> int:
        """``kubeml task prune``: tear down records whose job thread died
        without finishing; returns the count."""
        with self._lock:
            candidates = list(self._jobs.items())
        pruned = 0
        for job_id, record in candidates:
            if (record.thread is not None and record.thread.ident is not None
                    and not record.thread.is_alive()):
                with self._lock:
                    if self._jobs.get(job_id) is not record:
                        continue
                if record.preempt_t0 is not None:
                    record.task.status = JobStateEnum.PREEMPTED
                else:
                    record.task.status = JobStateEnum.FAILED
                    self._ensure_failure_history(
                        job_id, record.task.parameters,
                        "job thread died without finishing")
                if self._finish(job_id, expect=record):
                    pruned += 1
        return pruned

    def stop_running_jobs(self) -> None:
        """Shutdown: stop every job at its next round edge, keeping its
        journal entry so the next boot resubmits it with resume=True."""
        with self._lock:
            records = [r for r in self._jobs.values() if r.job is not None]
        for record in records:
            record.keep_journal = True
            try:
                record.job.stop()
            except Exception:
                log.exception("stopping job failed")
            if record.update_box is not None:
                record.update_box.event.set()

    def announce_shutdown(self) -> None:
        """Release the followers at shutdown (after
        :meth:`stop_running_jobs`: a running job over ranks holds the dist
        lock until its epoch ends)."""
        if self.dist is not None:
            with self._dist_lock:
                self.dist.broadcast_obj({"cmd": "shutdown"})

    def finish_standalone(self, job_id: str, status: str = "",
                          error: Optional[str] = None) -> None:
        """``/finish/{jobId}``, a standalone runner's callback: the port
        runs threaded jobs only, so no record has a runner (a 404, as the
        JAX server answers for a threaded job)."""
        raise JobNotFoundError(job_id)

    # --- /infer and /generate ---

    def infer(self, model_id: str, data) -> list:
        """``/infer``: a live job's model on its merged weights of the last
        completed round, or a finished job's final export."""
        with self._lock:
            record = self._jobs.get(model_id)
        if record is None:
            return self._infer_from_checkpoint(model_id, data)
        if record.job is None:
            raise KubeMLError(f"job {model_id} is still starting", 503)
        self.metrics.task_started("inference")
        try:
            return np.asarray(record.job.infer(np.asarray(data))).tolist()
        finally:
            self.metrics.task_finished("inference")

    def _infer_from_checkpoint(self, model_id: str, data) -> list:
        """A finished job's ``model.infer`` on ``data`` from its final
        checkpoint, with the model's own device-side ``preprocess``."""
        model, tree, _ = self._load_serving(model_id)
        variables = {c: {k: v.to(self.device) for k, v in leaves.items()}
                     for c, leaves in from_flax_variables(
                         self._densified(tree), model.module).items()}
        model.module.to(self.device)  # as the trainer's, on the device
        self.metrics.task_started("inference")
        try:
            with torch.no_grad():
                x = torch.as_tensor(np.asarray(data)).to(self.device)
                out = model.infer(variables, model.preprocess(x))
            return out.cpu().numpy().tolist()
        finally:
            self.metrics.task_finished("inference")

    def generate(self, model_id: str, req):
        """Sampling from a causal-LM job: a live job through
        ``TrainJob.generate``, a finished one through its resident decoder
        (or the one-shot path without the batching engine). Returns the
        result dict, or with ``req.stream`` a generator of ``{"row",
        "tokens"}`` deltas and a final ``{"done", "lengths"}`` record."""
        if not isinstance(req, GenerateRequest):
            req = GenerateRequest.parse_request({**req, "model_id": model_id})
        with self._lock:
            record = self._jobs.get(model_id)
        if record is not None:
            if record.job is None:
                raise KubeMLError(f"job {model_id} is still starting", 503)
            if not hasattr(record.job, "generate"):
                raise KubeMLError(
                    f"job {model_id}'s engine does not serve generation", 400)
            self.metrics.task_started("inference")
            try:
                return self._maybe_stream(record.job.generate(req), req)
            finally:
                self.metrics.task_finished("inference")
        model, tree, mtime = self._load_serving(model_id)
        decoder = self._get_decoder(model_id, model, tree, mtime)
        if decoder is not None:
            entry = decoder.submit(req)
            if req.stream:
                return self._metered_stream(decoder.stream(entry))
            self.metrics.task_started("inference")
            try:
                return decoder.wait(entry, timeout=generate_timeout(req))
            finally:
                self.metrics.task_finished("inference")
        self.metrics.task_started("inference")
        try:
            module = model.build()
            if self._slab_decodable(module):
                module = self._load_module(module, self._densified(tree))
            # a module with no decode path is generate_from_request's 400
            return self._maybe_stream(generate_from_request(module, req),
                                      req)
        finally:
            self.metrics.task_finished("inference")

    @staticmethod
    def _maybe_stream(result: dict, req):
        """A one-shot result in the streaming wire shape when the client
        asked to stream."""
        if not req.stream:
            return result

        def lines():
            for i, toks in enumerate(result["tokens"]):
                yield {"row": i, "tokens": toks[: result["lengths"][i]]}
            yield {"done": True, "lengths": result["lengths"]}

        return lines()

    def _metered_stream(self, gen):
        self.metrics.task_started("inference")

        def wrapped():
            try:
                yield from gen
            finally:
                self.metrics.task_finished("inference")

        return wrapped()

    # --- decoders ---

    def _serving_module(self, model, tree):
        """A module of its own for one decoder: built by the function,
        loaded from the host tree, on the server's device."""
        return self._load_module(model.build(), tree)

    def _load_module(self, module, tree):
        load_tree(module, from_flax(tree))
        return module.to(self.device)

    @staticmethod
    def _slab_decodable(module) -> bool:
        """Whether ``module`` can decode through a batching engine: a
        declared ``max_len`` and a forward that takes ``decode`` and
        per-row ``positions`` (JAX ``_get_decoder``'s probe)."""
        if getattr(module, "max_len", None) is None:
            return False
        try:
            params = inspect.signature(module.forward).parameters
        except (TypeError, ValueError):
            return False
        return "decode" in params and "positions" in params

    def _get_decoder(self, model_id: str, model, tree, mtime):
        """The resident decoder of a finished checkpoint, rebuilt when the
        checkpoint's mtime moved or the decoder closed; None without the
        batching engine or for a model it cannot decode (the caller then
        runs the one-shot path). The paged engine serves what it can, the
        dense one the rest."""
        if self.cfg.serving_mesh:
            raise _not_ported(f"meshed serving (serving_mesh="
                              f"{self.cfg.serving_mesh!r}, meshed serving: "
                              f"ROADMAP Queue 1 item 1)")
        if not self.cfg.serving_batcher:
            return None
        with self._lock:
            cached = self._decoders.get(model_id)
            if (cached is not None and cached[1] == mtime
                    and not cached[0].closed):
                return cached[0]
        quantize = self.cfg.serving_quantize
        if quantize not in ("", "int8"):
            log.warning("KUBEML_SERVING_QUANTIZE=%r not recognized (valid: "
                        "int8); serving unquantized", quantize)
            quantize = ""
        module = model.build()
        if not self._slab_decodable(module):
            return None
        module = self._load_module(module, tree)
        common = dict(
            slots=self.cfg.serving_slots,
            chunk_steps=self.cfg.serving_chunk_steps, name=model_id,
            quantize=quantize, int8_matmul=self.cfg.int8_matmul,
            int8_matmul_impl=self.cfg.int8_matmul_impl,
            queue_limit=self.cfg.serving_queue_limit,
            shed_policy=self.cfg.serving_shed_policy, device=self.device)
        if self.cfg.serving_paged and supports_paged_decode(module):
            decoder = self._paged_decoder(model_id, module, common)
        else:
            decoder = BatchingDecoder(module, **common)
        return self._install_decoder(model_id, decoder, mtime)

    def _paged_decoder(self, model_id: str, module, common: dict):
        common = dict(
            common,
            page_tokens=self.cfg.serving_page_tokens,
            pages=self.cfg.serving_pages,
            prefix_cache=self.cfg.serving_prefix_cache,
            paged_attn=self.cfg.paged_attn, kv_quant=self.cfg.kv_quant,
            spec_min_accept=self.cfg.spec_min_accept,
            prefill_chunk_tokens=self.cfg.prefill_chunk_tokens,
            pool_audit_interval=self.cfg.pool_audit_interval)
        spec_kw = self._spec_decoder_args()
        try:
            decoder = PagedBatchingDecoder(module, **common, **spec_kw)
        except (ValueError, KubeMLError) as e:
            # a spec configuration the engine rejects (exit layer out of
            # range, a draft that does not fit, a bad k) serves without
            # speculation; the spec check runs before anything is
            # quantized or allocated, and any other error raises again
            if not spec_kw:
                raise
            log.warning("speculative-decoding config rejected (%s); "
                        "serving %s without speculation", e, model_id)
            decoder = PagedBatchingDecoder(module, **common)
        return decoder

    def _install_decoder(self, model_id: str, decoder, mtime):
        stale = []
        with self._lock:
            # a racing thread may have built one meanwhile: theirs may
            # carry traffic already, ours has none
            current = self._decoders.get(model_id)
            if (current is not None and current[1] == mtime
                    and not current[0].closed):
                stale.append(decoder)
                decoder = current[0]
            else:
                if current is not None:
                    stale.append(current[0])
                self._decoders[model_id] = (decoder, mtime)
                while len(self._decoders) > DECODER_CACHE_SIZE:
                    oldest = next(iter(self._decoders))
                    stale.append(self._decoders.pop(oldest)[0])
        for d in stale:
            # in-flight requests on a displaced decoder finish; only new
            # submissions are refused
            d.retire()
        return decoder

    def _spec_decoder_args(self) -> dict:
        """Speculative-decoding arguments from ``serving_spec`` (off, self,
        draft). An unknown mode, a missing draft id or a draft model that
        does not load serves without speculation, with a warning."""
        spec = (self.cfg.serving_spec or "off").lower()
        if spec in ("", "off"):
            return {}
        if spec not in ("draft", "self"):
            log.warning("KUBEML_SERVING_SPEC=%r not recognized (valid: off, "
                        "draft, self); serving without speculation", spec)
            return {}
        out = dict(spec=spec, spec_k=self.cfg.spec_k,
                   spec_adaptive=self.cfg.spec_adaptive)
        if spec == "self":
            out["spec_exit_layer"] = self.cfg.spec_exit_layer
            return out
        draft_id = self.cfg.spec_draft_model
        if not draft_id:
            log.warning("KUBEML_SERVING_SPEC=draft needs "
                        "KUBEML_SPEC_DRAFT_MODEL (a finished job id); "
                        "serving without speculation")
            return {}
        try:
            # the drafter rides the target's loader: final-int8 preferred
            # under int8 serving
            dmodel, dtree, _ = self._load_serving(draft_id)
            out["draft_module"] = self._serving_module(dmodel, dtree)
            return out
        except (KubeMLError, ValueError, KeyError, OSError) as e:
            log.warning("loading the draft model %r failed (%s); serving "
                        "without speculation", draft_id, e)
            return {}

    @staticmethod
    def _densified(tree):
        """A dense f32 copy of a host tree that carries int8 leaves (for
        ``infer``, which consumes a plain tree)."""
        if not is_quantized_tree(tree):
            return tree

        def one(node):
            if isinstance(node, QuantizedTensor):
                return np.asarray(node.q, np.float32) * np.asarray(node.s)
            if isinstance(node, dict):
                return {k: one(v) for k, v in node.items()}
            return node

        return one(tree)

    def _serving_telemetry(self) -> dict:
        """{model_id: telemetry} of the resident decoders (the serving
        source of ``metrics.render()``)."""
        with self._lock:
            decoders = {mid: d for mid, (d, _) in self._decoders.items()}
        out = {}
        for mid, d in decoders.items():
            try:
                out[mid] = d.telemetry()
            except Exception:
                log.debug("telemetry for %s failed", mid, exc_info=True)
        return out

    def close(self) -> None:
        """Close every resident decoder (requests in flight fail)."""
        with self._lock:
            decoders = [d for d, _ in self._decoders.values()]
            self._decoders.clear()
        for d in decoders:
            d.close()

    # --- drain and restore across a restart ---

    def drain_serving(self, grace: Optional[float] = None) -> dict:
        """Drain every resident decoder: admissions answer 429, live rows
        get ``grace`` seconds (``drain_grace``; a dense decoder retires
        instead: it has no snapshots), and the stragglers become KMS1
        frames, written to ``snap_dir`` (one ``<model>-<request>.kms``
        each) when it is set, for the next server's
        :meth:`restore_serving`; the waiters get a retryable 503 with
        their partial tokens either way."""
        with self._lock:
            decoders = {mid: d for mid, (d, _) in self._decoders.items()}
        snap_dir = self.cfg.snap_dir
        out = {"models": [], "snapshots": 0, "written": []}
        for mid, d in decoders.items():
            try:
                if hasattr(d, "drain"):
                    frames = d.drain(grace)
                else:  # the dense engine has no snapshot seam
                    d.retire()
                    frames = []
            except Exception:
                log.exception("draining decoder %s failed", mid)
                continue
            out["models"].append(mid)
            out["snapshots"] += len(frames)
            if not (snap_dir and frames):
                continue
            os.makedirs(snap_dir, exist_ok=True)
            for frame in frames:
                try:
                    rid = (kvsnap.peek_header(frame).get("request_id")
                           or f"r{len(out['written'])}")
                    safe = "".join(c if c.isalnum() or c in "-_" else "_"
                                   for c in f"{mid}-{rid}")
                    path = os.path.join(snap_dir, safe + kvsnap.SNAP_SUFFIX)
                    with open(path, "wb") as f:
                        f.write(frame)
                    out["written"].append(path)
                except Exception:
                    log.exception("writing a snapshot of %s failed", mid)
        return out

    def restore_serving(self) -> dict:
        """Replay the ``.kms`` frames in ``snap_dir``: each goes to its
        model's decoder (by the frame's header) through
        ``submit_snapshot`` and decodes on from where it stopped; the file
        is deleted once admitted. A frame that fails stays on disk and is
        reported, not raised."""
        snap_dir = self.cfg.snap_dir
        out = {"restored": [], "failed": []}
        if not snap_dir or not os.path.isdir(snap_dir):
            return out
        for fname in sorted(os.listdir(snap_dir)):
            if not fname.endswith(kvsnap.SNAP_SUFFIX):
                continue
            path = os.path.join(snap_dir, fname)
            try:
                with open(path, "rb") as f:
                    frame = f.read()
                mid = str(kvsnap.peek_header(frame).get("model") or "")
                model, tree, mtime = self._load_serving(mid)
                decoder = self._get_decoder(mid, model, tree, mtime)
                if decoder is None or not hasattr(decoder,
                                                  "submit_snapshot"):
                    raise KubeMLError(
                        f"model {mid!r} has no snapshot-capable decoder",
                        409)
                entry = decoder.submit_snapshot(frame)
                with self._lock:
                    self._restored.append({
                        "model": mid, "request_id": entry.request_id,
                        "file": fname, "entry": entry, "decoder": decoder})
                out["restored"].append({"model": mid,
                                        "request_id": entry.request_id})
                os.unlink(path)
            except Exception as e:
                log.warning("snapshot replay failed for %s: %s", fname, e)
                out["failed"].append({"file": fname, "error": str(e)})
        return out

    def restored_snapshot(self) -> list:
        """The replayed requests and their state: done flag, tokens
        emitted so far, and the whole streams once done."""
        with self._lock:
            recs = list(self._restored)
        out = []
        for rec in recs:
            entry = rec["entry"]
            done = entry.done_evt.is_set() and entry.error is None
            row = {"model": rec["model"], "request_id": rec["request_id"],
                   "file": rec["file"], "done": done,
                   "error": str(entry.error) if entry.error else None,
                   "lengths": [len(r.out) for r in entry.rows]}
            if done:
                res = entry.result()
                row["tokens"] = [t[:n] for t, n in zip(res["tokens"],
                                                       res["lengths"])]
            out.append(row)
        return out

    # --- the served checkpoint ---

    def _sharded_store(self) -> ShardedCheckpointStore:
        return ShardedCheckpointStore(root=self._ckpt_store.root)

    def _serving_source(self, model_id: str):
        """(kind, tag, mtime_ns) of the export to serve, or (None, None,
        None): the ``final`` export, ``"flat"`` or ``"sharded"`` (the SPMD
        engine's ``sharded_checkpoints``), whichever is newer, or under
        ``serving_quantize="int8"`` a ``final-int8`` at least as fresh. A
        malformed id finds nothing (a 404, never a 500)."""

        def resolve(tag):
            form, mtime = self._ckpt_store.final_form(model_id, tag)
            return None if form is None else (form, tag, mtime)

        dense = resolve(FINAL_TAG)
        if self.cfg.serving_quantize == "int8":
            int8 = resolve(INT8_TAG)
            # a retrain under the same id must not be shadowed by a stale
            # final-int8
            if int8 is not None and (dense is None or int8[2] >= dense[2]):
                return int8
        if dense is None:
            return None, None, None
        return dense

    def _build_serving(self, model_id: str, kind: str, tag: str,
                       mtime) -> tuple:
        """(model, host tree, mtime) from the export: the function the
        checkpoint's request names, and its variables, a sharded export
        assembled on the host (JAX :1815-1860, without a serving mesh),
        re-laid out by the function's ``serving_remap`` unless the export
        is already in the serving layout (``final-int8``), int8 storage
        markers back to QuantizedTensor pairs."""
        try:
            ck = (self._ckpt_store.restore(model_id, tag=tag)
                  if kind == "flat"
                  else self._sharded_store().restore(model_id, tag))
        except CheckpointNotFoundError:
            raise JobNotFoundError(model_id)
        fn_name = ck.meta.get("request", {}).get("function_name", "")
        model = self.registry.load(fn_name)
        tree = ck.variables
        if is_quantized_storage(tree):
            tree = from_storage_tree(tree)
        remap = model.serving_remap()
        if remap is not None and ck.meta.get("layout") != "serving":
            tree = apply_remap_host(tree, remap)
        return (model, tree, mtime)

    def _load_serving(self, model_id: str):
        """(model, host tree, mtime) of a finished job through the
        mtime-checked serving cache."""
        kind, tag, mtime = self._serving_source(model_id)
        with self._lock:
            cached = self._serving_cache.get(model_id)
            if cached is not None and cached[2] != mtime:
                cached = None  # deleted or replaced since it was cached
                self._serving_cache.pop(model_id, None)
        if mtime is None:
            try:
                live = bool(self._ckpt_store.epochs(model_id))
            except StorageError:
                live = False
            if live:
                raise _not_ported(
                    f"serving job {model_id!r} before its final export "
                    f"(live jobs)")
            raise JobNotFoundError(model_id)
        if cached is None:
            cached = self._build_serving(model_id, kind, tag, mtime)
            with self._lock:
                self._serving_cache[model_id] = cached
                while len(self._serving_cache) > SERVING_CACHE_SIZE:
                    self._serving_cache.pop(next(iter(self._serving_cache)))
        return cached

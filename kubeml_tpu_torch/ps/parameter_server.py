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
  its last completed round (``TrainJob.infer``; over ranks from its
  newest checkpoint, a 409 before the first; an SPMD job answers between
  its steps, and with 409 while it trains over ranks).

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
  (a sharded one assembled on the host, ``storage.sharded_checkpoint``,
  whatever mesh wrote it: tp and ep parts, pp stages),
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

Meshed serving (``serving_mesh``, e.g. ``"tp=2"``; JAX
``_serving_mesh_for``, ``_build_serving`` and ``_get_decoder`` under a
mesh, :1781-1884, :1351-1383): over ranks, ``/generate`` of a finished
causal LM runs on a serving mesh over the first ranks of the process
group (``parallel.mesh.serving_mesh``) through the dense
``BatchingDecoder(mesh=)``, whose engine runs here and drives the other
ranks' shards in lockstep. Building one (under ``_dist_lock``) announces
``{"cmd": "serve"}`` to the followers, builds the mesh on every rank,
and each rank of it builds the model whole, places it on the mesh
(``models.gpt.place_on_mesh``) and loads its block
(:func:`load_mesh_module`): a sharded final restored block by block onto
the mesh (a ``final-int8`` as its int8 blocks, no dense leaf), a flat
final or one that needs the function's ``serving_remap`` assembled on
the host, remapped, quantized whole under int8, then cut
(``interop.from_flax.shard_tree``); every follower acknowledges, then
``go``. A spec that is invalid, has an axis below 1 or ``sp`` above 1, or
needs more ranks than the world holds is logged once and serving stays on
one rank (as JAX falls back to one device), and so does a model that
cannot decode over a mesh: the leader builds the function's model before
it takes the lock, and remembers the refusal per checkpoint mtime, so such
a model never waits for the ranks. ``/infer`` stays on one rank. A job
over the ranks holds ``_dist_lock`` for its whole run, so a meshed request
waits for it (JAX's one process shares its devices); a meshed decoder
closed meanwhile leaves its ``serve_close`` to the holder, which sends it
before it lets go (``serving.batcher.send_pending_closes``).
:meth:`announce_shutdown` closes the meshed decoders before it releases
the followers.

Standalone jobs (``standalone_jobs``; JAX :303-600): each job runs in a
runner process of its own (``engine/job_runner.py``, the reference's job
pod), spawned with the server's device (the kernel and the native
libraries are built first, so no runner compiles), which prints
``LISTENING <port>`` and takes the task on ``/start``; ``/update``,
``/stop`` and ``/preempt`` go to the runner's routes, the runner reports
its end on ``/finish/{jobId}`` (:meth:`finish_standalone`) and
:meth:`shutdown_standalone_jobs` ends them at shutdown. A preempted runner
that has not yielded within the grace gets a SIGKILL. Over ranks
``standalone_jobs`` is JAX's 400. A live standalone job's ``/infer`` is
served here (JAX :1163-1212, :1455-1560), in JAX's order: from the
runner's tensor socket (``native.weights.fetch_variables`` through a
per-job ``FetchCache``), else by pulling its weights on the KMW1 wire
(``GET /weights?since=N`` into a per-job ``DeltaDecoder``, re-pulled in
full on ``BaseVersionMismatch``), else the runner's own JSON ``/infer``;
:attr:`ParameterServer.infer_routes` counts the answers by route
(``socket``, ``wire``, ``json``). ``/generate`` is forwarded to the
runner.

The liveness monitor (``_monitor_loop``, every 2 s while jobs run) fails
a standalone job whose runner died without reporting (its slot freed; a
preempted one keeps its journal and is requeued) and a threaded job whose
heartbeat is older than ``function_timeout`` (twice that before its first
round); the wedged thread is abandoned. Jobs over ranks have the stall
watchdog on every rank instead.

A model id with epoch checkpoints but no final export and no live record
is a 404, as in JAX. Traces and the time-series store are not ported. The
server runs on the card unless given ``device="cpu"``.
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
                          KubeMLError, error_from_envelope)
from ..api.types import (GenerateRequest, History, JobState, JobStateEnum,
                         TrainTask, generate_timeout)
from ..engine import job_class_for
from ..engine.job import TrainJob
from ..functions.registry import FunctionRegistry
from ..interop.from_flax import from_flax, from_flax_variables
from ..models.generation import (generate_from_request,
                                 supports_paged_decode)
from ..models.layers import load_tree
from ..parallel.distributed import get_dist_context
from ..parallel.mesh import serving_mesh, serving_ranks
from ..serving import BatchingDecoder, PagedBatchingDecoder, kvsnap
from ..serving.batcher import send_pending_closes
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
    # a standalone job: its runner process (subprocess.Popen) and URL
    proc: Optional[object] = None
    url: Optional[str] = None
    # its seconds from the spawn to the LISTENING line
    listening_s: Optional[float] = None


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
        # finals that cannot decode over the serving mesh: model -> mtime
        self._unmeshable: Dict[str, int] = {}
        # requests replayed from snap_dir: {"model", "request_id", "file",
        # "entry", "decoder"}
        self._restored: List[dict] = []
        self._lock = threading.RLock()
        # over ranks: this server runs on rank 0 and announces each job to
        # the followers; jobs over ranks run one at a time (_dist_lock),
        # and a meshed decoder's ops take it too (reentrant: building one
        # holds it while the decoder announces itself)
        self.dist = dist if dist is not None and dist.size > 1 else None
        self._dist_lock = threading.RLock()
        self._dist_run = 0  # per-announcement nonce of the ack keys
        self._mesh_axes = None  # serving_mesh's axes once checked
        self._monitor: Optional[threading.Thread] = None  # liveness watch
        # a live standalone job's weights: (model, tree, version,
        # FetchCache) from its tensor socket, and (model, tree,
        # DeltaDecoder) from its KMW1 wire; a decode holds the job's lock
        # (the decoder is stateful)
        self._socket_cache: Dict[str, tuple] = {}
        self._wire_cache: Dict[str, tuple] = {}
        self._wire_locks: Dict[str, threading.Lock] = {}
        # live standalone /infer answers by route
        self.infer_routes: Dict[str, int] = {"socket": 0, "wire": 0,
                                             "json": 0}

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
            self._start_standalone(task)
            return
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
        self._ensure_monitor()

    def _reserve_slot(self, task: TrainTask) -> _JobRecord:
        """Take the job's index slot (a duplicate id is a 400), drop a
        cached finished model of a reused id, journal the request."""
        placeholder = _JobRecord(task=task, job=None, thread=None)
        with self._lock:
            if task.job_id in self._jobs:
                raise KubeMLError(f"job {task.job_id} already exists", 400)
            self._jobs[task.job_id] = placeholder
            self._serving_cache.pop(task.job_id, None)
            self._socket_cache.pop(task.job_id, None)
            self._wire_cache.pop(task.job_id, None)
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

    # --- standalone runners (JAX :303-600) ---

    def _start_standalone(self, task: TrainTask) -> None:
        """Spawn the job's runner on this server's device, read its port,
        hand it the task (with retries, one idempotency key)."""
        import subprocess
        import sys
        import uuid

        from ..native import native_available
        from ..utils import http_client

        placeholder = self._reserve_slot(task)
        try:
            if self.device.type == "cuda":
                # the runners load the kernels; none compiles them
                from ..ops import kernels

                kernels.library()
            native_available()  # built here, so no runner falls back
            env = dict(os.environ, KUBEML_DATA_ROOT=str(self.cfg.data_root),
                       KUBEML_HOST=self.cfg.host,
                       KUBEML_SCHEDULER_PORT=str(self.cfg.scheduler_port),
                       KUBEML_PS_PORT=str(self.cfg.ps_port))
            t0 = time.monotonic()
            proc = subprocess.Popen(
                [sys.executable, "-m", "kubeml_tpu_torch.engine.job_runner",
                 "--job-id", task.job_id, "--port", "0",
                 "--device", str(self.device)],
                stdout=subprocess.PIPE, text=True, env=env)
            # the runner prints its port first; a crashed one gives EOF
            line = proc.stdout.readline().strip()
            listening_s = time.monotonic() - t0
            if not line.startswith("LISTENING "):
                proc.kill()
                proc.wait()
                raise KubeMLError(
                    f"job runner for {task.job_id} failed to start: "
                    f"{line!r}", 500)
            url = f"http://{self.cfg.advertise_host}:{int(line.split()[1])}"
            # user code prints into the pipe: drain it into the log, or the
            # runner blocks once it fills
            threading.Thread(target=self._drain_runner_output,
                             args=(task.job_id, proc.stdout),
                             name=f"job-{task.job_id}-stdout",
                             daemon=True).start()
            # routable before the task is handed over: a job that fails at
            # once posts /finish at once
            with self._lock:
                placeholder.proc = proc
                placeholder.url = url
                placeholder.listening_s = listening_s
            last = None
            start_key = uuid.uuid4().hex
            for attempt in range(10):
                try:
                    r = http_client.post(f"{url}/start", json=task.to_dict(),
                                         timeout=http_client.timeouts(30),
                                         idempotency_key=start_key)
                    if r.status_code < 400:
                        break
                    last = r.text
                except http_client.TransportError as e:
                    last = str(e)
                time.sleep(0.2 * (attempt + 1))
            else:
                proc.kill()
                raise KubeMLError(f"could not start job {task.job_id} on "
                                  f"its runner: {last}", 500)
        except Exception as e:
            self._fail_start(task, e)
            raise
        task.status = JobStateEnum.RUNNING
        self.metrics.task_started("train")
        self._ensure_monitor()
        log.info("standalone job %s running at %s (pid %d, LISTENING after "
                 "%.2fs)", task.job_id, url, proc.pid, listening_s)

    def _fail_dead_record(self, job_id: str, record: _JobRecord,
                          error: str) -> bool:
        """The teardown of a job whose runner or thread died without
        finishing: a stale record is left alone, a preempted one ends
        ``preempted`` (its journal and checkpoint resume it), any other is
        failed with a history."""
        with self._lock:
            if self._jobs.get(job_id) is not record:
                return False
        if record.preempt_t0 is not None:
            log.warning("preempted job %s terminated before a clean yield "
                        "(%s); resuming from its newest checkpoint", job_id,
                        error)
            record.task.status = JobStateEnum.PREEMPTED
            return self._finish(job_id, expect=record)
        record.task.status = JobStateEnum.FAILED
        self._ensure_failure_history(job_id, record.task.parameters, error)
        return self._finish(job_id, expect=record)

    def _handle_runner_death(self, job_id: str, record: _JobRecord) -> bool:
        """A runner that exited without its /finish (a crash, a kill, or its
        stall watchdog's exit 74)."""
        from ..utils.watchdog import STALL_EXIT_CODE

        rc = record.proc.returncode
        if rc == STALL_EXIT_CODE:
            msg = (f"job runner stalled (no progress within "
                   f"KUBEML_FUNCTION_TIMEOUT) and recycled itself (exit "
                   f"{rc}): the card was released with the process")
        else:
            msg = f"job runner exited with code {rc}"
        handled = self._fail_dead_record(job_id, record, msg)
        if handled:
            log.error("standalone job %s runner exited (code %s) without "
                      "reporting; marked failed", job_id, rc)
        return handled

    def _ensure_monitor(self) -> None:
        """Start the liveness monitor unless it runs."""
        with self._lock:
            if self._monitor is not None and self._monitor.is_alive():
                return
            self._monitor = threading.Thread(
                target=self._monitor_loop, name="ps-job-monitor", daemon=True)
            self._monitor.start()

    def _monitor_loop(self) -> None:
        while True:
            time.sleep(2.0)
            with self._lock:
                records = list(self._jobs.items())
                if not records:
                    self._monitor = None  # a new job starts it again
                    return
            timeout = self.cfg.function_timeout
            for jid, record in records:
                if record.proc is not None:
                    if record.proc.poll() is not None:
                        self._handle_runner_death(jid, record)
                    continue
                job = record.job
                if not (timeout and timeout > 0 and job is not None
                        and record.thread is not None
                        and record.thread.is_alive()):
                    continue
                if getattr(job, "dist", None) is not None:
                    continue  # over ranks: the stall watchdog's
                hb = getattr(job, "heartbeat", None)
                if hb is None:
                    continue
                stale = time.time() - hb
                # twice the allowance before the first round lands
                allowed = timeout * (2.0 if getattr(job, "heartbeat_cold",
                                                    False) else 1.0)
                if stale > allowed:
                    self._handle_wedged_job(jid, record, stale, timeout,
                                            allowed)

    def _handle_wedged_job(self, job_id: str, record: _JobRecord,
                           stale: float, timeout: float,
                           allowed: float) -> None:
        """Fail a threaded job whose user code stopped making progress: the
        thread is abandoned (Python cannot kill it), the job failed and its
        slot freed."""
        try:
            record.job.stop()  # cooperative; a wedged thread ignores it
        except Exception:
            pass
        extra = (f", cold-start allowance {allowed:g}s"
                 if allowed != timeout else "")
        handled = self._fail_dead_record(
            job_id, record,
            f"job made no progress for {stale:.0f}s (function execution "
            f"timeout {timeout:g}s; KUBEML_FUNCTION_TIMEOUT{extra}) — user "
            f"code abandoned")
        if handled:
            log.error("job %s: heartbeat stale for %.0fs; thread abandoned "
                      "and job marked failed", job_id, stale)

    @staticmethod
    def _drain_runner_output(job_id: str, stream) -> None:
        try:
            for line in stream:
                log.info("[job %s] %s", job_id, line.rstrip())
        except (ValueError, OSError):
            pass  # closed at the reap

    def finish_standalone(self, job_id: str, status: str = "",
                          error: Optional[str] = None) -> None:
        """``/finish/{jobId}``, a runner's report of its end (JAX
        :493-510); a 404 for a threaded or unknown job."""
        with self._lock:
            record = self._jobs.get(job_id)
        if record is None or record.proc is None:
            raise JobNotFoundError(job_id)
        record.task.status = {
            "finished": JobStateEnum.FINISHED,
            "stopped": JobStateEnum.STOPPED,
            "failed": JobStateEnum.FAILED,
            "preempted": JobStateEnum.PREEMPTED,
        }.get(status, JobStateEnum.FINISHED if not error
              else JobStateEnum.FAILED)
        if record.task.status == JobStateEnum.PREEMPTED:
            # preempted on the runner's own route: the journal survives
            record.keep_journal = True
        self._finish(job_id)
        self._reap(record)

    def _reap(self, record: _JobRecord) -> None:
        def reap():
            try:
                record.proc.wait(timeout=30)
            except Exception:
                record.proc.kill()

        threading.Thread(target=reap, name="job-reaper", daemon=True).start()

    def shutdown_standalone_jobs(self) -> None:
        """SIGTERM every live runner (cluster stop); their journals stay
        for the next boot's resume."""
        with self._lock:
            records = [r for r in self._jobs.values() if r.proc is not None]
        for r in records:
            r.keep_journal = True
            try:
                r.proc.terminate()
            except Exception:
                pass

    def _runner_call(self, job_id: str, record: _JobRecord, method: str,
                     route: str, **kw):
        """One call to a runner's route: a 502 when it cannot be reached,
        its own error when it answers one."""
        from ..utils import http_client

        try:
            r = http_client.request(method, f"{record.url}{route}",
                                    timeout=http_client.timeouts(10), **kw)
        except http_client.TransportError as e:
            raise KubeMLError(f"job {job_id} runner unreachable: {e}", 502)
        if r.status_code >= 400:
            raise error_from_envelope(r.content, r.status_code)
        return r

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
            send_pending_closes()
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
            if task.status != JobStateEnum.FAILED:
                # the decoders closed while the job held the ranks (after a
                # failure the next holder sends them, if the ranks live)
                send_pending_closes()

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
            # the socket and the wire end with the runner
            self._socket_cache.pop(job_id, None)
            self._wire_cache.pop(job_id, None)
            self._wire_locks.pop(job_id, None)
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
        if record.url is not None:
            from ..utils import http_client

            try:
                http_client.post(f"{record.url}/update",
                                 json={"parallelism": parallelism},
                                 timeout=http_client.timeouts(10),
                                 idempotency_key=True)
            except http_client.TransportError as e:
                log.warning("job %s: update delivery failed: %s", job_id, e)
            return
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
        try:
            if record.url is not None:
                self._runner_call(job_id, record, "POST", "/preempt",
                                  idempotency_key=True)
            elif record.job is None:
                raise KubeMLError(f"job {job_id} is still starting", 409)
            else:
                record.job.preempt()
                if record.update_box is not None:
                    # the yield must not wait out the scheduler's answer
                    record.update_box.event.set()
        except Exception:
            # the signal never reached the job: a retry is again the first
            if first:
                record.preempt_t0 = None
            raise
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
        ended with the ``preempted`` status (a runner gets a SIGKILL, a
        thread is stopped cooperatively and abandoned): the journal entry
        and its newest checkpoint keep it resumable."""
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
        if record.proc is not None:
            try:
                record.proc.kill()
            except Exception:
                pass
            self._reap(record)
        else:
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
        if record.url is not None:
            self._runner_call(job_id, record, "DELETE", "/stop")
            return
        if record.job is None:
            raise KubeMLError(f"job {job_id} is still starting", 409)
        record.job.stop()

    def wait(self, job_id: str, timeout: Optional[float] = None) -> bool:
        """Join a job's thread, or poll a standalone job's record until its
        runner reports; True once it has ended (or no such job)."""
        with self._lock:
            record = self._jobs.get(job_id)
        if record is None:
            return True
        if record.proc is not None:
            deadline = time.time() + (timeout if timeout is not None
                                      else 3600.0)
            while time.time() < deadline:
                with self._lock:
                    if self._jobs.get(job_id) is not record:
                        return True
                if record.proc.poll() is not None:
                    self._handle_runner_death(job_id, record)
                    return True
                time.sleep(0.1)
            return False
        if record.thread is None:
            return False  # still starting
        try:
            record.thread.join(timeout)
        except RuntimeError:
            return False  # created but not started yet
        return not record.thread.is_alive()

    def prune_tasks(self) -> int:
        """``kubeml task prune``: tear down records whose job thread or
        runner died without finishing; returns the count."""
        with self._lock:
            candidates = list(self._jobs.items())
        pruned = 0
        for job_id, record in candidates:
            if record.proc is not None:
                if (record.proc.poll() is not None
                        and self._handle_runner_death(job_id, record)):
                    pruned += 1
                continue
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
        lock until its epoch ends), the meshed decoders closed first."""
        if self.dist is not None:
            with self._lock:
                meshed = [mid for mid, (d, _) in self._decoders.items()
                          if getattr(d, "mesh", None) is not None]
                decoders = [self._decoders.pop(mid)[0] for mid in meshed]
            for d in decoders:
                d.close()
            with self._dist_lock:
                send_pending_closes()
                self.dist.broadcast_obj({"cmd": "shutdown"})

    # --- /infer and /generate ---

    def infer(self, model_id: str, data) -> list:
        """``/infer``: a live job's model on its merged weights of the last
        completed round, or a finished job's final export."""
        with self._lock:
            record = self._jobs.get(model_id)
        if record is None:
            return self._infer_from_checkpoint(model_id, data)
        if record.url is not None:
            return self._infer_standalone(model_id, record, data)
        if record.job is None:
            raise KubeMLError(f"job {model_id} is still starting", 503)
        self.metrics.task_started("inference")
        try:
            return np.asarray(record.job.infer(json_batch(data))).tolist()
        finally:
            self.metrics.task_finished("inference")

    # --- a live standalone job's /infer (JAX :1163-1212, :1455-1560) ---

    def _infer_standalone(self, model_id: str, record: _JobRecord,
                          data) -> list:
        """The runner's tensor socket, else its KMW1 wire, else its JSON
        ``/infer``; :attr:`infer_routes` counts the route that answered."""
        for route, fetch in (("socket", self._socket_weights),
                             ("wire", self._wire_weights)):
            try:
                got = fetch(model_id, record)
            except Exception:
                log.debug("%s weights of %s failed; next route", route,
                          model_id, exc_info=True)
                continue
            if got is not None:
                out = self._infer_live(record, got[0], got[1], data)
                self._count_route(route)
                return out
        r = self._runner_call(model_id, record, "POST", "/infer",
                              json={"data": data})
        self._count_route("json")
        return r.json()["predictions"]

    def _count_route(self, route: str) -> None:
        with self._lock:
            self.infer_routes[route] += 1

    def _socket_weights(self, model_id: str, record: _JobRecord):
        """(model, host tree) of the runner's newest published epoch from
        its tensor socket, pulling only the leaves whose version moved; an
        epoch cached here serves while a publish is in progress. None when
        the socket is off or absent or nothing was published."""
        if not self.cfg.tensor_sockets:
            return None
        sock = self.cfg.job_socket_path(model_id)
        if not sock.exists():
            return None
        from ..native.bindings import TensorClient
        from ..native.weights import (FetchCache, fetch_variables,
                                      read_version)

        with self._lock:
            cached = self._socket_cache.get(model_id)
        with TensorClient(str(sock), timeout=10) as client:
            version = read_version(client)
            if version is None:
                if cached is None:
                    return None
            elif cached is None or cached[2] != version:
                fetch_cache = (cached[3] if cached is not None
                               else FetchCache())
                variables, version = fetch_variables(client,
                                                     cache=fetch_cache)
                if variables is None:
                    return None
                model = self.registry.load(
                    record.task.parameters.function_name)
                cached = (model, variables, version, fetch_cache)
                with self._lock:
                    self._socket_cache[model_id] = cached
        return cached[0], cached[1]

    def _wire_weights(self, model_id: str, record: _JobRecord):
        """(model, host tree) pulled over the runner's ``GET /weights``:
        one 204 while current, the delta when one version behind, a full
        snapshot otherwise (and after a ``BaseVersionMismatch``). None
        before the runner published anything."""
        from ..engine import dataplane
        from ..engine.dataplane import BaseVersionMismatch, DeltaDecoder
        from ..utils import http_client

        with self._lock:
            wire_lock = self._wire_locks.setdefault(model_id,
                                                    threading.Lock())
            cached = self._wire_cache.get(model_id)
        # the GET runs outside the job's lock: only the decode and the
        # cache swap need it
        since_v = cached[2].version if cached is not None else None
        url = f"{record.url}/weights"
        since = f"?since={since_v}" if since_v is not None else ""
        r = http_client.get(url + since, timeout=http_client.timeouts(60))
        if r.status_code == 404:
            return None
        if r.status_code >= 400:
            raise error_from_envelope(r.content, r.status_code)
        if r.status_code == 204:
            return cached[0], cached[1]
        target = int(r.headers.get(dataplane.VERSION_HEADER.lower(), "0"))
        # the model before the decode: the decoder advances in place, and
        # nothing that can raise may follow it
        model = self.registry.load(record.task.parameters.function_name)
        with wire_lock:
            with self._lock:
                cached = self._wire_cache.get(model_id)
            decoder = cached[2] if cached is not None else DeltaDecoder()
            if cached is not None and decoder.version == target:
                return cached[0], cached[1]  # decoded meanwhile
            try:
                variables, _ = decoder.decode(r.content)
            except BaseVersionMismatch:
                # the runner keeps one delta step: a full snapshot, a fresh
                # chain
                decoder = DeltaDecoder()
                r = http_client.get(url, timeout=http_client.timeouts(60))
                if r.status_code >= 400:
                    return None
                variables, _ = decoder.decode(r.content)
            with self._lock:
                self._wire_cache[model_id] = (model, variables, decoder)
        return model, variables

    def _infer_live(self, record: _JobRecord, model, variables, data) -> list:
        """``model.infer`` on a live job's host tree (the port's layout), on
        this server's device, the input cast as the job's trainer casts
        it."""
        bf16 = record.task.parameters.options.precision == "bf16"
        self.metrics.task_started("inference")
        try:
            with torch.no_grad():
                dev_vars = {c: {k: torch.as_tensor(v).to(self.device)
                                for k, v in leaves.items()}
                            for c, leaves in variables.items()}
                model.module.to(self.device)
                x = torch.as_tensor(json_batch(data)).to(self.device)
                if bf16 and x.is_floating_point():
                    x = x.to(torch.bfloat16)
                out = model.infer(dev_vars, model.preprocess(x))
            return out.cpu().numpy().tolist()
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
                x = torch.as_tensor(json_batch(data)).to(self.device)
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
        if record is not None and record.url is not None:
            from ..utils import http_client

            # the runner serves one-shot only: forwarded unstreamed, the
            # answer re-wrapped for a streaming client
            fwd = {**req.to_dict(), "stream": False}
            try:
                r = http_client.post(
                    f"{record.url}/generate", json=fwd,
                    timeout=http_client.timeouts(generate_timeout(req)))
            except http_client.TransportError as e:
                raise KubeMLError(f"job {model_id} runner unreachable: {e}",
                                  502)
            return self._maybe_stream(http_client.check(r), req)
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
        decoder = self._mesh_decoder(model_id)
        if decoder is None:
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
        if not self.cfg.serving_batcher:
            return None
        cached = self._cached_decoder(model_id, mtime)
        if cached is not None:
            return cached
        module = model.build()
        if not self._slab_decodable(module):
            return None
        module = self._load_module(module, tree)
        common = self._decoder_args(model_id)
        if self.cfg.serving_paged and supports_paged_decode(module):
            decoder = self._paged_decoder(model_id, module, common)
        else:
            decoder = BatchingDecoder(module, **common)
        return self._install_decoder(model_id, decoder, mtime)

    def _cached_decoder(self, model_id: str, mtime):
        with self._lock:
            cached = self._decoders.get(model_id)
            if (cached is not None and cached[1] == mtime
                    and not cached[0].closed):
                return cached[0]
        return None

    def _quantize_mode(self) -> str:
        quantize = self.cfg.serving_quantize
        if quantize not in ("", "int8"):
            log.warning("KUBEML_SERVING_QUANTIZE=%r not recognized (valid: "
                        "int8); serving unquantized", quantize)
            quantize = ""
        return quantize

    def _decoder_args(self, model_id: str) -> dict:
        return dict(
            slots=self.cfg.serving_slots,
            chunk_steps=self.cfg.serving_chunk_steps, name=model_id,
            quantize=self._quantize_mode(), int8_matmul=self.cfg.int8_matmul,
            int8_matmul_impl=self.cfg.int8_matmul_impl,
            queue_limit=self.cfg.serving_queue_limit,
            shed_policy=self.cfg.serving_shed_policy, device=self.device)

    # --- meshed serving ---

    def _serving_mesh_axes(self) -> Optional[dict]:
        """The axes of ``serving_mesh`` when they make a mesh of several
        ranks this server can serve on, else None: an invalid spec, an
        axis below 1 or ``sp`` above 1, or more ranks than the world holds
        is logged (once) and serving stays on one rank (JAX
        ``_serving_mesh_for``, :1781-1816)."""
        if self._mesh_axes is None:
            try:
                axes = self.cfg.serving_mesh_axes()
                n = serving_ranks(axes, self.world)
            except ValueError as e:
                log.warning("serving mesh %r refused (%s): serving on one "
                            "rank", self.cfg.serving_mesh, e)
                axes, n = {}, 1
            self._mesh_axes = axes if n > 1 else {}
        return self._mesh_axes or None

    def _mesh_decoder(self, model_id: str):
        """The resident meshed decoder of a finished checkpoint, built when
        the serving mesh applies (see the module docstring); None
        otherwise, and for a model that cannot decode over a mesh."""
        if not self.cfg.serving_batcher:
            return None
        axes = self._serving_mesh_axes()
        if axes is None:
            return None
        kind, tag, mtime = self._serving_source(model_id)
        if mtime is None:
            return None  # _load_serving answers the 404 or 400
        cached = self._cached_decoder(model_id, mtime)
        if cached is not None:
            return cached
        with self._lock:
            if self._unmeshable.get(model_id) == mtime:
                return None
        assert self.dist is get_dist_context(), \
            "meshed serving runs over the process-wide DistContext"
        spec = {"model": model_id, "kind": kind, "tag": tag, "mesh": axes,
                "quantize": self._quantize_mode()}
        try:
            # outside the lock: a model that cannot be meshed must not wait
            # for a job over the ranks
            source = mesh_source(self.registry, self._ckpt_store, spec)
        except NotMeshable as e:
            log.info("%s serves on one rank: %s", model_id, e)
            with self._lock:
                self._unmeshable[model_id] = mtime
                while len(self._unmeshable) > SERVING_CACHE_SIZE:
                    self._unmeshable.pop(next(iter(self._unmeshable)))
            return None
        # held through the decoder's construction (it announces itself to
        # the followers, which take the module this announcement built)
        with self._dist_lock:
            send_pending_closes()
            cached = self._cached_decoder(model_id, mtime)
            if cached is not None:
                return cached  # another request built it meanwhile
            run = self._dist_run
            self._dist_run += 1
            self.dist.broadcast_obj({"cmd": "serve", "run": run, **spec})
            mesh = serving_mesh(axes)
            module, error = None, None
            try:
                module = load_mesh_module(self.registry, self._ckpt_store,
                                          spec, mesh, source=source)
            except Exception as e:
                error = e
            errs = []
            for rank in range(1, self.dist.size):
                ack = self.dist.get(f"kubeml/ack/{run}/{rank}",
                                    timeout_s=self.cfg.dist_ack_timeout)
                if ack is None:
                    errs.append(f"rank {rank}: no serving ack (timeout)")
                elif ack != "ok":
                    errs.append(f"rank {rank}: {ack}")
            self.dist.broadcast_obj({"go": error is None and not errs})
            if error is not None:
                raise error
            if errs:
                raise KubeMLError(f"meshed serving of {model_id} could not "
                                  f"start: " + "; ".join(errs), 503)
            decoder = BatchingDecoder(module, mesh=mesh,
                                      dist_lock=self._dist_lock,
                                      **self._decoder_args(model_id))
            log.info("serving %s (%s final) on mesh %s", model_id, kind,
                     mesh.shape)
            # a load that outlasted CLOSE_WAIT_S may have queued closes
            send_pending_closes()
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

    def serving_telemetry(self) -> dict:
        """{model_id: telemetry} of the resident decoders: the overload
        signals the preemption controller polls (queue depth, 429
        counters, request p99)."""
        return self._serving_telemetry()

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
        assembled on the host (JAX :1815-1860, one rank's serving),
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
            # epoch checkpoints alone do not serve (JAX :1896-1897)
            raise JobNotFoundError(model_id)
        if cached is None:
            cached = self._build_serving(model_id, kind, tag, mtime)
            with self._lock:
                self._serving_cache[model_id] = cached
                while len(self._serving_cache) > SERVING_CACHE_SIZE:
                    self._serving_cache.pop(next(iter(self._serving_cache)))
        return cached


def json_batch(data) -> np.ndarray:
    """A request's JSON array as a host batch: float64 (what JSON numbers
    parse to) as float32, as JAX's default dtypes take it."""
    x = np.asarray(data)
    return x.astype(np.float32) if x.dtype == np.float64 else x


class NotMeshable(ValueError):
    """A finished model that cannot decode over a serving mesh (no
    ``CausalTransformer``): it serves on one rank."""


def mesh_source(registry: FunctionRegistry, ckpt_store: CheckpointStore,
                spec: dict) -> tuple:
    """(the function's model, its module built whole, the export's meta,
    the flat checkpoint or None for a sharded one) of the finished model
    that ``spec`` names (the ``serve`` announcement's ``model``, ``kind``
    and ``tag``). Raises :class:`NotMeshable` for a model that cannot
    decode over a mesh."""
    from ..models.gpt import CausalTransformer

    model_id, kind, tag = spec["model"], spec["kind"], spec["tag"]
    try:
        if kind == "flat":
            ck = ckpt_store.restore(model_id, tag=tag)
            meta = ck.meta
        else:
            ck, meta = None, ShardedCheckpointStore(
                root=ckpt_store.root).read_manifest(model_id, tag).get(
                    "meta", {})
    except CheckpointNotFoundError:
        raise JobNotFoundError(model_id)
    model = registry.load(meta.get("request", {}).get("function_name", ""))
    module = model.build()
    if not isinstance(module, CausalTransformer):
        raise NotMeshable(f"{type(module).__name__} does not decode over a "
                          f"serving mesh")
    return model, module, meta, ck


def load_mesh_module(registry: FunctionRegistry, ckpt_store: CheckpointStore,
                     spec: dict, mesh, source: Optional[tuple] = None):
    """This rank's block of a finished model on a serving ``mesh``, on the
    rank's device, as every rank of the mesh builds it (``spec``: the
    ``serve`` announcement's ``model``, ``kind``, ``tag`` and
    ``quantize``; ``source``: :func:`mesh_source`'s answer, when the
    caller has it already). The function's model is built whole and
    placed on the mesh; a sharded export restores this rank's blocks only
    (int8 storage markers as int8 blocks); a flat one, or one that needs
    the function's ``serving_remap``, is assembled on the host, remapped,
    quantized whole under ``quantize="int8"`` and cut (``shard_tree``). A
    dense block tree is quantized later, in place (``BatchingDecoder``).
    Raises :class:`NotMeshable` for a model that cannot decode over a
    mesh."""
    from ..interop.from_flax import shard_tree
    from ..models.gpt import place_on_mesh
    from ..serving.quant import quantize_tree

    model, module, meta, ck = source or mesh_source(registry, ckpt_store,
                                                    spec)
    model_id, tag = spec["model"], spec["tag"]
    sharded = ShardedCheckpointStore(root=ckpt_store.root)
    place_on_mesh(module, mesh)
    remap = None if meta.get("layout") == "serving" else \
        model.serving_remap()
    if ck is None and remap is None:
        # this rank's blocks of each leaf, from the slices that overlap them
        tree = from_flax(from_storage_tree(sharded.restore(
            model_id, tag, mesh=mesh).variables))
    else:
        if ck is None:
            ck = sharded.restore(model_id, tag)
        host = ck.variables
        if is_quantized_storage(host):
            host = from_storage_tree(host)
        if remap is not None:
            host = apply_remap_host(host, remap)
        tree = from_flax(host)
        if spec.get("quantize") == "int8" and not is_quantized_tree(host):
            tree = quantize_tree(tree)  # whole: the global scales
        tree = shard_tree(tree, mesh)
    load_tree(module, tree)
    return module.to(mesh.device)

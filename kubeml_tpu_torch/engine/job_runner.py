"""Standalone job process: the reference's dedicated per-job pod, a
subprocess here. The port of ``kubeml_tpu/engine/job_runner.py``.

The reference PS creates a pod per job and talks HTTP to it
(ml/pkg/ps/job_pod.go:96-217; routes ml/pkg/train/api.go:141-149). Here
the parameter server spawns ``python -m kubeml_tpu_torch.engine.job_runner
--job-id ID --port 0 --device DEV``; the runner binds a port, prints
``LISTENING <port>`` on stdout for its parent, writes its log to
``<data root>/logs/job-<id>.log`` (what ``kubeml logs --id`` reads) and
serves:

* ``POST /start`` — a ``TrainTask``: load the function, run the job (a
  K-AVG ``TrainJob`` or an ``SPMDJob``) on a thread; a second start is a
  400;
* ``POST /update`` — the scheduler's parallelism answer (through the PS);
* ``DELETE /stop`` — a cooperative stop; ``POST /preempt`` —
  checkpoint-and-yield, leaving with the ``preempted`` status;
* ``POST /infer``, ``POST /generate`` — serve the live model (503 before
  ``/start``);
* ``GET /weights[?since=N]`` — the live reference weights as one KMW1
  payload (``engine.dataplane.WeightsWire``: the delta when the caller is
  one version behind, a full snapshot otherwise, 204 when current, 404
  before the first publish);
* ``GET /state`` — status, epochs run and error; ``GET /health``.

A K-AVG job publishes each epoch's reference weights off the training
thread (only the newest epoch waiting is kept): into a native tensor store
served on the job's unix socket (``tensor_sockets``;
``native.weights.publish_variables``, delta by leaf) and into the KMW1
wire. At its end the runner posts ``/finish/{jobId}`` to the PS
(idempotency-keyed), lingers a few seconds for late ``/state`` reads and
exits. Each epoch's end asks the scheduler (``/job``) and waits at most
``update_timeout`` seconds for ``/update``; each epoch's metrics push
carries the data-plane counter deltas as sequenced batches that ride every
push until one is acknowledged with a 2xx. A SIGTERM stops the job
cooperatively. The stall watchdog (``utils.watchdog``) ends a runner
whose job stopped making progress with exit 74; the PS's monitor then
fails the job and frees its slot.

The runner runs on the device ``--device`` names, the PS's own; one asked
for ``cuda`` on a host without a card exits with an error (the job is
failed, never run on the CPU). The PS builds the kernel library before it
spawns a runner on a card, so runners load it. Where JAX opens a span or
binds a trace context, the port does nothing: tracing is a later slice.
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading
import time
from typing import Optional

log = logging.getLogger("kubeml.jobrunner")


class JobRunner:
    """One job's HTTP surface and lifecycle inside its own process."""

    def __init__(self, job_id: str, config=None, port: int = 0,
                 device=None):
        from ..api.config import get_config
        from ..utils.device import resolve_device
        from ..utils.httpd import Router, Service

        self.cfg = config or get_config()
        self.job_id = job_id
        self.device = resolve_device(device)
        self.job = None
        self.thread: Optional[threading.Thread] = None
        self.status = "starting"
        self.exit_error: Optional[str] = None
        self.done = threading.Event()
        # the epoch weights' channels: the socket-served native store (K-AVG
        # jobs with tensor_sockets) and the KMW1 wire
        self._tensor_store = None
        self._tensor_server = None
        self._weights_wire = None
        self._publish_state = None  # the store's delta memory
        # at most one publish runs, off the training thread; a publish
        # superseded while it waits is dropped
        self._publish_pending = None
        self._publish_thread: Optional[threading.Thread] = None
        # a fresh box per epoch-end request: a late answer for epoch N
        # must not satisfy epoch N+1's wait
        self._update_box: Optional[list] = None  # [Event, parallelism]
        # data-plane counter hand-off to the PS: each push cuts the delta
        # since the last cut into a sequenced batch; unacknowledged batches
        # ride every push, and the PS applies each seq at most once
        self._dp_cut: dict = {}
        self._dp_unacked: list = []
        self._dp_seq = 0
        self._lock = threading.Lock()

        router = Router(f"job-{job_id}")
        router.route("POST", "/start", self._start)
        router.route("POST", "/update", self._update)
        router.route("DELETE", "/stop", self._stop)
        router.route("POST", "/preempt", self._preempt)
        router.route("POST", "/infer", self._infer)
        router.route("POST", "/generate", self._generate)
        router.route("GET", "/weights", self._weights)
        router.route("GET", "/state", self._state)
        self.service = Service(router, self.cfg.host, port)

    def _start_tensor_server(self) -> None:
        store = None
        try:
            from ..native.bindings import TensorServer, TensorStore

            store = TensorStore()
            if not store.native:
                store.close()
                log.info("native tensor store unavailable; the PS serves "
                         "live /infer over the weight wire")
                return
            sock = self.cfg.job_socket_path(self.job_id)
            sock.unlink(missing_ok=True)
            self._tensor_server = TensorServer(store, str(sock))
            self._tensor_store = store
            log.info("tensor server for %s at %s", self.job_id, sock)
        except Exception:
            if store is not None and self._tensor_store is None:
                store.close()
            log.exception("tensor server start failed (non-fatal; the "
                          "weight wire remains)")

    def _publish_weights(self, variables: dict, epoch: int) -> None:
        """The epoch-weights hook, on the training thread with a host copy:
        the publish runs on a background thread while the next epoch
        trains."""
        with self._lock:
            self._publish_pending = (variables, epoch)
            # the worker clears _publish_thread under this lock with
            # nothing pending before it exits: a live handle drains this
            if self._publish_thread is not None:
                return
            self._publish_thread = threading.Thread(
                target=self._publish_worker, name=f"publish-{self.job_id}",
                daemon=True)
            self._publish_thread.start()

    def _publish_worker(self) -> None:
        from ..native.weights import PublishState, publish_variables
        from .dataplane import WeightsWire

        while True:
            with self._lock:
                item = self._publish_pending
                self._publish_pending = None
                if item is None:
                    self._publish_thread = None
                    return
            variables, epoch = item
            try:
                store = self._tensor_store
                if store is not None:  # None once shutdown detached it
                    if self._publish_state is None:
                        self._publish_state = PublishState()
                    publish_variables(store, variables, epoch + 1,
                                      state=self._publish_state)
                wire = self._weights_wire
                if wire is None:
                    wire = self._weights_wire = WeightsWire()
                wire.publish(variables, epoch + 1)
            except Exception:
                log.exception("%s: weight publish failed (non-fatal)",
                              self.job_id)

    def _join_publisher(self, timeout: float = 60.0) -> None:
        with self._lock:
            thread = self._publish_thread
            self._publish_pending = None
        if thread is not None and thread.is_alive():
            thread.join(timeout=timeout)

    def _weights(self, req):
        from ..api.errors import KubeMLError
        from ..utils.httpd import Response
        from . import dataplane

        wire = self._weights_wire
        if wire is None:
            raise KubeMLError(
                f"job {self.job_id} has published no weights yet", 404)
        since = req.arg("since")
        try:
            since = int(since) if since is not None else None
        except ValueError:
            raise KubeMLError(f"invalid since={since!r}", 400)
        got = wire.get(since)
        if got is None:
            raise KubeMLError(
                f"job {self.job_id} has published no weights yet", 404)
        payload, version = got
        headers = {dataplane.VERSION_HEADER: str(version)}
        if payload == "current":
            return Response(b"", status=204, headers=headers,
                            content_type=dataplane.CONTENT_TYPE)
        return Response(payload, content_type=dataplane.CONTENT_TYPE,
                        headers=headers)

    # --- routes ---

    def _start(self, req):
        from ..api.errors import KubeMLError
        from ..api.types import TrainTask
        from ..functions.registry import FunctionRegistry
        from ..storage.checkpoint import CheckpointStore
        from ..storage.history import HistoryStore
        from ..storage.store import ShardStore
        from . import job_class_for
        from .job import TrainJob

        with self._lock:
            if self.job is not None:
                raise KubeMLError(f"job {self.job_id} already started", 400)
            task = TrainTask.parse_request(req.json() or {})
            request = task.parameters
            model = FunctionRegistry(config=self.cfg).load(
                request.function_name)
            model._set_params(lr=request.lr, batch_size=request.batch_size,
                              epoch=0, k=request.options.k, task="train")
            request.options.default_parallelism = (
                task.state.parallelism or request.options.default_parallelism)
            job_cls = job_class_for(request.options)
            extra = {}
            if job_cls is TrainJob:
                if self.cfg.tensor_sockets:
                    self._start_tensor_server()
                # the wire serves the weights even without the socket
                extra["on_epoch_weights"] = self._publish_weights
            self.job = job_cls(
                self.job_id, request, model,
                store=ShardStore(config=self.cfg),
                history_store=HistoryStore(config=self.cfg),
                checkpoint_store=CheckpointStore(config=self.cfg),
                on_epoch_end=self._epoch_end,
                on_metrics=self._push_metrics,
                device=self.device,
                **extra,
            )
            self.thread = threading.Thread(target=self._run,
                                           name=f"job-{self.job_id}",
                                           daemon=True)
            self.status = "running"
            self.thread.start()
        return {}

    def _run(self) -> None:
        # a step wedged in user code would hold the card while the PS frees
        # the slot: the runner ends itself instead (exit 74), the card is
        # released with the process and the PS's monitor fails the job
        from ..utils.watchdog import arm_stall_watchdog

        self.job.heartbeat = time.time()
        guard = arm_stall_watchdog(
            self.job, self.cfg.function_timeout,
            f"standalone job {self.job_id}",
            recovery=("the card is released with the process, the PS marks "
                      "the job FAILED and frees the slot; it is NOT "
                      "resumed"))
        try:
            self.job.train()
            if getattr(self.job, "preempted", False):
                self.status = "preempted"
            else:
                self.status = ("stopped" if self.job.stop_event.is_set()
                               else "finished")
        except Exception as e:
            self.status = "failed"
            self.exit_error = str(e)
            log.error("job %s failed: %s", self.job_id, e)
        finally:
            guard.set()
            self._notify_ps_finished()
            self.done.set()

    def _update(self, req):
        body = req.json() or {}
        with self._lock:
            box = self._update_box
        if box is None:
            log.warning("job %s: update with no pending epoch-end request",
                        self.job_id)
            return {}
        box[1] = int(body["parallelism"])
        box[0].set()
        return {}

    def request_stop(self) -> None:
        """Cooperative stop: flag the job and release a pending epoch-end
        wait (the /stop route and SIGTERM)."""
        if self.job is not None:
            self.job.stop()
        with self._lock:
            if self._update_box is not None:
                self._update_box[0].set()

    def _stop(self, req):
        from ..api.errors import JobNotFoundError

        if self.job is None:
            raise JobNotFoundError(self.job_id)
        self.request_stop()
        return {}

    def _preempt(self, req):
        """Checkpoint-and-yield: the job leaves at its next round edge with
        a resume checkpoint and the ``preempted`` status. Idempotent."""
        from ..api.errors import JobNotFoundError

        if self.job is None:
            raise JobNotFoundError(self.job_id)
        self.job.preempt()
        with self._lock:
            if self._update_box is not None:
                self._update_box[0].set()
        return {"status": "preempting"}

    def _infer(self, req):
        import numpy as np

        from ..api.errors import KubeMLError
        from ..ps.parameter_server import json_batch

        if self.job is None:
            raise KubeMLError(f"job {self.job_id} not started", 503)
        body = req.json() or {}
        return {"predictions": np.asarray(
            self.job.infer(json_batch(body["data"]))).tolist()}

    def _generate(self, req):
        from ..api.errors import KubeMLError
        from ..api.types import GenerateRequest

        if self.job is None:
            raise KubeMLError(f"job {self.job_id} not started", 503)
        if not hasattr(self.job, "generate"):
            raise KubeMLError(
                f"job {self.job_id}'s engine does not serve generation", 400)
        return self.job.generate(
            GenerateRequest.parse_request(req.json() or {}))

    def _state(self, req):
        epochs = (len(self.job.history.train_loss) if self.job is not None
                  else 0)
        return {"job_id": self.job_id, "status": self.status,
                "epochs": epochs, "error": self.exit_error}

    # --- control-plane callbacks ---

    def _epoch_end(self, state) -> int:
        """Ask the scheduler (``/job``); its answer arrives on ``/update``
        through the PS. A dead scheduler keeps the parallelism."""
        from ..api.types import TrainTask
        from ..utils import http_client

        box = [threading.Event(), 0]
        with self._lock:
            self._update_box = box
        task = TrainTask(job_id=self.job_id, parameters=self.job.request,
                         state=state)
        try:
            http_client.post(f"{self.cfg.scheduler_url}/job",
                             json=task.to_dict(),
                             timeout=http_client.timeouts(10),
                             idempotency_key=True)
        except http_client.TransportError as e:
            log.warning("job %s: scheduler unreachable (%s); keeping "
                        "parallelism", self.job_id, e)
            return state.parallelism
        try:
            if not box[0].wait(self.cfg.update_timeout):
                log.warning(
                    "job %s: scheduler at %s answered no parallelism update "
                    "within %.0fs (KUBEML_UPDATE_TIMEOUT); keeping "
                    "parallelism", self.job_id, self.cfg.scheduler_url,
                    self.cfg.update_timeout)
                return state.parallelism
            if self.job.stop_event.is_set():
                return state.parallelism
            return box[1] or state.parallelism
        finally:
            with self._lock:
                if self._update_box is box:
                    self._update_box = None  # late answers warn

    def _push_metrics(self, update) -> None:
        from ..utils import http_client, profiler

        snap = profiler.counters_snapshot()["dataplane"]
        phases = {}
        for phase, agg in snap.items():
            prev = self._dp_cut.get(phase, {})
            delta = {k: max(agg[k] - prev.get(k, 0), 0)
                     for k in ("bytes", "seconds", "events")}
            if any(delta.values()):
                phases[phase] = delta
        if phases:
            self._dp_seq += 1
            self._dp_unacked.append({"seq": self._dp_seq, "phases": phases})
            del self._dp_unacked[:-64]  # the PS gone 64 epochs: shed oldest
            self._dp_cut = {p: dict(a) for p, a in snap.items()}
        update.dataplane = list(self._dp_unacked)
        try:
            r = http_client.post(f"{self.cfg.ps_url}/metrics/{self.job_id}",
                                 json=update.to_dict(),
                                 timeout=http_client.timeouts(5),
                                 idempotency_key=True)
        except http_client.TransportError:
            log.debug("job %s: metrics push failed (PS down?)", self.job_id)
        else:
            if r.status_code < 300:  # only a 2xx acknowledges the batches
                self._dp_unacked.clear()

    def _notify_ps_finished(self) -> None:
        from ..utils import http_client

        # keyed: the PS drops the record at the first delivery, so a
        # retried callback must replay, not 404
        try:
            http_client.post(
                f"{self.cfg.ps_url}/finish/{self.job_id}",
                json={"error": self.exit_error, "status": self.status},
                timeout=http_client.timeouts(10), idempotency_key=True)
        except http_client.TransportError as e:
            log.warning("job %s: PS finish notification failed: %s",
                        self.job_id, e)

    # --- lifecycle ---

    def start(self) -> "JobRunner":
        self.service.start()
        return self

    def stop(self) -> None:
        self.service.stop()
        # the publish worker writes into the store: detach it first (the
        # worker checks), quiesce the training thread (which enqueues
        # publishes), then the worker, and only then free the store
        store, self._tensor_store = self._tensor_store, None
        if self.thread is not None and self.thread.is_alive():
            if self.job is not None:
                self.job.stop()
            self.thread.join(timeout=60.0)
        self._join_publisher()
        if self._tensor_server is not None:
            self._tensor_server.stop()
            self._tensor_server = None
        if store is not None:
            store.close()
        try:
            self.cfg.job_socket_path(self.job_id).unlink(missing_ok=True)
        except OSError:
            pass

    @property
    def url(self) -> str:
        return self.service.url


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="kubeml-tpu-torch standalone job runner")
    parser.add_argument("--job-id", required=True)
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--device", default=None,
                        help="torch device of the job (default: the card)")
    parser.add_argument("--linger", type=float, default=5.0,
                        help="seconds to keep serving after the job finishes")
    args = parser.parse_args(argv)
    fmt = f"%(asctime)s job-{args.job_id} %(name)s %(levelname)s %(message)s"
    logging.basicConfig(level=logging.INFO, format=fmt)
    from ..api.config import get_config

    cfg = get_config()
    # the per-job log (the reference's `kubectl logs job-<id>`,
    # cmd/log.go:28-66): `kubeml logs --id` reads it
    try:
        cfg.logs_dir.mkdir(parents=True, exist_ok=True)
        handler = logging.FileHandler(cfg.logs_dir / f"job-{args.job_id}.log")
        handler.setFormatter(logging.Formatter(fmt))
        logging.getLogger().addHandler(handler)
    except OSError as e:
        log.warning("per-job log file unavailable: %s", e)
    try:
        runner = JobRunner(args.job_id, port=args.port,
                           device=args.device).start()
    except RuntimeError as e:  # no card for a CUDA runner
        log.error("job runner %s cannot start: %s", args.job_id, e)
        print(f"ERROR {e}", flush=True)
        return 1
    # the parent reads this line for the bound port
    print(f"LISTENING {runner.service.port}", flush=True)

    # SIGTERM (cluster shutdown): a cooperative stop; the job thread ends
    # its round, flushes its history and sets `done`; a runner that never
    # got /start exits at once
    def _on_term(*_):
        if runner.job is not None:
            runner.request_stop()
        else:
            runner.done.set()

    signal.signal(signal.SIGTERM, _on_term)
    try:
        # serve until the job ends, then linger for late /state reads
        runner.done.wait()
        time.sleep(args.linger)
    except KeyboardInterrupt:
        if runner.job is not None:
            runner.job.stop()
    finally:
        runner.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())

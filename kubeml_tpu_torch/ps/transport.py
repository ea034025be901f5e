"""The parameter server's HTTP surface and its client: the port of
``kubeml_tpu/ps/transport.py``.

Routes: ``/start``, ``/update/{jobId}``, ``/infer``, ``/stop/{jobId}``,
``/preempt/{jobId}``, ``/jobs``, ``/tasks``, ``/metrics`` (the Prometheus
exposition), ``/metrics/{jobId}`` and ``/finish/{jobId}`` (a standalone
runner's pushes), ``POST``/``GET /traces/{taskId}`` (the span collector,
``ps/traces.py``: a runner or a follower posts its spans, the controller
reads the merged trace), ``/serving/drain``, ``/serving/restored`` and
``/health``. ``/metrics/history`` and ``/slo`` answer a 400 that names
their module (``utils/timeseries.py``, ``ps/slo.py``: not ported).

:meth:`PSAPI.start` on the main thread takes SIGTERM: drain the serving
decoders (their stragglers become KMS1 frames in ``snap_dir``), then the
previous handler, or exit 0 (:meth:`PSAPI.stop` puts the previous
handler back). With ``snap_dir`` set it replays the frames a predecessor
left there (``ParameterServer.restore_serving``).
"""

from __future__ import annotations

import logging
import signal
from typing import Optional

from ..api.config import Config, get_config
from ..api.errors import KubeMLError
from ..api.types import MetricUpdate, TrainTask, parse_grace_seconds
from ..utils import http_client as http
from ..utils.httpd import Request, Response, Router, Service
from .parameter_server import ParameterServer

log = logging.getLogger("kubeml.ps")


def unported_route(what: str, module: str):
    """A handler that answers 400 naming the modules a route waits for
    (the time-series store and the SLOs, the next slice of the port)."""
    def handler(req: Request):
        raise KubeMLError(f"{what} ({module}) is not ported to "
                          f"kubeml_tpu_torch yet (ROADMAP.md Queue 1 item "
                          f"2b)", 400)
    return handler


class PSAPI:
    def __init__(self, ps: ParameterServer, config: Optional[Config] = None):
        self.cfg = config or get_config()
        self.ps = ps
        router = Router("ps")
        router.route("POST", "/start", self._start)
        router.route("POST", "/update/{jobId}", self._update)
        router.route("POST", "/infer", self._infer)
        router.route("DELETE", "/stop/{jobId}", self._stop)
        router.route("POST", "/preempt/{jobId}", self._preempt)
        router.route("GET", "/jobs", self._jobs)
        router.route("GET", "/tasks", self._tasks)
        router.route("GET", "/metrics", self._metrics)
        router.route("GET", "/metrics/history", unported_route(
            "the sampled metrics history", "utils/timeseries.py"))
        router.route("GET", "/slo", unported_route(
            "SLO status", "ps/slo.py, utils/timeseries.py"))
        router.route("POST", "/metrics/{jobId}", self._metrics_update)
        router.route("POST", "/finish/{jobId}", self._finish)
        router.route("POST", "/traces/{taskId}", self._traces_post)
        router.route("GET", "/traces/{taskId}", self._traces_get)
        router.route("POST", "/serving/drain", self._serving_drain)
        router.route("GET", "/serving/restored", self._serving_restored)
        self.service = Service(router, self.cfg.host, self.cfg.ps_port)
        # (our SIGTERM handler, the one it replaced) while installed
        self._sigterm = None

    def _start(self, req: Request):
        self.ps.start_task(TrainTask.parse_request(req.json() or {}))
        return {}

    def _update(self, req: Request):
        body = req.json() or {}
        self.ps.update_task(req.params["jobId"], int(body["parallelism"]))
        return {}

    def _infer(self, req: Request):
        body = req.json() or {}
        return {"predictions": self.ps.infer(body["model_id"], body["data"])}

    def _stop(self, req: Request):
        self.ps.stop_task(req.params["jobId"])
        return {}

    def _preempt(self, req: Request):
        body = req.json() or {}
        self.ps.preempt_task(req.params["jobId"],
                             reason=str(body.get("reason") or "operator"),
                             grace=parse_grace_seconds(body.get("grace")))
        return {"status": "preempting"}

    def _jobs(self, req: Request):
        return self.ps.jobs_snapshot(
            include_journal=req.arg("journal", "1") != "0")

    def _tasks(self, req: Request):
        return [t.to_dict() for t in self.ps.list_tasks()]

    def _metrics(self, req: Request):
        return Response(self.ps.metrics.render().encode(),
                        content_type="text/plain; version=0.0.4")

    def _metrics_update(self, req: Request):
        update = MetricUpdate.parse_request(req.json() or {})
        update.job_id = req.params["jobId"]
        self.ps.metrics.update(update)
        return {}

    def _finish(self, req: Request):
        body = req.json() or {}
        self.ps.finish_standalone(req.params["jobId"],
                                  status=body.get("status", ""),
                                  error=body.get("error"))
        return {}

    def _traces_post(self, req: Request):
        body = req.json() or {}
        spans = body.get("spans")
        if not isinstance(spans, list):
            raise KubeMLError("trace payload must be {spans: [...]}", 400)
        counters = body.get("counters")
        self.ps.post_trace(
            req.params["taskId"], spans,
            counters=counters if isinstance(counters, dict) else None,
            service=str(body.get("service") or ""))
        return {"accepted": len(spans)}

    def _traces_get(self, req: Request):
        return self.ps.get_trace(req.params["taskId"])

    def _serving_drain(self, req: Request):
        body = req.json() or {}
        return self.ps.drain_serving(grace=parse_grace_seconds(
            body.get("grace")))

    def _serving_restored(self, req: Request):
        return self.ps.restored_snapshot()

    def start(self) -> "PSAPI":
        self.service.start()

        def _on_term(signum, frame):
            try:
                self.ps.drain_serving()
            except Exception:
                log.exception("the SIGTERM drain failed")
            if callable(prev):
                prev(signum, frame)
            else:
                raise SystemExit(0)

        try:
            prev = signal.signal(signal.SIGTERM, _on_term)
            self._sigterm = (_on_term, prev)
        except ValueError:
            pass  # not the main thread: an embedded server takes no signal
        if self.cfg.snap_dir:
            self.ps.restore_serving()
        return self

    def stop(self) -> None:
        self.service.stop()
        if self._sigterm is not None:
            ours, prev = self._sigterm
            self._sigterm = None
            try:
                if signal.getsignal(signal.SIGTERM) is ours:
                    signal.signal(signal.SIGTERM, prev)
            except ValueError:
                pass

    @property
    def url(self) -> str:
        return self.service.url


class PSClient:
    """A remote PS with the method surface the scheduler and controller
    use; the non-idempotent POSTs carry idempotency keys."""

    def __init__(self, url: str, timeout: float = 60.0):
        self.url = url.rstrip("/")
        self.timeout = timeout

    def _timeout(self, read=None) -> tuple:
        return http.timeouts(read if read is not None else self.timeout)

    def start_task(self, task: TrainTask) -> None:
        http.check(http.post(f"{self.url}/start", json=task.to_dict(),
                             timeout=self._timeout(), idempotency_key=True))

    def update_task(self, job_id: str, parallelism: int) -> None:
        http.check(http.post(f"{self.url}/update/{job_id}",
                             json={"parallelism": parallelism},
                             timeout=self._timeout(), idempotency_key=True))

    def infer(self, model_id: str, data):
        return http.check(http.post(
            f"{self.url}/infer", json={"model_id": model_id, "data": data},
            timeout=self._timeout(), retryable=True))["predictions"]

    def stop_task(self, job_id: str) -> None:
        http.check(http.delete(f"{self.url}/stop/{job_id}",
                               timeout=self._timeout()))

    def preempt_task(self, job_id: str, reason: str = "operator",
                     grace: Optional[float] = None) -> None:
        body: dict = {"reason": reason}
        if grace is not None:
            body["grace"] = grace
        http.check(http.post(f"{self.url}/preempt/{job_id}", json=body,
                             timeout=self._timeout(), idempotency_key=True))

    def jobs_snapshot(self, include_journal: bool = True) -> list:
        suffix = "" if include_journal else "?journal=0"
        return http.check(http.get(f"{self.url}/jobs{suffix}",
                                   timeout=self._timeout()))

    def list_tasks(self):
        return [TrainTask.from_dict(d) for d in http.check(
            http.get(f"{self.url}/tasks", timeout=self._timeout()))]

    def metrics_text(self) -> str:
        return http.get(f"{self.url}/metrics", timeout=self._timeout()).text

    def post_trace(self, task_id: str, spans: list,
                   counters: Optional[dict] = None,
                   service: str = "") -> None:
        payload: dict = {"spans": spans}
        if counters:
            payload["counters"] = counters
            payload["service"] = service or "worker"
        http.check(http.post(f"{self.url}/traces/{task_id}", json=payload,
                             timeout=self._timeout(), idempotency_key=True))

    def get_trace(self, task_id: str) -> dict:
        return http.check(http.get(f"{self.url}/traces/{task_id}",
                                   timeout=self._timeout()))

    def drain_serving(self, grace: Optional[float] = None) -> dict:
        body: dict = {}
        if grace is not None:
            body["grace"] = grace
        return http.check(http.post(
            f"{self.url}/serving/drain", json=body,
            timeout=self._timeout(max(120.0, self.timeout)),
            idempotency_key=True))

    def serving_restored(self) -> list:
        return http.check(http.get(f"{self.url}/serving/restored",
                                   timeout=self._timeout()))

    def health(self) -> bool:
        try:
            return http.get(f"{self.url}/health",
                            timeout=self._timeout(5)).status_code == 200
        except http.TransportError:
            return False

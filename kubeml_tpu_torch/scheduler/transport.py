"""The scheduler's HTTP surface and its client: the port of
``kubeml_tpu/scheduler/transport.py``.

Routes: ``/train``, ``/infer``, ``/generate``, ``/job``, ``/preempted``,
``/jobs``, ``/jobs/{jobId}/decisions``, ``/finish/{taskId}`` and
``/health``. :class:`SchedulerClient` has the :class:`Scheduler` method
surface, so the PS and the controller talk to a scheduler in process or
over HTTP alike.
"""

from __future__ import annotations

from typing import Optional

from ..api.config import Config, get_config
from ..api.types import (GenerateRequest, InferRequest, TrainRequest,
                         TrainTask, generate_timeout)
from ..utils import http_client as http
from ..utils.httpd import Request, Router, Service, StreamResponse
from .scheduler import Scheduler


class SchedulerAPI:
    def __init__(self, scheduler: Scheduler, config: Optional[Config] = None):
        self.cfg = config or get_config()
        self.scheduler = scheduler
        router = Router("scheduler")
        router.route("POST", "/train", self._train)
        router.route("POST", "/infer", self._infer)
        router.route("POST", "/generate", self._generate)
        router.route("POST", "/job", self._job)
        router.route("POST", "/preempted", self._preempted)
        router.route("GET", "/jobs", self._jobs)
        router.route("GET", "/jobs/{jobId}/decisions", self._job_decisions)
        router.route("DELETE", "/finish/{taskId}", self._finish)
        self.service = Service(router, self.cfg.host, self.cfg.scheduler_port)

    def _train(self, req: Request):
        train_req = TrainRequest.parse_request(req.json() or {})
        return {"id": self.scheduler.submit_train(train_req)}

    def _infer(self, req: Request):
        body = InferRequest.parse_request(req.json() or {})
        return {"predictions": self.scheduler.infer(body.model_id, body.data)}

    def _generate(self, req: Request):
        body = GenerateRequest.parse_request(req.json() or {})
        result = self.scheduler.generate(body)
        if body.stream and not isinstance(result, dict):
            return StreamResponse(result)
        return result

    def _job(self, req: Request):
        self.scheduler.update_job(TrainTask.parse_request(req.json() or {}))
        return {}

    def _preempted(self, req: Request):
        self.scheduler.job_preempted(TrainTask.parse_request(req.json() or {}))
        return {}

    def _jobs(self, req: Request):
        return self.scheduler.jobs_snapshot()

    def _job_decisions(self, req: Request):
        return self.scheduler.job_decisions(req.params["jobId"])

    def _finish(self, req: Request):
        self.scheduler.finish_job(req.params["taskId"])
        return {}

    def start(self) -> "SchedulerAPI":
        self.service.start()
        return self

    def stop(self) -> None:
        self.service.stop()

    @property
    def url(self) -> str:
        return self.service.url


class SchedulerClient:
    """A remote scheduler with the :class:`Scheduler` method surface; the
    non-idempotent POSTs carry idempotency keys."""

    def __init__(self, url: str, timeout: float = 30.0):
        self.url = url.rstrip("/")
        self.timeout = timeout

    def _timeout(self, read: Optional[float] = None) -> tuple:
        return http.timeouts(read if read is not None else self.timeout)

    def submit_train(self, request: TrainRequest) -> str:
        return http.check(http.post(
            f"{self.url}/train", json=request.to_dict(),
            timeout=self._timeout(), idempotency_key=True))["id"]

    def infer(self, model_id: str, data):
        return http.check(http.post(
            f"{self.url}/infer",
            json=InferRequest(model_id=model_id, data=data).to_dict(),
            timeout=self._timeout(), retryable=True))["predictions"]

    def generate(self, req: GenerateRequest):
        timeout = self._timeout(generate_timeout(
            req, floor=max(self.timeout, 120)))
        r = http.post(f"{self.url}/generate", json=req.to_dict(),
                      timeout=timeout, stream=req.stream, retryable=True)
        return http.ndjson(r) if req.stream else http.check(r)

    def update_job(self, task: TrainTask) -> None:
        http.check(http.post(f"{self.url}/job", json=task.to_dict(),
                             timeout=self._timeout(), idempotency_key=True))

    def job_preempted(self, task: TrainTask) -> None:
        http.check(http.post(f"{self.url}/preempted", json=task.to_dict(),
                             timeout=self._timeout(), idempotency_key=True))

    def jobs_snapshot(self) -> list:
        return http.check(http.get(f"{self.url}/jobs",
                                   timeout=self._timeout()))

    def job_decisions(self, job_id: str) -> dict:
        return http.check(http.get(f"{self.url}/jobs/{job_id}/decisions",
                                   timeout=self._timeout()))

    def finish_job(self, job_id: str) -> None:
        http.check(http.delete(f"{self.url}/finish/{job_id}",
                               timeout=self._timeout()))

    def health(self) -> bool:
        try:
            return http.get(f"{self.url}/health",
                            timeout=self._timeout(5)).status_code == 200
        except http.TransportError:
            return False

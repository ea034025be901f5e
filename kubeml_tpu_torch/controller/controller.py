"""The controller, the REST gateway users and the CLI talk to: the port
of ``kubeml_tpu/controller/controller.py``.

Routes: ``/train``, ``/infer``, ``/generate`` (one-shot or a chunked
ndjson stream), ``/dataset[/{name}[/tokenizer]]``, ``/tasks[/{id}]``,
``/tasks/{id}/preempt``, ``/tasks/{id}/trace``, ``/jobs``,
``/jobs/{id}/decisions``,
``/history[/{id}]``, ``/checkpoint[/{id}[/export|/quantize]]``,
``/function[/{name}]`` and ``/health``. ``/train`` checks that the
dataset and the function exist (404 otherwise) before it queues.
``/checkpoint/{id}/quantize`` writes the ``final-int8`` export
(``serving.quant.quantize_final_checkpoint``). The checkpoint routes
list, export and delete the sharded checkpoints of the SPMD engine
(``storage.sharded_checkpoint``) beside the flat ones; exporting a
sharded one writes it through the flat store once, assembled on the
host.

``/tasks/{id}/trace`` is the task's merged trace: the spans of every
process that touched it, collected at the parameter server (a 404 when
none was recorded: the cluster traces only with ``KUBEML_TRACE`` set).
``/slo`` and ``/metrics/history`` answer a 400 that names their modules
(``ROADMAP.md`` Queue 1 item 2b).
"""

from __future__ import annotations

from typing import Optional

from ..api.config import Config, get_config
from ..api.errors import CheckpointNotFoundError, KubeMLError
from ..api.types import (GenerateRequest, InferRequest, TrainRequest,
                         parse_grace_seconds)
from ..functions.registry import FunctionRegistry
from ..ps.transport import unported_route
from ..storage.checkpoint import FINAL_TAG, CheckpointStore
from ..storage.history import HistoryStore
from ..storage.sharded_checkpoint import ShardedCheckpointStore
from ..storage.service import create_dataset_from_upload, parse_multipart
from ..storage.store import ShardStore
from ..utils.httpd import Request, Response, Router, Service, StreamResponse


class Controller:
    def __init__(self, scheduler, ps, store: Optional[ShardStore] = None,
                 history_store: Optional[HistoryStore] = None,
                 registry: Optional[FunctionRegistry] = None,
                 config: Optional[Config] = None):
        self.cfg = config or get_config()
        self.scheduler = scheduler
        self.ps = ps
        self.store = store or ShardStore(config=self.cfg)
        self.history_store = history_store or HistoryStore(config=self.cfg)
        self.registry = registry or FunctionRegistry(config=self.cfg)
        self.checkpoints = CheckpointStore(config=self.cfg)

        router = Router("controller")
        router.route("POST", "/train", self._train)
        router.route("POST", "/infer", self._infer)
        router.route("POST", "/generate", self._generate)
        router.route("GET", "/dataset", self._dataset_list)
        router.route("GET", "/dataset/{name}", self._dataset_get)
        router.route("GET", "/dataset/{name}/tokenizer",
                     self._dataset_tokenizer)
        router.route("POST", "/dataset/{name}", self._dataset_create)
        router.route("DELETE", "/dataset/{name}", self._dataset_delete)
        router.route("GET", "/tasks", self._tasks)
        router.route("GET", "/jobs", self._jobs)
        router.route("GET", "/jobs/{id}/decisions", self._job_decisions)
        router.route("DELETE", "/tasks", self._task_prune)
        router.route("DELETE", "/tasks/{id}", self._task_stop)
        router.route("POST", "/tasks/{id}/preempt", self._task_preempt)
        router.route("GET", "/tasks/{id}/trace", self._task_trace)
        router.route("GET", "/slo", unported_route(
            "SLO status", "ps/slo.py, utils/timeseries.py"))
        router.route("GET", "/metrics/history", unported_route(
            "the sampled metrics history", "utils/timeseries.py"))
        router.route("GET", "/history", self._history_list)
        router.route("GET", "/history/{id}", self._history_get)
        router.route("DELETE", "/history/{id}", self._history_delete)
        router.route("DELETE", "/history", self._history_prune)
        router.route("GET", "/checkpoint", self._ckpt_list_all)
        router.route("GET", "/checkpoint/{id}", self._ckpt_list)
        router.route("GET", "/checkpoint/{id}/export", self._ckpt_export)
        router.route("POST", "/checkpoint/{id}/quantize", self._ckpt_quantize)
        router.route("DELETE", "/checkpoint/{id}", self._ckpt_delete)
        router.route("GET", "/function", self._fn_list)
        router.route("GET", "/function/{name}", self._fn_get)
        router.route("POST", "/function/{name}", self._fn_create)
        router.route("DELETE", "/function/{name}", self._fn_delete)
        self.service = Service(router, self.cfg.host,
                               self.cfg.controller_port)

    # --- train / infer / generate ---

    def _train(self, req: Request):
        train_req = TrainRequest.parse_request(req.json() or {})
        if not self.store.exists(train_req.dataset):
            raise KubeMLError(f"dataset {train_req.dataset!r} not found", 404)
        if not self.registry.exists(train_req.function_name):
            raise KubeMLError(
                f"function {train_req.function_name!r} not found", 404)
        return {"id": self.scheduler.submit_train(train_req)}

    def _infer(self, req: Request):
        body = InferRequest.parse_request(req.json() or {})
        return {"predictions": self.scheduler.infer(body.model_id,
                                                    body.data)}

    def _generate(self, req: Request):
        body = GenerateRequest.parse_request(req.json() or {})
        result = self.scheduler.generate(body)
        if body.stream and not isinstance(result, dict):
            return StreamResponse(result)
        return result

    # --- datasets ---

    def _dataset_list(self, req: Request):
        return [s.to_dict() for s in self.store.list()]

    def _dataset_get(self, req: Request):
        return self.store.get(req.params["name"]).summary().to_dict()

    def _dataset_tokenizer(self, req: Request):
        handle = self.store.get(req.params["name"])
        asset = handle.manifest.get("meta", {}).get("tokenizer")
        if asset is None:
            raise KubeMLError(
                f"dataset {req.params['name']!r} has no tokenizer asset "
                f"(byte-level)", 404)
        return asset

    def _dataset_create(self, req: Request):
        files = parse_multipart(req.body,
                                req.headers.get("Content-Type", ""))
        return create_dataset_from_upload(self.store, req.params["name"],
                                          files)

    def _dataset_delete(self, req: Request):
        self.store.delete(req.params["name"])
        return {"deleted": req.params["name"]}

    # --- tasks and jobs ---

    def _tasks(self, req: Request):
        return [t.to_dict() for t in self.ps.list_tasks()]

    def _jobs(self, req: Request):
        """Queued (in pop order), then running and journaled jobs; a job
        both queued and journaled shows as queued."""
        queued = self.scheduler.jobs_snapshot()
        seen = {j["job_id"] for j in queued}
        return queued + [j for j in self.ps.jobs_snapshot()
                         if j["job_id"] not in seen]

    def _job_decisions(self, req: Request):
        return self.scheduler.job_decisions(req.params["id"])

    def _task_stop(self, req: Request):
        self.ps.stop_task(req.params["id"])
        return {}

    def _task_preempt(self, req: Request):
        body = req.json() or {}
        self.ps.preempt_task(req.params["id"],
                             reason=str(body.get("reason") or "operator"),
                             grace=parse_grace_seconds(body.get("grace")))
        return {"status": "preempting"}

    def _task_trace(self, req: Request):
        """The task's merged trace; ``kubeml trace`` writes it as one
        Chrome/Perfetto file."""
        trace = self.ps.get_trace(req.params["id"])
        if not trace.get("spans"):
            raise KubeMLError(
                f"no trace recorded for task {req.params['id']!r} "
                f"(is KUBEML_TRACE set on the cluster?)", 404)
        return trace

    def _task_prune(self, req: Request):
        return {"pruned": self.ps.prune_tasks()}

    # --- history ---

    def _history_list(self, req: Request):
        return [h.to_dict() for h in self.history_store.list()]

    def _history_get(self, req: Request):
        return self.history_store.get(req.params["id"]).to_dict()

    def _history_delete(self, req: Request):
        self.history_store.delete(req.params["id"])
        return {}

    def _history_prune(self, req: Request):
        return {"pruned": self.history_store.prune()}

    # --- checkpoints ---

    @property
    def _sharded_checkpoints(self) -> ShardedCheckpointStore:
        return ShardedCheckpointStore(root=self.checkpoints.root)

    def _ckpt_list_all(self, req: Request):
        out = {j: self.checkpoints.tags(j)
               for j in self.checkpoints.list_jobs()}
        sharded = self._sharded_checkpoints
        for j in sharded.list_jobs():
            tags = out.setdefault(j, [])
            tags.extend(t for t in sharded.tags(j) if t not in tags)
        return out

    def _ckpt_list(self, req: Request):
        job = req.params["id"]
        tags = self.checkpoints.tags(job)
        tags.extend(t for t in self._sharded_checkpoints.tags(job)
                    if t not in tags)
        return {"job": job, "checkpoints": tags}

    def _ckpt_export(self, req: Request):
        epoch_s = req.arg("epoch")
        epoch = None
        if epoch_s:
            try:
                epoch = int(epoch_s)
            except ValueError:
                raise KubeMLError(f"invalid epoch {epoch_s!r}", 400)
        job, tag = req.params["id"], req.arg("tag")
        try:
            path = self.checkpoints.export_path(job, epoch=epoch, tag=tag)
        except CheckpointNotFoundError:
            path = self._materialize_sharded_export(job, epoch, tag)
        return Response(path.read_bytes(),
                        content_type="application/octet-stream")

    def _materialize_sharded_export(self, job: str, epoch, tag):
        """The flat file of a sharded checkpoint (JAX :255): the tree
        assembled on the host and written through the flat store once, so
        the download route serves jobs that only wrote sharded ones."""
        store = self._sharded_checkpoints
        if tag is None:
            if epoch is not None:
                tag = f"ep{epoch:05d}"
            else:
                tags = store.tags(job)
                tag = (FINAL_TAG if FINAL_TAG in tags
                       else (tags[-1] if tags else None))
        if tag is None or not store.exists(job, tag):
            raise CheckpointNotFoundError(job)
        ck = store.restore(job, tag)
        self.checkpoints.save(job, ck.variables, epoch=ck.epoch, tag=ck.tag,
                              meta=ck.meta)
        return self.checkpoints.export_path(job, tag=ck.tag)

    def _ckpt_quantize(self, req: Request):
        from ..serving.quant import INT8_TAG, quantize_final_checkpoint

        job = req.params["id"]
        try:
            form = quantize_final_checkpoint(
                job, self.checkpoints, registry=self.registry,
                sharded_store=self._sharded_checkpoints)
        except CheckpointNotFoundError:
            raise KubeMLError(f"job {job!r} has no final checkpoint", 404)
        return {"job": job, "tag": INT8_TAG, "form": form}

    def _ckpt_delete(self, req: Request):
        job, tag = req.params["id"], req.arg("tag")
        deleted = False
        try:
            self.checkpoints.delete(job, tag=tag)
            deleted = True
        except CheckpointNotFoundError:
            pass
        sharded = self._sharded_checkpoints
        for t in ([tag] if tag is not None else sharded.tags(job)):
            if sharded.exists(job, t):
                sharded.delete(job, t)
                deleted = True
        if not deleted:
            raise CheckpointNotFoundError(job)
        return {"deleted": job}

    # --- functions ---

    def _fn_list(self, req: Request):
        return [f.to_dict() for f in self.registry.list()]

    def _fn_get(self, req: Request):
        return self.registry.summary(req.params["name"]).to_dict()

    def _fn_create(self, req: Request):
        if not req.body:
            raise KubeMLError("empty function source", 400)
        return self.registry.create(req.params["name"],
                                    req.body.decode()).to_dict()

    def _fn_delete(self, req: Request):
        self.registry.delete(req.params["name"])
        return {"deleted": req.params["name"]}

    # --- lifecycle ---

    def start(self) -> "Controller":
        self.service.start()
        return self

    def stop(self) -> None:
        self.service.stop()

    @property
    def url(self) -> str:
        return self.service.url

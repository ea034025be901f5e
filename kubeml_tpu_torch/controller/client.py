"""``KubemlClient``, the Python SDK against the controller: the port of
``kubeml_tpu/controller/client.py`` on the standard library's HTTP
(``utils.http_client``).

``client.networks().train/infer/generate``, ``client.datasets()
.create/create_text/tokenizer/get/list/delete`` (a multipart upload of
four ``.npy`` files, or of a text corpus),
``client.tasks().list/stop/preempt/prune/jobs/decisions``,
``client.histories().get/delete/list/prune``, ``client.functions()`` and
``client.checkpoints().list/list_jobs/export/quantize/delete``. A 4xx or
5xx raises the typed ``KubeMLError`` of its envelope.
"""

from __future__ import annotations

import io
import json
import os
from pathlib import Path
from typing import Any, List, Optional, Union

import numpy as np

from ..api.errors import KubeMLError, error_from_envelope
from ..api.types import (DatasetSummary, GenerateRequest, History,
                         InferRequest, TrainRequest, TrainTask,
                         generate_timeout)
from ..utils import http_client as http


def _to_npy_bytes(a: Union[np.ndarray, str, Path, bytes]) -> bytes:
    """An array, a .npy file path, or raw bytes, as .npy bytes."""
    if isinstance(a, bytes):
        return a
    if isinstance(a, (str, Path)):
        return Path(a).read_bytes()
    buf = io.BytesIO()
    np.save(buf, np.asarray(a))
    return buf.getvalue()


class _Part:
    def __init__(self, client: "KubemlClient"):
        self.c = client

    def _t(self, read: Optional[float] = None) -> tuple:
        return http.timeouts(read if read is not None else self.c.timeout)

    def _get(self, path: str, **kw):
        return http.check(http.get(f"{self.c.url}{path}", timeout=self._t(),
                                   **kw))

    def _delete(self, path: str, **kw):
        return http.check(http.delete(f"{self.c.url}{path}",
                                      timeout=self._t(), **kw))


class _Networks(_Part):
    def train(self, request: TrainRequest) -> str:
        return http.check(http.post(
            f"{self.c.url}/train", json=request.to_dict(), timeout=self._t(),
            idempotency_key=True))["id"]

    def infer(self, model_id: str, data: Any) -> list:
        body = InferRequest(model_id=model_id, data=np.asarray(data).tolist())
        return http.check(http.post(f"{self.c.url}/infer",
                                    json=body.to_dict(), timeout=self._t(),
                                    retryable=True))["predictions"]

    def generate(self, model_id: str, prompts: Any, *,
                 max_new_tokens: int = 32, temperature: float = 0.0,
                 top_k=None, eos_id=None, seed=None, prompt_lengths=None,
                 stream: bool = False):
        """``{"tokens": [[...]], "lengths": [...], ...}``; with
        ``stream=True`` an iterator of ``{"row", "tokens"}`` deltas and a
        last ``{"done", "lengths"}`` record (an ``{"error"}`` record
        signals a failure mid-stream)."""
        body = GenerateRequest(
            model_id=model_id, prompts=np.asarray(prompts).tolist(),
            max_new_tokens=max_new_tokens, temperature=temperature,
            top_k=top_k, eos_id=eos_id, seed=seed,
            prompt_lengths=prompt_lengths, stream=stream)
        timeout = self._t(generate_timeout(body,
                                           floor=max(self.c.timeout, 120)))
        r = http.post(f"{self.c.url}/generate", json=body.to_dict(),
                      timeout=timeout, stream=stream, retryable=True)
        return http.ndjson(r) if stream else http.check(r)


class _Datasets(_Part):
    def create(self, name: str, x_train, y_train, x_test,
               y_test) -> DatasetSummary:
        files = {f: (f"{f}.npy", _to_npy_bytes(a)) for f, a in (
            ("x-train", x_train), ("y-train", y_train), ("x-test", x_test),
            ("y-test", y_test))}
        return DatasetSummary.from_dict(http.check(http.post(
            f"{self.c.url}/dataset/{name}", files=files,
            timeout=self._t(max(self.c.timeout, 300)),
            idempotency_key=True)))

    def create_text(self, name: str, corpus: str, *, corpus_test=None,
                    seq_len: int = 512, tokenizer: Optional[dict] = None,
                    train_bpe: Optional[int] = None) -> dict:
        """Upload a text corpus: the server tokenizes it (bytes, a
        vocab-JSON ``tokenizer`` asset, or a BPE of ``train_bpe`` ids
        trained on this corpus inside the request) and packs
        ``[N, seq_len]`` rows. The summary and the packing record."""
        files = {"corpus": ("corpus.txt", corpus.encode("utf-8")),
                 "seq-len": (None, str(seq_len))}
        if corpus_test is not None:
            files["corpus-test"] = ("corpus-test.txt",
                                    corpus_test.encode("utf-8"))
        if tokenizer is not None:
            files["tokenizer"] = ("tokenizer.json",
                                  json.dumps(tokenizer).encode())
        if train_bpe is not None:
            files["train-bpe"] = (None, str(int(train_bpe)))
        return http.check(http.post(
            f"{self.c.url}/dataset/{name}", files=files,
            timeout=self._t(max(self.c.timeout, 300)),
            idempotency_key=True))

    def tokenizer(self, name: str) -> dict:
        """The dataset's tokenizer asset (a 404 for a byte-level one)."""
        return self._get(f"/dataset/{name}/tokenizer")

    def get(self, name: str) -> DatasetSummary:
        return DatasetSummary.from_dict(self._get(f"/dataset/{name}"))

    def list(self) -> List[DatasetSummary]:
        return [DatasetSummary.from_dict(d) for d in self._get("/dataset")]

    def delete(self, name: str) -> None:
        self._delete(f"/dataset/{name}")


class _Tasks(_Part):
    def list(self) -> List[TrainTask]:
        return [TrainTask.from_dict(d) for d in self._get("/tasks")]

    def stop(self, job_id: str) -> None:
        self._delete(f"/tasks/{job_id}")

    def preempt(self, job_id: str, reason: str = "operator",
                grace: Optional[float] = None) -> None:
        """Checkpoint-and-yield: the job writes a resume checkpoint,
        leaves ``preempted`` and is requeued with resume=True."""
        body: dict = {"reason": reason}
        if grace is not None:
            body["grace"] = grace
        http.check(http.post(f"{self.c.url}/tasks/{job_id}/preempt",
                             json=body, timeout=self._t(),
                             idempotency_key=True))

    def jobs(self) -> List[dict]:
        """Queued, running and preempted jobs (``kubeml jobs``)."""
        return self._get("/jobs")

    def decisions(self, job_id: str) -> dict:
        """The job's scale decisions, oldest first, and their ``total``."""
        return self._get(f"/jobs/{job_id}/decisions")

    def prune(self) -> int:
        return self._delete("/tasks")["pruned"]

    def trace(self, job_id: str) -> dict:
        """The task's merged trace: ``{"task_id", "trace_ids", "dropped",
        "spans": [span dicts], "counters": {service: data-plane
        snapshot}}``; ``utils.tracing.merge_chrome_trace`` renders the
        spans, ``utils.profiler.attribution_report`` folds them into the
        ``kubeml profile`` report."""
        return self._get(f"/tasks/{job_id}/trace")


class _Histories(_Part):
    def get(self, job_id: str) -> History:
        return History.from_dict(self._get(f"/history/{job_id}"))

    def list(self) -> List[History]:
        return [History.from_dict(d) for d in self._get("/history")]

    def delete(self, job_id: str) -> None:
        self._delete(f"/history/{job_id}")

    def prune(self) -> int:
        return self._delete("/history")["pruned"]


class _Functions(_Part):
    def create(self, name: str, source: Union[str, Path]) -> dict:
        if isinstance(source, Path) or (isinstance(source, str)
                                        and source.endswith(".py")):
            source = Path(source).read_text()
        return http.check(http.post(
            f"{self.c.url}/function/{name}", data=source.encode(),
            headers={"Content-Type": "text/x-python"}, timeout=self._t(),
            idempotency_key=True))

    def get(self, name: str) -> dict:
        return self._get(f"/function/{name}")

    def list(self) -> List[dict]:
        return self._get("/function")

    def delete(self, name: str) -> None:
        self._delete(f"/function/{name}")


class _Checkpoints(_Part):
    def list(self, job_id: str) -> List[str]:
        """The checkpoint tags of one job."""
        return self._get(f"/checkpoint/{job_id}")["checkpoints"]

    def list_jobs(self) -> dict:
        """Every job with checkpoints -> its tags."""
        return self._get("/checkpoint")

    def export(self, job_id: str, dest: Union[str, Path],
               epoch: Optional[int] = None, tag: Optional[str] = None
               ) -> Path:
        params = {}
        if epoch is not None:
            params["epoch"] = str(epoch)
        if tag is not None:
            params["tag"] = tag
        resp = http.get(f"{self.c.url}/checkpoint/{job_id}/export",
                        params=params, timeout=self._t())
        if resp.status_code >= 400:
            raise error_from_envelope(resp.content, resp.status_code)
        from ..storage.checkpoint import normalize_npz

        dest = normalize_npz(Path(dest))
        dest.parent.mkdir(parents=True, exist_ok=True)
        dest.write_bytes(resp.content)
        return dest

    def quantize(self, job_id: str) -> dict:
        """Write the job's ``final-int8`` export."""
        return http.check(http.post(
            f"{self.c.url}/checkpoint/{job_id}/quantize",
            timeout=self._t(max(self.c.timeout, 600)),
            idempotency_key=True))

    def delete(self, job_id: str, tag: Optional[str] = None) -> None:
        self._delete(f"/checkpoint/{job_id}",
                     params={"tag": tag} if tag else None)


def resolve_controller_url(url: Optional[str] = None) -> str:
    """The controller's URL: ``url``, else ``KUBEML_CONTROLLER_URL``, else
    the config's ``controller_url`` (``KUBEML_HOST`` and
    ``KUBEML_CONTROLLER_PORT``)."""
    if url:
        return url
    env = os.environ.get("KUBEML_CONTROLLER_URL", "").strip()
    if env:
        return env
    from ..api.config import get_config

    cfg_url = get_config().controller_url
    if cfg_url:
        return cfg_url
    raise KubeMLError(
        "cannot resolve the controller URL: pass url= to KubemlClient, set "
        "KUBEML_CONTROLLER_URL, or configure KUBEML_HOST/"
        "KUBEML_CONTROLLER_PORT", 503)


class KubemlClient:
    def __init__(self, url: Optional[str] = None, timeout: float = 120.0):
        self.url = resolve_controller_url(url).rstrip("/")
        self.timeout = timeout

    def networks(self) -> _Networks:
        return _Networks(self)

    def datasets(self) -> _Datasets:
        return _Datasets(self)

    def tasks(self) -> _Tasks:
        return _Tasks(self)

    def histories(self) -> _Histories:
        return _Histories(self)

    def functions(self) -> _Functions:
        return _Functions(self)

    def checkpoints(self) -> _Checkpoints:
        return _Checkpoints(self)

    def health(self) -> bool:
        try:
            return http.get(f"{self.url}/health",
                            timeout=http.timeouts(5)).status_code == 200
        except http.TransportError:
            return False

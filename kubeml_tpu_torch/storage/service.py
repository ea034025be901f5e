"""The storage service, the HTTP front door of dataset upload and delete:
the port of ``kubeml_tpu/storage/service.py``.

``POST /dataset/<name>`` takes a multipart upload of four ``.npy`` files
named ``x-train``, ``y-train``, ``x-test`` and ``y-test`` (read with
``allow_pickle=False``: a pickled upload is refused with a 400, where the
JAX service would unpickle it); ``DELETE /dataset/<name>``,
``GET /dataset/<name>`` (its summary) and ``GET /dataset`` (the list)
answer from the store's manifests.

A text corpus is the other upload form: a ``corpus`` part (UTF-8, blank
lines between documents) with optional ``corpus-test``, ``seq-len``
(default 512), ``tokenizer`` (a JSON asset) or ``train-bpe`` (a vocabulary
size: ``data.bpe.train_bpe`` trains a merge table on the corpus inside the
request) parts, packed to ``[N, seq-len]`` token rows by
``data.text.pack_corpus``; without ``corpus-test`` the last tenth of the
rows (at least one) is the test split. The packing record and the
tokenizer asset go into the manifest's ``meta`` (the controller serves the
asset at ``GET /dataset/{name}/tokenizer``). A corpus that is not UTF-8,
packs to a single row, or comes with both ``train-bpe`` and a tokenizer is
a 400.
"""

from __future__ import annotations

import io
import json
from email.message import Message
from email.parser import BytesParser
from email.policy import HTTP
from typing import Dict, Optional

import numpy as np

from ..api.config import Config, get_config
from ..api.errors import InvalidFormatError, KubeMLError
from ..utils.httpd import Request, Router, Service
from .store import ShardStore

REQUIRED_FILES = ("x-train", "y-train", "x-test", "y-test")


def parse_multipart(body: bytes, content_type: str) -> Dict[str, bytes]:
    """A multipart/form-data body as {field name: payload bytes}."""
    if "multipart/form-data" not in (content_type or ""):
        raise InvalidFormatError("expected multipart/form-data upload")
    msg: Message = BytesParser(policy=HTTP).parsebytes(
        b"Content-Type: " + content_type.encode() + b"\r\n\r\n" + body)
    if not msg.is_multipart():
        raise InvalidFormatError("malformed multipart body")
    out: Dict[str, bytes] = {}
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        if name:
            out[name] = part.get_payload(decode=True) or b""
    return out


def create_dataset_from_upload(store, name: str,
                               files: Dict[str, bytes]) -> dict:
    """Create a dataset from a parsed upload: the four arrays, or a text
    corpus (the storage service and the controller share it)."""
    if "corpus" in files:
        return _create_text(store, name, files)
    missing = [f for f in REQUIRED_FILES if f not in files]
    if missing:
        raise KubeMLError(f"missing upload files: {missing}", 400)
    arrays = {f: decode_array(files[f], f) for f in REQUIRED_FILES}
    return store.create(name, x_train=arrays["x-train"],
                        y_train=arrays["y-train"], x_test=arrays["x-test"],
                        y_test=arrays["y-test"]).to_dict()


def _utf8(files: Dict[str, bytes], part: str) -> str:
    try:
        return files[part].decode("utf-8")
    except UnicodeDecodeError as e:
        raise KubeMLError(f"{part} is not valid UTF-8: {e}", 400)


def _create_text(store, name: str, files: Dict[str, bytes]) -> dict:
    """The ``corpus`` form (JAX storage/service.py:52-120)."""
    from ..data.text import pack_corpus

    try:
        seq_len = int((files.get("seq-len") or b"512").decode().strip()
                      or 512)
    except ValueError:
        raise KubeMLError("seq-len must be an integer", 400)
    spec = None
    if "tokenizer" in files:
        try:
            spec = json.loads(files["tokenizer"])
        except ValueError as e:
            raise KubeMLError(f"tokenizer asset is not valid JSON: {e}", 400)
    corpus = _utf8(files, "corpus")
    if "train-bpe" in files:
        if spec is not None:
            raise KubeMLError("train-bpe and a supplied tokenizer asset are "
                              "mutually exclusive", 400)
        try:
            bpe_vocab = int(files["train-bpe"].decode().strip())
        except ValueError:
            raise KubeMLError("train-bpe must be an integer vocab size", 400)
        from ..data.bpe import train_bpe

        spec = train_bpe(corpus, bpe_vocab)
    rows, meta = pack_corpus(corpus, seq_len, spec)
    if "corpus-test" in files:
        test_rows, _ = pack_corpus(_utf8(files, "corpus-test"), seq_len, spec)
    else:
        if len(rows) < 2:
            raise KubeMLError("corpus packs to a single row — supply more "
                              "text or an explicit corpus-test part", 400)
        n_test = max(1, len(rows) // 10)
        test_rows, rows = rows[-n_test:], rows[:-n_test]
    summary = store.create(
        name, x_train=rows, y_train=np.zeros(len(rows), np.int64),
        x_test=test_rows, y_test=np.zeros(len(test_rows), np.int64),
        meta={"packing": meta,
              **({"tokenizer": spec} if spec is not None else {})})
    return {**summary.to_dict(), "packing": meta}


def decode_array(payload: bytes, field: str) -> np.ndarray:
    """One uploaded ``.npy`` file, read without unpickling anything."""
    if payload[:6] != b"\x93NUMPY":
        raise InvalidFormatError(f"{field}: not a .npy file (pickled "
                                 f"uploads are not accepted)")
    try:
        return np.load(io.BytesIO(payload), allow_pickle=False)
    except ValueError as e:
        raise InvalidFormatError(f"{field}: bad .npy file: {e}")


class StorageService:
    def __init__(self, store: Optional[ShardStore] = None,
                 config: Optional[Config] = None):
        self.cfg = config or get_config()
        self.store = store or ShardStore(config=self.cfg)
        router = Router("storage")
        router.route("GET", "/dataset", self._list)
        router.route("GET", "/dataset/{name}", self._get)
        router.route("POST", "/dataset/{name}", self._create)
        router.route("DELETE", "/dataset/{name}", self._delete)
        self.service = Service(router, self.cfg.host, self.cfg.storage_port)

    def _list(self, req: Request):
        return [s.to_dict() for s in self.store.list()]

    def _get(self, req: Request):
        return self.store.get(req.params["name"]).summary().to_dict()

    def _create(self, req: Request):
        files = parse_multipart(req.body,
                                req.headers.get("Content-Type", ""))
        return create_dataset_from_upload(self.store, req.params["name"],
                                          files)

    def _delete(self, req: Request):
        self.store.delete(req.params["name"])
        return {"deleted": req.params["name"]}

    def start(self) -> "StorageService":
        self.service.start()
        return self

    def stop(self) -> None:
        self.service.stop()

    @property
    def url(self) -> str:
        return self.service.url

"""Status-carrying errors of the serving engine and the K-AVG trainer.

The port's own copy of the classes of ``kubeml_tpu/api/errors.py`` that the
port raises: every error carries the HTTP status the wire layer answers
with (400 for a request the arena can never hold or a bad dataset, 404 for
a missing dataset, job, checkpoint or function, 429 at the queue limit,
500 for a failed merge, 503 once the engine is closed or faulted) and
serialises to the ``{"error": <message>, "code": <status>}`` envelope, which
:func:`error_from_envelope` turns back into a typed error.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional


class KubeMLError(Exception):
    """Base error with an HTTP status code and JSON envelope."""

    status_code = 500

    def __init__(self, message: str = "", status_code: Optional[int] = None):
        super().__init__(message or self.__class__.__name__)
        self.message = message or self.__class__.__name__
        if status_code is not None:
            self.status_code = status_code

    def to_dict(self) -> Dict[str, Any]:
        return {"error": self.message, "code": self.status_code}

    def to_json(self) -> str:
        return json.dumps(self.to_dict())


class OverloadedError(KubeMLError):
    """Serving admission refused under overload: 429 with a Retry-After
    hint carried in the envelope."""

    status_code = 429

    def __init__(self, message: str = "", retry_after: float = 1.0):
        super().__init__(message or "server overloaded, retry later")
        self.retry_after = float(retry_after)

    def to_dict(self) -> Dict[str, Any]:
        d = super().to_dict()
        d["retry_after"] = self.retry_after
        return d


class EngineFaultError(KubeMLError):
    """Retryable serving-engine failure (503): the decode engine faulted
    while this request was in flight. ``partial_tokens`` holds the tokens
    each row emitted before the fault."""

    status_code = 503

    def __init__(self, message: str = "",
                 partial_tokens: Optional[list] = None,
                 status_code: Optional[int] = None):
        super().__init__(message or "decode engine fault, retry", status_code)
        self.retryable = True
        self.partial_tokens = [list(t) for t in (partial_tokens or [])]

    def to_dict(self) -> Dict[str, Any]:
        d = super().to_dict()
        d["retryable"] = True
        d["partial_tokens"] = self.partial_tokens
        return d


class MergeError(KubeMLError):
    """Weight averaging failed: no worker took part in a sync round."""

    status_code = 500


class DataError(KubeMLError):
    """Dataset contents could not be loaded."""

    status_code = 400


class InvalidFormatError(KubeMLError):
    """An uploaded dataset file is not a .npy array, or is malformed."""

    status_code = 400


class StorageError(KubeMLError):
    """Shard store failure."""

    status_code = 500


class DatasetNotFoundError(KubeMLError):
    status_code = 404

    def __init__(self, name: str = ""):
        super().__init__(f"dataset {name!r} not found" if name
                         else "dataset not found")


class DatasetExistsError(KubeMLError):
    status_code = 400

    def __init__(self, name: str = ""):
        super().__init__(f"dataset {name!r} already exists" if name
                         else "dataset exists")


class CheckpointNotFoundError(KubeMLError):
    status_code = 404

    def __init__(self, ref: str = ""):
        super().__init__(f"checkpoint {ref!r} not found" if ref
                         else "checkpoint not found")


class InvalidArgsError(KubeMLError):
    """Bad invocation arguments."""

    status_code = 500


class FunctionNotFoundError(KubeMLError):
    status_code = 404

    def __init__(self, name: str = ""):
        super().__init__(f"function {name!r} not found" if name
                         else "function not found")


class JobNotFoundError(KubeMLError):
    status_code = 404

    def __init__(self, job_id: str = ""):
        super().__init__(f"job {job_id!r} not found" if job_id
                         else "job not found")


def error_from_envelope(body, default_code: int = 500) -> KubeMLError:
    """The typed error of a ``{"error", "code"}`` envelope: a 429 rebuilds
    as :class:`OverloadedError` with its ``retry_after``, a ``retryable``
    envelope as :class:`EngineFaultError` with its ``partial_tokens``, so
    both survive every hop of a proxy chain. A body that is not an
    envelope becomes its own text under ``default_code``."""
    retry_after = None
    retryable = False
    partial_tokens = None
    try:
        d = json.loads(body)
        msg = d.get("error", "unknown error")
        code = int(d.get("code", default_code))
        retry_after = d.get("retry_after")
        retryable = bool(d.get("retryable"))
        partial_tokens = d.get("partial_tokens")
    except (ValueError, TypeError, AttributeError):
        msg = (body.decode(errors="replace") if isinstance(body, bytes)
               else str(body))
        code = default_code
    if code == 429:
        try:
            return OverloadedError(msg, retry_after=float(retry_after or 1.0))
        except (TypeError, ValueError):
            return OverloadedError(msg)
    if retryable:
        try:
            return EngineFaultError(msg, partial_tokens=partial_tokens,
                                    status_code=code)
        except (TypeError, ValueError):
            return EngineFaultError(msg, status_code=code)
    return KubeMLError(msg, code)

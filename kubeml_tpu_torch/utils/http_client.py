"""Outbound HTTP of the port's services and clients, on the standard library
only: the counterpart of ``kubeml_tpu/utils/traced_http.py``.

:func:`request` builds one call and sends it through
``utils.resilience.resilient_request`` (the breaker, client chaos, bounded
retries, the deadline):

* a JSON body (``json=``), raw bytes (``data=``) or a multipart upload
  (``files={field: (filename, bytes)}``), and query ``params``; the body
  is built once and every attempt sends the same bytes;
* ``idempotency_key`` (``True`` mints one) as ``x-kubeml-idempotency-key``,
  so the server answers a retried POST from its record;
* ``retryable``: whether to retry; by default an idempotent method (GET,
  HEAD, PUT, DELETE) or a keyed call. A retry follows a transport error
  or a 500/502/503/504; a 429 is returned to the caller at once;
* ``use_breaker=False``: for a caller that owns its retry schedule (the
  PS's hand-over to a booting runner): its failures neither consult nor
  open the destination's breaker;
* the ``x-kubeml-deadline`` header: the deadline bound to the calling
  thread (``utils.resilience.bind_deadline``: a server thread forwards the
  one its request arrived with), which also gates the retries and clamps
  each read timeout; with none bound each attempt stamps now + its read
  timeout, so a read timeout does not use up the retries;
* ``timeout``: seconds, or ``(connect, read)``;
* ``stream=True`` leaves the body unread for
  :meth:`HTTPResponse.iter_lines`: a call is retried only until an answer
  that is not a retryable status has arrived, never mid-stream;
* the calling thread's trace context (``utils.tracing``) as a
  ``traceparent`` header (the caller's own header wins), so the spans of
  a request stitch across every hop;
* the bytes of every call, by route family (:func:`route_label`), into
  ``kubeml_http_{sent,received}_bytes_total{route}``: the request body
  as sent, the answer's body, or a streamed answer's ``Content-Length``
  (a chunked stream counts nothing received).

:func:`check` turns a 4xx/5xx into the typed ``KubeMLError`` of its
envelope (``api.errors.error_from_envelope``), and :func:`ndjson` reads a
streamed answer line by line. A peer that cannot be reached raises
:class:`TransportError` (a 503; :class:`CircuitOpenError` and
:class:`DeadlineExpiredError` are its kinds).
"""

from __future__ import annotations

import http.client
import json as _json
import socket
import uuid
from typing import Any, Dict, Iterator, Optional, Tuple
from urllib.parse import urlencode, urlsplit

from ..api.errors import error_from_envelope
from . import resilience
from .tracing import trace_headers
from .resilience import (CircuitOpenError, DeadlineExpiredError,  # noqa: F401
                         TransportError)

DEFAULT_CONNECT_TIMEOUT = 3.05


class HTTPResponse:
    """One answer: ``status_code``, ``headers``, and the body as
    ``content``/``text``/``json()``, or line by line with ``stream``."""

    def __init__(self, conn: http.client.HTTPConnection,
                 resp: http.client.HTTPResponse, stream: bool):
        self._conn = conn
        self._resp = resp
        self.status_code = resp.status
        self.headers = {k.lower(): v for k, v in resp.getheaders()}
        self._content: Optional[bytes] = None
        if not stream:
            self._read_all()

    def _read_all(self) -> None:
        try:
            self._content = self._resp.read()
        except (OSError, http.client.HTTPException) as e:
            raise TransportError(f"reading the answer failed: {e}")
        finally:
            self.close()

    @property
    def content(self) -> bytes:
        if self._content is None:
            self._read_all()
        return self._content

    @property
    def text(self) -> str:
        return self.content.decode(errors="replace")

    def json(self) -> Any:
        return _json.loads(self.content)

    def iter_lines(self) -> Iterator[bytes]:
        """The body's lines as they arrive (chunked transfer decoded)."""
        try:
            while True:
                line = self._resp.readline()
                if not line:
                    return
                line = line.rstrip(b"\r\n")
                if line:
                    yield line
        except (OSError, http.client.HTTPException) as e:
            raise TransportError(f"the stream broke: {e}")
        finally:
            self.close()

    def close(self) -> None:
        self._conn.close()


def timeouts(read: float, connect: Optional[float] = None
             ) -> Tuple[float, float]:
    """A ``(connect, read)`` pair; the connect default comes from
    ``KUBEML_CONNECT_TIMEOUT``."""
    if connect is None:
        from ..api.config import get_config

        connect = get_config().http_connect_timeout
    return (connect, read)


def _split_timeout(timeout) -> Tuple[Optional[float], Optional[float]]:
    if timeout is None:
        return DEFAULT_CONNECT_TIMEOUT, None
    if isinstance(timeout, (tuple, list)):
        return float(timeout[0]), (None if timeout[1] is None
                                   else float(timeout[1]))
    return float(timeout), float(timeout)


def _multipart(files: Dict[str, tuple]) -> Tuple[bytes, str]:
    """A multipart/form-data body of ``{field: (filename or None,
    bytes or str)}``."""
    boundary = uuid.uuid4().hex
    parts = []
    for name, (filename, payload) in files.items():
        if isinstance(payload, str):
            payload = payload.encode()
        disp = f'form-data; name="{name}"'
        if filename:
            disp += f'; filename="{filename}"'
        parts.append(f"--{boundary}\r\nContent-Disposition: {disp}\r\n"
                     f"Content-Type: application/octet-stream\r\n\r\n"
                     .encode() + payload + b"\r\n")
    body = b"".join(parts) + f"--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


def send(method: str, url: str, *, headers: Dict[str, str], timeout=None,
         body: Optional[bytes] = None, stream: bool = False
         ) -> HTTPResponse:
    """One attempt through ``http.client``; :class:`TransportError` when
    the peer cannot be reached, times out (504) or breaks the answer."""
    parts = urlsplit(url)
    path = (parts.path or "/") + (f"?{parts.query}" if parts.query else "")
    connect, read = _split_timeout(timeout)
    conn = http.client.HTTPConnection(parts.hostname, parts.port or 80,
                                      timeout=connect)
    try:
        conn.connect()
        conn.sock.settimeout(read)
        conn.request(method, path, body=body, headers=headers)
        resp = conn.getresponse()
    except (OSError, http.client.HTTPException) as e:
        conn.close()
        if isinstance(e, socket.timeout):
            raise TransportError(f"{method} {url} timed out: {e}", 504)
        raise TransportError(f"cannot reach {parts.netloc} ({method} "
                             f"{url}): {e}")
    return HTTPResponse(conn, resp, stream)


def route_label(url: str) -> str:
    """A URL's route family, its first path segment (``/update/job-17``
    -> ``/update``): ids never become label values."""
    segments = [s for s in (urlsplit(url).path or "/").split("/") if s]
    return f"/{segments[0]}" if segments else "/"


def _account_bytes(url: str, body: Optional[bytes], resp: HTTPResponse,
                   streamed: bool) -> None:
    """Count a call's bytes by route: the body sent, the answer's body
    (a streamed answer's ``Content-Length``, its body left to the
    caller). Never fails the call it measured."""
    try:
        route = route_label(url)
        if body:
            resilience.incr("kubeml_http_sent_bytes_total", route, len(body))
        if streamed:
            received = int(resp.headers.get("content-length") or 0)
        else:
            received = len(resp.content or b"")
        if received:
            resilience.incr("kubeml_http_received_bytes_total", route,
                            received)
    except Exception:
        pass


def request(method: str, url: str, *, json: Any = None,
            data: Optional[bytes] = None,
            files: Optional[Dict[str, tuple]] = None,
            params: Optional[Dict[str, str]] = None,
            headers: Optional[Dict[str, str]] = None, timeout=None,
            stream: bool = False, idempotency_key=None,
            retryable: Optional[bool] = None,
            use_breaker: bool = True) -> HTTPResponse:
    if params:
        parts = urlsplit(url)
        query = "&".join(q for q in (parts.query, urlencode(params)) if q)
        url = parts._replace(query=query).geturl()
    hdrs = trace_headers(headers)
    body = data
    if json is not None:
        body = _json.dumps(json).encode()
        hdrs.setdefault("Content-Type", "application/json")
    elif files is not None:
        body, ctype = _multipart(files)
        hdrs["Content-Type"] = ctype
    if idempotency_key is True:
        idempotency_key = uuid.uuid4().hex
    if idempotency_key:
        hdrs.setdefault(resilience.IDEMPOTENCY_HEADER, idempotency_key)
    # a bound deadline is the chain's budget (it gates and clamps the
    # retries); at the origin each attempt stamps its own
    deadline = resilience.current_deadline()
    stamp_origin = (deadline is None
                    and resilience.DEADLINE_HEADER not in hdrs)
    if deadline is not None:
        hdrs.setdefault(resilience.DEADLINE_HEADER,
                        resilience.format_deadline(deadline))
    if retryable is None:
        retryable = (method.upper() in resilience.IDEMPOTENT_METHODS
                     or bool(idempotency_key))
    resp = resilience.resilient_request(
        method, url, retryable=retryable, deadline=deadline,
        stamp_origin=stamp_origin, use_breaker=use_breaker, headers=hdrs,
        timeout=timeout, body=body, stream=stream)
    _account_bytes(url, body, resp, stream)
    return resp


def check(resp: HTTPResponse) -> Any:
    """The answer's JSON, or the typed error of its envelope."""
    if resp.status_code >= 400:
        raise error_from_envelope(resp.content, resp.status_code)
    return resp.json()


def ndjson(resp: HTTPResponse) -> Iterator[dict]:
    """A streamed answer's records, one JSON line each; an error status
    raises before the first record."""
    if resp.status_code >= 400:
        raise error_from_envelope(resp.content, resp.status_code)

    def lines():
        try:
            for line in resp.iter_lines():
                yield _json.loads(line)
        finally:
            resp.close()

    return lines()


def get(url: str, **kw) -> HTTPResponse:
    return request("GET", url, **kw)


def post(url: str, **kw) -> HTTPResponse:
    return request("POST", url, **kw)


def delete(url: str, **kw) -> HTTPResponse:
    return request("DELETE", url, **kw)

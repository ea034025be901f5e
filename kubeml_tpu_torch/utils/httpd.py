"""The routed HTTP server every service of the port runs: the port of
``kubeml_tpu/utils/httpd.py``.

A stdlib ``ThreadingHTTPServer`` (one thread a connection) with:

* pattern routes with ``{param}`` captures and a handler per method;
  ``/health`` on every service; an unknown path is a 404, a known path
  under another method a 405;
* JSON bodies and answers; a :class:`KubeMLError` becomes its
  ``{"error", "code"}`` envelope under its status (with ``Retry-After``
  when it carries ``retry_after``), any other exception a 500 envelope;
* :class:`StreamResponse`: chunked transfer of newline-delimited JSON, an
  error raised mid-stream sent as a last ``{"error", "code"}`` line;
* the ``x-kubeml-deadline`` header: a request past it is refused with a
  504 before any work, otherwise the deadline is bound to the handler
  thread (``utils.resilience.bind_deadline``);
* idempotent replay: a POST with an ``x-kubeml-idempotency-key`` runs
  once; a retried delivery gets the recorded 2xx answer;
* chaos (``utils.resilience.chaos``, off unless ``KUBEML_CHAOS`` is set):
  before the deadline check, the replay cache and dispatch, so that an
  injected fault never leaves half-applied state, a request may be
  delayed, answered with a 500, or reset (the socket shut down with no
  answer); ``/health`` and ``/metrics`` are exempt. Injections count
  under ``kubeml_chaos_injected_total``, deadline refusals and replays
  under their own counters;
* tracing (``utils.tracing``): the inbound ``traceparent`` is bound to
  the handler thread (its outbound hops forward it even where this
  process records nothing), and each request records one server span,
  ``"{router} {METHOD} {path}"`` under the router's service, except
  ``/health`` and ``/metrics`` (probes and scrapes would crowd every
  trace).

Port 0 binds any free port; :attr:`Service.port` then holds the bound one.
"""

from __future__ import annotations

import json
import logging
import re
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from ..api.errors import KubeMLError
from . import resilience, tracing

log = logging.getLogger("kubeml.httpd")

Handler = Callable[["Request"], Any]

# paths that neither deadlines nor replay apply to
INTERNAL_PATHS = ("/health", "/metrics")


class Request:
    """A parsed request handed to a route handler."""

    def __init__(self, method: str, path: str, params: Dict[str, str],
                 query: Dict[str, List[str]], body: bytes, headers):
        self.method = method
        self.path = path
        self.params = params  # {param} captures of the route pattern
        self.query = query
        self.body = body
        self.headers = headers

    def json(self) -> Any:
        if not self.body:
            return None
        try:
            return json.loads(self.body)
        except ValueError as e:
            raise KubeMLError(f"invalid JSON body: {e}", 400)

    def arg(self, name: str, default: Optional[str] = None) -> Optional[str]:
        vals = self.query.get(name)
        return vals[0] if vals else default


class Response:
    """An explicit answer: another status, raw bytes or extra headers."""

    def __init__(self, body: Any = None, status: int = 200,
                 content_type: str = "application/json",
                 headers: Optional[Dict[str, str]] = None):
        self.body = body
        self.status = status
        self.content_type = content_type
        self.headers = dict(headers or {})


class StreamResponse(Response):
    """Chunked answer: ``items`` yields JSON-serialisable objects (one
    line each) or raw bytes. The status line is gone once the first chunk
    is out, so an error mid-stream arrives as a last ``{"error"}`` line."""

    def __init__(self, items, content_type: str = "application/x-ndjson"):
        super().__init__(body=None, status=200, content_type=content_type)
        self.items = items


class Router:
    def __init__(self, name: str):
        self.name = name
        self._routes: List[Tuple[str, re.Pattern, Handler]] = []
        self.replay = resilience.ReplayCache()
        self.route("GET", "/health",
                   lambda req: {"status": "ok", "service": name})

    def route(self, method: str, pattern: str, handler: Handler) -> None:
        regex = re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", pattern)
        self._routes.append((method.upper(), re.compile(f"^{regex}$"),
                             handler))

    def dispatch(self, method: str, path: str, query, body: bytes,
                 headers) -> Response:
        matched_path = False
        for m, rx, handler in self._routes:
            match = rx.match(path)
            if match:
                matched_path = True
                if m == method:
                    req = Request(method, path, match.groupdict(), query,
                                  body, headers)
                    result = handler(req)
                    if isinstance(result, Response):
                        return result
                    return Response(result if result is not None else {})
        if matched_path:
            raise KubeMLError(f"method {method} not allowed for {path}", 405)
        raise KubeMLError(f"no route for {path}", 404)


def _error_response(e: KubeMLError) -> Response:
    headers = {}
    retry_after = getattr(e, "retry_after", None)
    if retry_after is not None:
        headers["Retry-After"] = str(int(retry_after))
    return Response(e.to_dict(), status=e.status_code, headers=headers)


class Service:
    """One HTTP service: a Router bound to a port, served by a daemon
    thread."""

    def __init__(self, router: Router, host: str, port: int):
        self.router = router
        self.host = host
        self.port = port
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "Service":
        router = self.router

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                log.debug("%s %s", router.name, fmt % args)

            def _respond(self, resp: Response):
                if isinstance(resp, StreamResponse):
                    return self._respond_stream(resp)
                if isinstance(resp.body, (bytes, bytearray)):
                    payload = bytes(resp.body)
                else:
                    payload = json.dumps(resp.body).encode()
                self.send_response(resp.status)
                self.send_header("Content-Type", resp.content_type)
                self.send_header("Content-Length", str(len(payload)))
                for k, v in resp.headers.items():
                    self.send_header(k, str(v))
                self.end_headers()
                self.wfile.write(payload)

            def _chunk(self, data: bytes):
                self.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")

            def _respond_stream(self, resp: StreamResponse):
                self.send_response(resp.status)
                self.send_header("Content-Type", resp.content_type)
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                try:
                    for item in resp.items:
                        data = (bytes(item)
                                if isinstance(item, (bytes, bytearray))
                                else json.dumps(item).encode() + b"\n")
                        if data:
                            self._chunk(data)
                        self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    return  # the client went away mid-stream
                except KubeMLError as e:
                    self._chunk(json.dumps(e.to_dict()).encode() + b"\n")
                except Exception as e:
                    log.exception("%s: error mid-stream", router.name)
                    self._chunk(json.dumps({"error": str(e), "code": 500})
                                .encode() + b"\n")
                self.wfile.write(b"0\r\n\r\n")

            def _replay(self, method, path, key, deadline):
                """(recorded response or None, whether this request owns
                the execution)."""
                state, val = router.replay.acquire(method, path, key)
                if state == "wait":
                    # the original is mid-flight: wait for it (up to this
                    # request's own deadline), then replay its record, or
                    # execute if it left none
                    wait_s = 30.0
                    if deadline is not None:
                        wait_s = min(max(deadline - time.time(), 1.0), 600.0)
                    val.wait(timeout=wait_s)
                    val = router.replay.get(method, path, key)
                    state = "replay" if val is not None else "owner"
                if state == "replay":
                    resilience.incr("kubeml_http_idempotent_replays_total",
                                    router.name)
                    return val, False
                return None, True

            def _inject_chaos(self, path: str) -> Optional[str]:
                """Maybe sleep; "error" or "reset" when the request must
                fail instead of running."""
                fault = resilience.chaos().server_fault(path)
                if fault is None:
                    return None
                mode, delay = fault
                if mode == "delay":
                    time.sleep(delay)
                    return None
                return mode

            def _chaos_reset(self):
                """Drop the connection with no answer: the client sees a
                reset or an EOF."""
                self.close_connection = True
                try:
                    self.connection.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass

            def _dispatch(self, method, path, query, body, internal):
                """The route's answer, inside a server span unless the
                path is internal."""
                if internal:
                    return router.dispatch(method, path, query, body,
                                           self.headers)
                with tracing.get_tracer().span(
                        f"{router.name} {method} {path}",
                        service=router.name, method=method, path=path):
                    return router.dispatch(method, path, query, body,
                                           self.headers)

            def _handle(self, method: str):
                owner = False
                idem_key = None
                path = urlparse(self.path).path
                try:
                    parsed = urlparse(self.path)
                    length = int(self.headers.get("Content-Length") or 0)
                    body = self.rfile.read(length) if length else b""
                    internal = path in INTERNAL_PATHS
                    if not internal:
                        # chaos first: a reset hits requests that would
                        # have been refused or replayed too
                        mode = self._inject_chaos(path)
                        if mode == "reset":
                            self._chaos_reset()
                            return
                        if mode == "error":
                            raise KubeMLError("chaos: injected server fault",
                                              500)
                    deadline = resilience.parse_deadline(
                        self.headers.get(resilience.DEADLINE_HEADER))
                    if (deadline is not None and not internal
                            and deadline <= time.time()):
                        resilience.incr("kubeml_http_deadline_rejected_total",
                                        router.name)
                        raise KubeMLError(
                            f"deadline expired {path} ({router.name})", 504)
                    resp = None
                    idem_key = self.headers.get(
                        resilience.IDEMPOTENCY_HEADER)
                    if idem_key and method == "POST":
                        resp, owner = self._replay(method, path, idem_key,
                                                   deadline)
                    if resp is None:
                        ctx = tracing.parse_traceparent(
                            self.headers.get("traceparent"))
                        with resilience.bind_deadline(
                                None if internal else deadline), \
                                tracing.use_context(ctx):
                            resp = self._dispatch(
                                method, path, parse_qs(parsed.query), body,
                                internal)
                except KubeMLError as e:
                    resp = _error_response(e)
                except (BrokenPipeError, ConnectionResetError):
                    if owner:  # release any duplicate waiting on us
                        router.replay.settle(method, path, idem_key)
                    return
                except Exception as e:
                    log.exception("%s: unhandled error on %s %s",
                                  router.name, method, self.path)
                    resp = Response({"error": str(e), "code": 500},
                                    status=500)
                if owner:
                    # only a 2xx has side effects worth replaying; a
                    # stream cannot be replayed
                    ok = (not isinstance(resp, StreamResponse)
                          and resp.status < 300)
                    router.replay.settle(method, path, idem_key,
                                         resp if ok else None)
                try:
                    self._respond(resp)
                except (BrokenPipeError, ConnectionResetError):
                    pass

            def do_GET(self):
                self._handle("GET")

            def do_POST(self):
                self._handle("POST")

            def do_PUT(self):
                self._handle("PUT")

            def do_DELETE(self):
                self._handle("DELETE")

        self._server = ThreadingHTTPServer((self.host, self.port), _Handler)
        self._server.daemon_threads = True
        if self.port == 0:
            self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, args=(0.1,),
            name=f"httpd-{self.router.name}", daemon=True)
        self._thread.start()
        log.info("%s listening on %s:%d", self.router.name, self.host,
                 self.port)
        return self

    @property
    def url(self) -> str:
        host = "127.0.0.1" if self.host in ("0.0.0.0", "::") else self.host
        return f"http://{host}:{self.port}"

    def stop(self) -> None:
        if self._server:
            self._server.shutdown()
            self._server.server_close()
            self._server = None

"""Distributed span tracing and device profiling: the port of
``kubeml_tpu/utils/tracing.py``.

* :class:`Tracer`: a thread-safe in-memory span recorder that costs one
  attribute read when disabled. Spans nest through a context manager and
  carry attributes (job id, epoch, round, ...). They export as Chrome
  trace-event JSON (chrome://tracing, Perfetto) or as per-name summary
  statistics.
* Trace identity: every span carries ``trace_id``, ``span_id`` and
  ``parent_id``. The identity crosses processes as a W3C ``traceparent``
  header (:func:`parse_traceparent`, :meth:`TraceContext.traceparent`):
  the HTTP server (``utils.httpd``) binds the inbound context to the
  handler thread and every outbound hop (``utils.http_client.request``)
  stamps the current one, so a train request's spans stitch into one tree
  across CLI, controller, scheduler, parameter server and job runner.
* :func:`device_profile`: a ``torch.profiler`` trace (CPU activity, and
  CUDA activity whenever a card is present) of the block, written as a
  Chrome trace into a directory; its CUDA kernel events carry the names of
  the hand-written kernels.

The process-wide tracer is enabled by ``KUBEML_TRACE=<dir>`` (spans flush
to ``<dir>/kubeml-trace-<pid>.json`` at exit or on :meth:`Tracer.flush`),
or by ``get_tracer().enable(...)``. Span names, services and attribute
keys are the JAX package's, so a trace from either reads the same.

This module imports no torch at module level: the CLI's client commands
use it.
"""

from __future__ import annotations

import atexit
import json
import logging
import os
import re
import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional

log = logging.getLogger("kubeml.trace")

# a ring: past the cap the oldest span goes, so a long-lived traced
# service keeps recording each new task's trace
MAX_SPANS = 200_000


# --- trace identity (W3C trace context) ---

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")


def new_trace_id() -> str:
    return uuid.uuid4().hex


def new_span_id() -> str:
    return uuid.uuid4().hex[:16]


@dataclass(frozen=True)
class TraceContext:
    """The propagated part of a span: the next span's parent."""

    trace_id: str  # 32 lowercase hex characters
    span_id: str  # 16 lowercase hex characters

    def traceparent(self) -> str:
        """The W3C ``traceparent`` value (version 00, sampled)."""
        return f"00-{self.trace_id}-{self.span_id}-01"


def parse_traceparent(header: Optional[str]) -> Optional[TraceContext]:
    """A W3C ``traceparent`` header decoded; None when absent or malformed
    (a peer's bad header never fails the request it came with)."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if m is None:
        return None
    version, trace_id, span_id = m.group(1), m.group(2), m.group(3)
    # version ff and all-zero ids are invalid
    if version == "ff" or trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return TraceContext(trace_id=trace_id, span_id=span_id)


# The per-thread context stack works whether or not the tracer records: a
# process with tracing off still forwards the inbound context unchanged.
_tls = threading.local()


def _ctx_stack() -> list:
    s = getattr(_tls, "ctx", None)
    if s is None:
        s = _tls.ctx = []
    return s


def current_context() -> Optional[TraceContext]:
    """This thread's trace context: its innermost open span, or the
    context the HTTP server or a job thread bound."""
    s = _ctx_stack()
    return s[-1] if s else None


@contextmanager
def use_context(ctx: Optional[TraceContext]) -> Iterator[None]:
    """Bind a received trace context to this thread for the block (no
    span is recorded); None binds nothing."""
    if ctx is None:
        yield
        return
    s = _ctx_stack()
    s.append(ctx)
    try:
        yield
    finally:
        s.pop()


def trace_headers(extra: Optional[dict] = None) -> dict:
    """An outbound hop's headers: the caller's, plus the current
    ``traceparent`` when a context is bound (the caller's wins)."""
    headers = dict(extra or {})
    ctx = current_context()
    if ctx is not None:
        headers.setdefault("traceparent", ctx.traceparent())
    return headers


# --- task binding (log and error-webhook correlation) ---


def _task_stack() -> list:
    s = getattr(_tls, "task", None)
    if s is None:
        s = _tls.task = []
    return s


def current_task() -> Optional[str]:
    s = _task_stack()
    return s[-1] if s else None


@contextmanager
def bind_task(task_id: Optional[str]) -> Iterator[None]:
    """Tie a task id to this thread for the block, so log records and
    error reports carry it."""
    if not task_id:
        yield
        return
    s = _task_stack()
    s.append(task_id)
    try:
        yield
    finally:
        s.pop()


class TraceLogFilter(logging.Filter):
    """Puts ``trace_id`` and ``task_id`` on every log record (``-`` when
    the thread has none), for a format with ``%(trace_id)s``."""

    def filter(self, record: logging.LogRecord) -> bool:
        ctx = current_context()
        record.trace_id = ctx.trace_id if ctx is not None else "-"
        record.task_id = current_task() or "-"
        return True


def add_log_context(logger: Optional[logging.Logger] = None) -> None:
    """Attach :class:`TraceLogFilter` to every handler of ``logger`` (the
    root by default), once each."""
    logger = logger or logging.getLogger()
    for handler in logger.handlers:
        if not any(isinstance(f, TraceLogFilter) for f in handler.filters):
            handler.addFilter(TraceLogFilter())


@dataclass
class Span:
    name: str
    start: float  # time.time() seconds
    duration: float  # seconds
    thread: int
    attrs: Dict[str, Any] = field(default_factory=dict)
    # spans of one trace_id stitch into a tree through parent_id
    trace_id: str = ""
    span_id: str = ""
    parent_id: Optional[str] = None
    # the logical process ("controller", "ps", "worker", ...): one process
    # row each in the merged Chrome trace
    service: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "start": self.start,
            "duration": self.duration,
            "thread": self.thread,
            "attrs": {k: _json_safe(v) for k, v in self.attrs.items()},
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "service": self.service,
            "pid": os.getpid(),
        }


# observers of finished spans (the flight recorder): called with each span
# after it is recorded; they must be cheap, and their errors are swallowed
_span_sinks: List = []


def add_span_sink(fn) -> None:
    """Register an observer of finished spans (once per function)."""
    if fn not in _span_sinks:
        _span_sinks.append(fn)


class Tracer:
    """The span recorder; off by default, when ``span()`` costs one
    attribute read."""

    def __init__(self, enabled: bool = False, out_dir: Optional[Path] = None,
                 service: Optional[str] = None):
        self.enabled = enabled
        self.out_dir = Path(out_dir) if out_dir else None
        # the service of spans that name none
        self.service = service or f"proc-{os.getpid()}"
        self._spans: "deque[Span]" = deque()
        self._lock = threading.Lock()
        self._dropped = 0

    # --- control ---

    def enable(self, out_dir: Optional[Path] = None) -> "Tracer":
        self.enabled = True
        if out_dir is not None:
            self.out_dir = Path(out_dir)
        return self

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._dropped = 0

    @property
    def dropped(self) -> int:
        """The oldest spans evicted past MAX_SPANS since the last clear."""
        with self._lock:
            return self._dropped

    # --- recording ---

    def _append(self, s: Span) -> None:
        with self._lock:
            self._spans.append(s)
            while len(self._spans) > MAX_SPANS:
                self._spans.popleft()
                self._dropped += 1
        for sink in _span_sinks:
            try:
                sink(s)
            except Exception:  # an observer never fails the traced code
                pass

    def _identify(self, attrs: Dict[str, Any]) -> Span:
        """A span skeleton: a child of the thread's context, or the root
        of a new trace."""
        service = attrs.pop("service", None) or self.service
        parent = current_context()
        return Span(
            name="", start=0.0, duration=0.0, thread=threading.get_ident(),
            attrs=attrs,
            trace_id=parent.trace_id if parent is not None else new_trace_id(),
            span_id=new_span_id(),
            parent_id=parent.span_id if parent is not None else None,
            service=service)

    @contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[Optional[Span]]:
        if not self.enabled:
            yield None
            return
        s = self._identify(attrs)
        s.name = name
        s.start = time.time()
        stack = _ctx_stack()
        stack.append(TraceContext(s.trace_id, s.span_id))
        try:
            yield s
        finally:
            stack.pop()
            s.duration = time.time() - s.start
            self._append(s)

    def record(self, name: str, duration: float, **attrs: Any) -> None:
        """A span timed elsewhere, ending now."""
        if not self.enabled:
            return
        s = self._identify(attrs)
        s.name = name
        s.start = time.time() - duration
        s.duration = duration
        self._append(s)

    def add_span(self, name: str, start: float, duration: float, *,
                 trace_id: Optional[str] = None,
                 span_id: Optional[str] = None,
                 parent_id: Optional[str] = None,
                 service: Optional[str] = None,
                 **attrs: Any) -> Optional[Span]:
        """A span with its wall start, duration and (when given) identity
        named by the caller: the serving engine builds a request's phases
        after the fact, where no context manager wrapped them. Returns the
        span (None when disabled) so children can name its ``span_id``."""
        if not self.enabled:
            return None
        s = Span(
            name=name, start=float(start), duration=max(0.0, float(duration)),
            thread=threading.get_ident(), attrs=attrs,
            trace_id=trace_id or new_trace_id(),
            span_id=span_id or new_span_id(),
            parent_id=parent_id, service=service or self.service)
        self._append(s)
        return s

    # --- reading ---

    def spans(self, name: Optional[str] = None) -> List[Span]:
        with self._lock:
            out = list(self._spans)
        if name is not None:
            out = [s for s in out if s.name == name]
        return out

    def task_spans(self, task_id: str) -> List[Span]:
        """A task's spans: those tagged ``job=task_id`` and every span
        sharing a trace id with one of them (the request's HTTP hops)."""
        spans = self.spans()
        trace_ids = {s.trace_id for s in spans
                     if s.trace_id and s.attrs.get("job") == task_id}
        return [s for s in spans
                if s.attrs.get("job") == task_id
                or (s.trace_id and s.trace_id in trace_ids)]

    def task_dicts(self, task_id: str) -> List[Dict[str, Any]]:
        return [s.to_dict() for s in self.task_spans(task_id)]

    def summary(self) -> Dict[str, Dict[str, float]]:
        """{name: {count, total_s, mean_s, max_s}}."""
        agg: Dict[str, List[float]] = {}
        for s in self.spans():
            agg.setdefault(s.name, []).append(s.duration)
        return {
            name: {
                "count": len(ds),
                "total_s": sum(ds),
                "mean_s": sum(ds) / len(ds),
                "max_s": max(ds),
            }
            for name, ds in sorted(agg.items())
        }

    # --- export ---

    def to_chrome_trace(self) -> List[Dict[str, Any]]:
        """Chrome trace events ('X' complete events, µs timestamps)."""
        return [
            {
                "name": s.name,
                "ph": "X",
                "ts": s.start * 1e6,
                "dur": s.duration * 1e6,
                "pid": os.getpid(),
                "tid": s.thread % (1 << 31),
                "args": {k: _json_safe(v) for k, v in s.attrs.items()},
            }
            for s in self.spans()
        ]

    def flush(self, path: Optional[Path] = None) -> Optional[Path]:
        """Write the Chrome trace JSON; its path, or None with nothing to
        write."""
        if path is None:
            if self.out_dir is None:
                return None
            path = self.out_dir / f"kubeml-trace-{os.getpid()}.json"
        events = self.to_chrome_trace()
        if not events:
            return None
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps({"traceEvents": events}))
        if self._dropped:
            log.warning("trace evicted %d oldest spans past the %d cap",
                        self._dropped, MAX_SPANS)
        return path


def _service_key(d: Dict[str, Any]) -> str:
    return d.get("service") or f"pid-{d.get('pid', 0)}"


def merge_chrome_trace(span_dicts: List[Dict[str, Any]]) -> Dict[str, Any]:
    """One Chrome/Perfetto trace over processes: span dicts (possibly
    collected over HTTP from several processes) with one process row per
    ``service``, the trace identity kept in each event's args."""
    procs: Dict[str, int] = {}
    events: List[Dict[str, Any]] = []
    for d in span_dicts:
        key = _service_key(d)
        if key not in procs:
            procs[key] = len(procs) + 1
            events.append({"ph": "M", "name": "process_name",
                           "pid": procs[key], "args": {"name": key}})
    for d in span_dicts:
        args = dict(d.get("attrs") or {})
        for k in ("trace_id", "span_id", "parent_id"):
            if d.get(k):
                args[k] = d[k]
        events.append({
            "name": d.get("name", ""),
            "ph": "X",
            "ts": float(d.get("start", 0.0)) * 1e6,
            "dur": float(d.get("duration", 0.0)) * 1e6,
            "pid": procs[_service_key(d)],
            "tid": int(d.get("thread", 0)) % (1 << 31),
            "args": args,
        })
    return {"traceEvents": events}


def post_task_spans(ps_url: str, task_id: str,
                    tracer: Optional["Tracer"] = None) -> bool:
    """POST this process's finished spans of a task to the parameter
    server's collector (``/traces/{task_id}``), with this process's
    data-plane counters under the tracer's service. A job runner's or a
    follower's last act; never raises. Returns whether anything went."""
    tracer = tracer or get_tracer()
    if not tracer.enabled:
        return False
    spans = tracer.task_dicts(task_id)
    if not spans:
        return False
    try:
        from . import http_client, profiler

        payload = {"spans": spans,
                   "counters": profiler.counters_snapshot(),
                   "service": tracer.service}
        http_client.check(http_client.post(
            f"{ps_url}/traces/{task_id}", json=payload, timeout=10,
            idempotency_key=True))
        return True
    except Exception:
        log.debug("posting %d spans for %s failed", len(spans), task_id,
                  exc_info=True)
        return False


def _json_safe(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


# --- the process-wide tracer ---

_global = Tracer()
_atexit_armed = False


def get_tracer() -> Tracer:
    global _atexit_armed
    env_dir = os.environ.get("KUBEML_TRACE")
    if env_dir and not _global.enabled:
        _global.enable(Path(env_dir))
        if not _atexit_armed:
            _atexit_armed = True
            atexit.register(_global.flush)
    return _global


# --- device profiling ---


@contextmanager
def device_profile(log_dir: Path) -> Iterator[Any]:
    """A ``torch.profiler`` trace of the block: CPU activity always, CUDA
    activity whenever a card is present, written as the Chrome trace
    ``<log_dir>/device-trace-<pid>-<n>.json``. Yields the profiler (its
    ``key_averages()`` and events). A failure of the profiler raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    n = len(list(log_dir.glob(f"device-trace-{os.getpid()}-*.json")))
    prof.export_chrome_trace(
        str(log_dir / f"device-trace-{os.getpid()}-{n}.json"))

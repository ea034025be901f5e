"""Request deadlines and idempotent replay: the port's copy of the
deadline binding and the ``ReplayCache`` of
``kubeml_tpu/utils/resilience.py``.

A server thread binds the absolute deadline (unix seconds) a request
arrived with (the ``x-kubeml-deadline`` header), the decoder reads it at
submit (a request still queued past it fails with 504), and outbound
calls made on that thread forward it. A POST that carries an
``x-kubeml-idempotency-key`` is executed once: a retried delivery is
answered from the recorded response (:class:`ReplayCache`)."""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterator, Optional, Tuple

DEADLINE_HEADER = "x-kubeml-deadline"
IDEMPOTENCY_HEADER = "x-kubeml-idempotency-key"

_tls = threading.local()


def _deadline_stack() -> list:
    s = getattr(_tls, "deadlines", None)
    if s is None:
        s = _tls.deadlines = []
    return s


def current_deadline() -> Optional[float]:
    """The absolute deadline (unix seconds) bound to this thread, or None."""
    s = _deadline_stack()
    return s[-1] if s else None


@contextmanager
def bind_deadline(deadline: Optional[float]) -> Iterator[None]:
    """Bind an absolute deadline to this thread for the ``with`` body;
    None binds nothing."""
    if deadline is None:
        yield
        return
    s = _deadline_stack()
    s.append(float(deadline))
    try:
        yield
    finally:
        s.pop()


def parse_deadline(header: Optional[str]) -> Optional[float]:
    """An ``x-kubeml-deadline`` header's value; None when absent or
    malformed (a bad header never fails the request it rode in on)."""
    if not header:
        return None
    try:
        v = float(header)
    except (TypeError, ValueError):
        return None
    return v if v > 0 else None


def format_deadline(deadline: float) -> str:
    return f"{deadline:.6f}"


class ReplayCache:
    """Bounded TTL cache of (method, path, idempotency key) -> recorded
    response, so a retried keyed POST is answered from the record instead
    of executed again. A duplicate that arrives while the original still
    runs waits for it (:meth:`acquire` gives ``("wait", event)``)."""

    def __init__(self, max_entries: int = 256, ttl: float = 300.0):
        self.max_entries = int(max_entries)
        self.ttl = float(ttl)
        self._lock = threading.Lock()
        self._entries: Dict[Tuple[str, str, str], Tuple[float, object]] = {}
        self._pending: Dict[Tuple[str, str, str], threading.Event] = {}

    def get(self, method: str, path: str, key: str):
        now = time.monotonic()
        with self._lock:
            rec = self._entries.get((method, path, key))
            if rec is None:
                return None
            stored_at, resp = rec
            if now - stored_at > self.ttl:
                del self._entries[(method, path, key)]
                return None
            return resp

    def put(self, method: str, path: str, key: str, resp) -> None:
        with self._lock:
            self._entries[(method, path, key)] = (time.monotonic(), resp)
            while len(self._entries) > self.max_entries:
                self._entries.pop(next(iter(self._entries)))

    def acquire(self, method: str, path: str, key: str):
        """``("replay", resp)`` when a record exists, ``("wait", event)``
        while the original runs, else ``("owner", None)``: the caller
        executes and must :meth:`settle`."""
        k = (method, path, key)
        resp = self.get(method, path, key)
        if resp is not None:
            return ("replay", resp)
        with self._lock:
            ev = self._pending.get(k)
            if ev is not None:
                return ("wait", ev)
            self._pending[k] = threading.Event()
            return ("owner", None)

    def settle(self, method: str, path: str, key: str, resp=None) -> None:
        """The owner finished: record ``resp`` (None: nothing to replay,
        a retry executes again) and release the waiters."""
        k = (method, path, key)
        if resp is not None:
            self.put(method, path, key, resp)
        with self._lock:
            ev = self._pending.pop(k, None)
        if ev is not None:
            ev.set()

"""Request deadlines, the port's copy of the deadline binding of
``kubeml_tpu/utils/resilience.py``: a server thread binds the absolute
deadline (unix seconds) a request arrived with, and the decoder reads it
at submit; a request still queued past it fails with 504."""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Iterator, Optional

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

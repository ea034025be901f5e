"""The error hook: the port of ``kubeml_tpu/utils/errorhook.py``.

With ``KUBEML_ERROR_WEBHOOK`` set, job failures POST a small JSON record
to it (any collector: a chat webhook, an alert receiver, a log sink).
Unset, nothing is posted. The hook never raises and never blocks a
failure path: it posts from a daemon thread with a short timeout, unless
the caller is about to exit and asks to wait.

Every reported failure also dumps the flight recorder
(``utils.profiler``): with ``KUBEML_FLIGHT_DIR`` set the ring of recent
spans and data-plane events, with the counters, lands on disk, and the
webhook payload carries the ring's tail, correlated by ``trace_id``.
"""

from __future__ import annotations

import json
import logging
import os
import threading

log = logging.getLogger("kubeml.errorhook")


def report_error(context: str, message: str, wait: bool = False,
                 **fields) -> None:
    """POST ``{source, context, error, ...fields}`` to
    ``KUBEML_ERROR_WEBHOOK`` (nothing when unset); never raises. It runs
    on a daemon thread unless ``wait``, which a path about to
    ``os._exit`` (the stall watchdog) needs: a daemon thread dies with
    the process before the report leaves."""
    # the flight recorder first, webhook or not: the dump is the evidence
    flight_tail: list = []
    flight_dump = None
    try:
        from .profiler import get_recorder

        recorder = get_recorder()
        flight_tail = recorder.tail(32)
        flight_dump = recorder.dump(f"errorhook:{context}")
    except Exception:
        log.debug("flight recorder unavailable", exc_info=True)
    url = os.environ.get("KUBEML_ERROR_WEBHOOK", "")
    if not url:
        return
    payload = {"source": "kubeml-tpu", "context": context,
               "error": str(message), **fields}
    # the reporting thread's trace and task; the caller's fields win
    from .tracing import current_context, current_task

    ctx = current_context()
    if ctx is not None:
        payload.setdefault("trace_id", ctx.trace_id)
    task = current_task()
    if task is not None:
        payload.setdefault("task_id", task)
    if flight_tail:
        payload.setdefault("flight_recorder", flight_tail)
    if flight_dump is not None:
        payload.setdefault("flight_dump", str(flight_dump))

    def post():
        try:
            import urllib.request

            req = urllib.request.Request(
                url, data=json.dumps(payload, default=str).encode(),
                headers={"Content-Type": "application/json"})
            urllib.request.urlopen(req, timeout=10).read()
        except Exception:
            log.debug("error webhook delivery failed", exc_info=True)

    if wait:
        post()
        return
    threading.Thread(target=post, name="error-webhook", daemon=True).start()

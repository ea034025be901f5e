"""Guardrails on user code the port runs in process: its own copy of
``kubeml_tpu/utils/watchdog.py``.

* :func:`run_with_timeout` runs a call on a watchdog thread; past the
  timeout the call is abandoned on its daemon thread (Python cannot kill a
  thread) and a 408 :class:`FunctionTimeoutError` is raised, so a user
  module that hangs at import never wedges its caller;
* :class:`FunctionBusyError` is the 429 of a full load semaphore;
* :func:`arm_stall_watchdog` (JAX :49-146) guards a job over ranks: a
  rank whose job stops stamping ``job.heartbeat`` (a step wedged in user
  code) ends its own process with :data:`STALL_EXIT_CODE`, so the group
  fails fast (its peers' collectives and store reads raise) instead of
  hanging in a collective only some ranks joined. Abandoning the thread,
  as :func:`run_with_timeout` does, would leave the peers inside it. The
  leader's job thread and every follower arm it; the journal keeps the
  job, so a supervised restart resumes it. Before the exit it dumps the
  flight recorder (``utils.profiler``; to ``KUBEML_FLIGHT_DIR`` when
  set).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Callable, Optional

from ..api.errors import KubeMLError

log = logging.getLogger("kubeml.watchdog")

# the exit code of a process that ended itself on a stalled job (a crash
# exits 1), so a supervisor or a test can tell the two apart
STALL_EXIT_CODE = 74


def arm_stall_watchdog(job, timeout: float, what: str,
                       on_stall: Optional[Callable[[str], None]] = None,
                       recovery: str = ("supervision restarts it and the "
                                        "journal resumes the job")
                       ) -> threading.Event:
    """Watch ``job.heartbeat`` from a daemon thread: once it is older than
    ``timeout`` seconds (twice that while ``job.heartbeat_cold``, the
    first step, which builds the kernels), log why, dump the flight
    recorder, run ``on_stall(reason)`` (the leader writes the failure
    history and reports it) and ``os._exit(STALL_EXIT_CODE)``. Returns an
    event; set it to disarm. ``timeout <= 0`` arms nothing (the event
    comes back set)."""
    stop = threading.Event()
    if timeout is None or timeout <= 0:
        stop.set()
        return stop

    def loop():
        while not stop.wait(min(2.0, timeout / 4)):
            hb = getattr(job, "heartbeat", None)
            if hb is None:
                continue
            allowed = timeout * (2.0 if getattr(job, "heartbeat_cold", False)
                                 else 1.0)
            stale = time.time() - hb
            if stale <= allowed or stop.is_set():
                continue
            reason = (f"{what}: no progress for {stale:.0f}s (allowance "
                      f"{allowed:g}s; KUBEML_FUNCTION_TIMEOUT); terminating "
                      f"this process; {recovery}")
            log.error("%s", reason)
            # the postmortem: recent spans and counters, before the exit
            try:
                from .profiler import get_recorder

                dump = get_recorder().dump(f"watchdog:{what}")
                if dump is not None:
                    log.error("flight recorder dumped to %s", dump)
            except Exception:
                log.debug("flight recorder dump failed", exc_info=True)
            if on_stall is not None:
                try:
                    on_stall(reason)
                except Exception:
                    log.exception("stall handler failed")
            if stop.is_set():
                return  # the job finished while the handler ran
            os._exit(STALL_EXIT_CODE)

    threading.Thread(target=loop, name=f"stall-watch-{what}",
                     daemon=True).start()
    return stop


class FunctionTimeoutError(KubeMLError):
    def __init__(self, what: str, timeout: float):
        super().__init__(
            f"{what} exceeded the function execution timeout ({timeout:g}s; "
            f"KUBEML_FUNCTION_TIMEOUT)", 408)


class FunctionBusyError(KubeMLError):
    def __init__(self, limit: int):
        super().__init__(
            f"function concurrency limit reached ({limit}; "
            f"KUBEML_FUNCTION_CONCURRENCY)", 429)


def run_with_timeout(fn: Callable[[], Any], timeout: float, what: str) -> Any:
    """``fn()`` on a watchdog thread; :class:`FunctionTimeoutError` if it
    does not finish in ``timeout`` seconds (``<= 0``: no limit)."""
    if timeout is None or timeout <= 0:
        return fn()
    box: dict = {}
    done = threading.Event()

    def run():
        try:
            box["value"] = fn()
        except BaseException as e:  # raised again on the caller's thread
            box["error"] = e
        finally:
            done.set()

    threading.Thread(target=run, name=f"fn-watchdog:{what}",
                     daemon=True).start()
    if not done.wait(timeout):
        raise FunctionTimeoutError(what, timeout)
    if "error" in box:
        raise box["error"]
    return box["value"]

"""Guardrails on user code the port runs in process: its own copy of the
part of ``kubeml_tpu/utils/watchdog.py`` the function registry needs.

* :func:`run_with_timeout` runs a call on a watchdog thread; past the
  timeout the call is abandoned on its daemon thread (Python cannot kill a
  thread) and a 408 :class:`FunctionTimeoutError` is raised, so a user
  module that hangs at import never wedges its caller;
* :class:`FunctionBusyError` is the 429 of a full load semaphore.
"""

from __future__ import annotations

import threading
from typing import Any, Callable

from ..api.errors import KubeMLError


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

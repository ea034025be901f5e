"""Control-plane resilience: the port of ``kubeml_tpu/utils/resilience.py``.

Every HTTP hop between the port's services (CLI and client -> controller ->
scheduler -> PS -> job runner, and back) goes through
:func:`resilient_request`, so one reset connection does not fail a job the
K-AVG merge would have survived:

* :class:`RetryPolicy`: bounded attempts with exponential backoff and
  jitter, throttled by a per-destination :class:`RetryBudget` (a token
  bucket that earns a fraction of the first attempts, so an outage adds
  about that fraction of load instead of a retry storm). Only a retryable
  call retries: an idempotent method, or a POST that carries an
  idempotency key. 429 is never retried: its ``Retry-After`` reaches the
  caller.
* :class:`CircuitBreaker`: per destination, closed -> open -> half-open.
  ``threshold`` consecutive transport failures open it for ``cooldown``
  seconds; one half-open probe then closes or re-opens it. Any answer,
  5xx included, counts as a success: only transport failures count.
* Deadlines: a server thread binds the absolute deadline (unix seconds)
  its request arrived with (``x-kubeml-deadline``); outbound calls on that
  thread forward it and clamp their read timeout to what is left. At the
  origin (no bound deadline) each attempt stamps now + its read timeout,
  so a read timeout does not use up the retry schedule.
* Idempotent replay: a keyed POST runs once on the server; a retried
  delivery gets the recorded answer (:class:`ReplayCache`).
* Chaos: fault injection gated by environment variables (all off by
  default, :class:`ChaosConfig`): the server middleware of ``utils.httpd``
  injects a delay, a 500 or a connection reset per request, the client
  fails a call before its bytes leave.

The process counters (:func:`incr`) render into the PS's ``/metrics``
(:func:`render_metrics`, appended by ``ps.metrics.MetricsRegistry``).
"""

from __future__ import annotations

import logging
import os
import random
import re
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple
from urllib.parse import urlsplit

from ..api.errors import KubeMLError

log = logging.getLogger("kubeml.resilience")

DEADLINE_HEADER = "x-kubeml-deadline"
IDEMPOTENCY_HEADER = "x-kubeml-idempotency-key"

# statuses a retryable call retries: the peer answered "not now" (500
# included: chaos and crashed handlers both give it). 429 is not among
# them: shed work stays shed, and the caller decides when to come back
RETRY_STATUSES = (500, 502, 503, 504)
IDEMPOTENT_METHODS = ("GET", "HEAD", "PUT", "DELETE")


class TransportError(KubeMLError):
    """The peer could not be reached, or the connection broke."""

    status_code = 503


class CircuitOpenError(TransportError):
    """Raised instead of dialing a destination whose breaker is open: the
    unreachable peer it stands for, to every caller of TransportError."""

    status_code = 503


class DeadlineExpiredError(TransportError):
    """The request's deadline passed before (or between) its attempts."""

    status_code = 504


# --- process counters (rendered on the PS /metrics) ---

_counters_lock = threading.Lock()
_counters: Dict[Tuple[str, str], float] = {}

COUNTER_HELP = {
    "kubeml_http_retries_total": (
        "dest", "Outbound HTTP retry attempts per destination"),
    "kubeml_http_retry_budget_exhausted_total": (
        "dest", "Retries suppressed by the per-destination retry budget"),
    "kubeml_http_breaker_open_total": (
        "dest", "Circuit-breaker transitions into the open state"),
    "kubeml_http_breaker_rejected_total": (
        "dest", "Requests rejected fast by an open circuit breaker"),
    "kubeml_http_deadline_rejected_total": (
        "service", "Requests rejected server-side with an expired deadline"),
    "kubeml_http_deadline_expired_total": (
        "dest", "Requests abandoned client-side on an expired deadline"),
    "kubeml_http_idempotent_replays_total": (
        "service", "Responses served from the idempotency replay cache"),
    "kubeml_chaos_injected_total": (
        "mode", "Injected network faults by mode (delay/error/reset/client)"),
    "kubeml_http_sent_bytes_total": (
        "route", "Outbound request payload bytes per route family"),
    "kubeml_http_received_bytes_total": (
        "route", "Inbound response payload bytes per route family"),
}

# labels a metric keeps: a standalone runner is a new destination each,
# so the oldest label goes first
MAX_LABELS_PER_METRIC = 256


def incr(metric: str, label_value: str = "", n: float = 1.0) -> None:
    with _counters_lock:
        key = (metric, label_value)
        if key not in _counters:
            labels = [k for k in _counters if k[0] == metric]
            if len(labels) >= MAX_LABELS_PER_METRIC:
                del _counters[labels[0]]  # dict order: oldest first
        _counters[key] = _counters.get(key, 0.0) + n


def counter_value(metric: str, label_value: str = "") -> float:
    with _counters_lock:
        return _counters.get((metric, label_value), 0.0)


def counters_snapshot() -> Dict[Tuple[str, str], float]:
    with _counters_lock:
        return dict(_counters)


def render_metrics() -> List[str]:
    """Exposition lines of the counters and of the breaker-state gauge a
    destination (0 closed, 1 half-open, 2 open)."""
    from ..ps.metrics import escape_label_value

    snap = counters_snapshot()
    lines: List[str] = []
    for metric, (label, help_text) in COUNTER_HELP.items():
        lines.append(f"# HELP {metric} {help_text}")
        lines.append(f"# TYPE {metric} counter")
        for (m, value_label), v in sorted(snap.items()):
            if m == metric:
                lines.append(f'{metric}{{{label}='
                             f'"{escape_label_value(value_label)}"}} {v:g}')
    lines.append("# HELP kubeml_http_breaker_state Circuit-breaker state per "
                 "destination (0=closed, 1=half-open, 2=open)")
    lines.append("# TYPE kubeml_http_breaker_state gauge")
    with _registry_lock:
        breakers = sorted(_breakers.items())
    for dest, br in breakers:
        lines.append(f'kubeml_http_breaker_state{{dest='
                     f'"{escape_label_value(dest)}"}} {br.state_value}')
    return lines


# --- retry policy and budget ---


@dataclass(frozen=True)
class RetryPolicy:
    """``attempts`` tries in all; the delay before retry ``n`` is
    ``min(backoff * 2**n, backoff_max)`` times a uniform draw in [0.5, 1]."""

    attempts: int = 3
    backoff: float = 0.1
    backoff_max: float = 2.0
    budget_ratio: float = 0.2

    @classmethod
    def from_config(cls) -> "RetryPolicy":
        from ..api.config import get_config

        cfg = get_config()
        return cls(attempts=cfg.retry_attempts, backoff=cfg.retry_backoff,
                   backoff_max=cfg.retry_backoff_max,
                   budget_ratio=cfg.retry_budget)

    def delay(self, attempt: int, rng: Optional[random.Random] = None
              ) -> float:
        base = min(self.backoff * (2 ** attempt), self.backoff_max)
        return base * (rng or random).uniform(0.5, 1.0)


class RetryBudget:
    """A token bucket: a first attempt deposits ``ratio`` tokens (up to
    ``cap``), a retry withdraws one."""

    def __init__(self, ratio: float = 0.2, cap: float = 20.0,
                 initial: float = 5.0):
        self.ratio = float(ratio)
        self.cap = float(cap)
        self._tokens = min(float(initial), self.cap)
        self._lock = threading.Lock()

    def deposit(self) -> None:
        with self._lock:
            self._tokens = min(self._tokens + self.ratio, self.cap)

    def withdraw(self) -> bool:
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False

    @property
    def tokens(self) -> float:
        with self._lock:
            return self._tokens


# --- circuit breaker ---

STATE_CLOSED = "closed"
STATE_OPEN = "open"
STATE_HALF_OPEN = "half-open"

_STATE_VALUES = {STATE_CLOSED: 0, STATE_HALF_OPEN: 1, STATE_OPEN: 2}


class CircuitBreaker:
    """``threshold`` consecutive failures open the circuit; :meth:`allow`
    then refuses until ``cooldown`` seconds have passed and lets exactly
    one probe through (half-open), whose success closes the circuit and
    whose failure opens it for another cooldown."""

    def __init__(self, threshold: int = 5, cooldown: float = 5.0,
                 dest: str = ""):
        self.threshold = max(1, int(threshold))
        self.cooldown = float(cooldown)
        self.dest = dest
        self._lock = threading.Lock()
        self._state = STATE_CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_in_flight = False

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def state_value(self) -> int:
        return _STATE_VALUES[self.state]

    def allow(self) -> bool:
        with self._lock:
            if self._state == STATE_CLOSED:
                return True
            if self._state == STATE_OPEN:
                if time.monotonic() - self._opened_at < self.cooldown:
                    return False
                self._state = STATE_HALF_OPEN
                self._probe_in_flight = True
                return True
            if self._probe_in_flight:  # half-open: one probe at a time
                return False
            self._probe_in_flight = True
            return True

    def record_success(self) -> None:
        with self._lock:
            if self._state != STATE_CLOSED:
                log.info("circuit for %s closed (probe succeeded)",
                         self.dest)
            self._state = STATE_CLOSED
            self._consecutive_failures = 0
            self._probe_in_flight = False

    def record_failure(self) -> None:
        opened = False
        with self._lock:
            self._consecutive_failures += 1
            self._probe_in_flight = False
            if self._state == STATE_HALF_OPEN or (
                    self._state == STATE_CLOSED
                    and self._consecutive_failures >= self.threshold):
                self._state = STATE_OPEN
                self._opened_at = time.monotonic()
                opened = True
        if opened:
            incr("kubeml_http_breaker_open_total", self.dest)
            log.warning("circuit for %s opened after %d consecutive "
                        "failure(s); cooling down %.1fs", self.dest,
                        self._consecutive_failures, self.cooldown)


_registry_lock = threading.Lock()
_breakers: Dict[str, CircuitBreaker] = {}
_budgets: Dict[str, RetryBudget] = {}

# destinations the registries keep (each standalone runner is a new one)
MAX_DESTINATIONS = 128


def destination(url: str) -> str:
    """The breaker and budget key of a URL: its ``host:port``."""
    return urlsplit(url).netloc or url


def _bound_registry(registry: Dict[str, object]) -> None:
    while len(registry) >= MAX_DESTINATIONS:  # the caller holds the lock
        registry.pop(next(iter(registry)))  # dict order: oldest first


def get_breaker(dest: str) -> CircuitBreaker:
    from ..api.config import get_config

    with _registry_lock:
        br = _breakers.get(dest)
        if br is None:
            cfg = get_config()
            _bound_registry(_breakers)
            br = _breakers[dest] = CircuitBreaker(
                threshold=cfg.breaker_threshold,
                cooldown=cfg.breaker_cooldown, dest=dest)
        return br


def get_budget(dest: str) -> RetryBudget:
    from ..api.config import get_config

    with _registry_lock:
        b = _budgets.get(dest)
        if b is None:
            _bound_registry(_budgets)
            b = _budgets[dest] = RetryBudget(ratio=get_config().retry_budget)
        return b


def reset_state() -> None:
    """Drop every breaker, budget and counter (a test's isolation)."""
    with _registry_lock:
        _breakers.clear()
        _budgets.clear()
    with _counters_lock:
        _counters.clear()


# --- deadlines ---

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


def read_timeout(timeout) -> Optional[float]:
    """The read part of a timeout: seconds, or ``(connect, read)``."""
    if timeout is None:
        return None
    if isinstance(timeout, (tuple, list)):
        return timeout[1] if len(timeout) > 1 and timeout[1] else None
    return float(timeout)


def deadline_from_timeout(timeout) -> Optional[float]:
    """now + the timeout's read part, or None."""
    read = read_timeout(timeout)
    return time.time() + read if read is not None else None


def clamp_timeout(timeout, remaining: float):
    """The timeout with its read part capped at ``remaining`` seconds (the
    connect part stays: a connect never eats the whole budget)."""
    remaining = max(remaining, 0.001)
    if timeout is None:
        return remaining
    if isinstance(timeout, (tuple, list)):
        connect = timeout[0]
        read = timeout[1] if len(timeout) > 1 else None
        read = remaining if read is None else min(float(read), remaining)
        return (connect, read)
    return min(float(timeout), remaining)


# --- chaos ---

# never faulted, whatever the route pattern: liveness and the scrape stay
# observable while chaos runs
CHAOS_EXEMPT_PATHS = ("/health", "/metrics")

_CHAOS_ENV_KEYS = ("KUBEML_CHAOS", "KUBEML_CHAOS_CLIENT",
                   "KUBEML_CHAOS_ROUTES", "KUBEML_CHAOS_MODES",
                   "KUBEML_CHAOS_DELAY", "KUBEML_CHAOS_SEED")


class ChaosConfig:
    """The chaos settings (all off by default):

    ``KUBEML_CHAOS``         a server fault's probability a request (0..1)
    ``KUBEML_CHAOS_CLIENT``  a client-side connection error's (0..1)
    ``KUBEML_CHAOS_ROUTES``  a regex the path must match (default: all)
    ``KUBEML_CHAOS_MODES``   a comma list of delay,error,reset (default all)
    ``KUBEML_CHAOS_DELAY``   the longest injected delay, seconds (0.2)
    ``KUBEML_CHAOS_SEED``    the draws' seed (default: entropy)
    """

    def __init__(self, server_p: float = 0.0, client_p: float = 0.0,
                 routes: str = "", modes: str = "", max_delay: float = 0.2,
                 seed: Optional[int] = None):
        self.server_p = min(max(server_p, 0.0), 1.0)
        self.client_p = min(max(client_p, 0.0), 1.0)
        self.routes = re.compile(routes) if routes else None
        valid = ("delay", "error", "reset")
        self.modes = tuple(m.strip() for m in modes.split(",")
                           if m.strip() in valid) or valid
        self.max_delay = max(0.0, max_delay)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    @classmethod
    def from_env(cls) -> "ChaosConfig":
        def f(name, default="0"):
            try:
                return float(os.environ.get(name) or default)
            except ValueError:
                return float(default)

        seed_s = os.environ.get("KUBEML_CHAOS_SEED", "")
        return cls(server_p=f("KUBEML_CHAOS"),
                   client_p=f("KUBEML_CHAOS_CLIENT"),
                   routes=os.environ.get("KUBEML_CHAOS_ROUTES", ""),
                   modes=os.environ.get("KUBEML_CHAOS_MODES", ""),
                   max_delay=f("KUBEML_CHAOS_DELAY", "0.2"),
                   seed=int(seed_s) if seed_s else None)

    def _roll(self) -> float:
        with self._lock:
            return self._rng.random()

    def _choice(self, seq):
        with self._lock:
            return self._rng.choice(seq)

    def server_fault(self, path: str) -> Optional[Tuple[str, float]]:
        """``(mode, delay_s)`` to inject for this request, or None
        (``delay_s`` is 0 but for mode "delay")."""
        if self.server_p <= 0.0 or path in CHAOS_EXEMPT_PATHS:
            return None
        if self.routes is not None and not self.routes.search(path):
            return None
        if self._roll() >= self.server_p:
            return None
        mode = self._choice(self.modes)
        delay = self._roll() * self.max_delay if mode == "delay" else 0.0
        incr("kubeml_chaos_injected_total", mode)
        return (mode, delay)

    def client_fault(self, url: str) -> bool:
        """Whether to fail this outbound call before it leaves."""
        if self.client_p <= 0.0:
            return False
        path = urlsplit(url).path or "/"
        if path in CHAOS_EXEMPT_PATHS:
            return False
        if self.routes is not None and not self.routes.search(path):
            return False
        if self._roll() >= self.client_p:
            return False
        incr("kubeml_chaos_injected_total", "client")
        return True


_chaos_cache: Tuple[Optional[tuple], Optional[ChaosConfig]] = (None, None)
_chaos_lock = threading.Lock()


def chaos() -> ChaosConfig:
    """The process's chaos settings, rebuilt when a chaos variable of the
    environment changes."""
    global _chaos_cache
    fingerprint = tuple(os.environ.get(k) for k in _CHAOS_ENV_KEYS)
    with _chaos_lock:
        cached_fp, cached = _chaos_cache
        if cached is None or cached_fp != fingerprint:
            cached = ChaosConfig.from_env()
            _chaos_cache = (fingerprint, cached)
        return cached


# --- idempotent replay (server side) ---


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


# --- the retry loop ---


def resilient_request(method: str, url: str, *, retryable: bool,
                      deadline: Optional[float] = None,
                      stamp_origin: bool = False,
                      use_breaker: bool = True,
                      policy: Optional[RetryPolicy] = None,
                      headers: Optional[Dict[str, str]] = None,
                      timeout=None, **kwargs):
    """One outbound call under the breaker, client chaos, bounded
    budget-throttled retries (``retryable`` only) and the deadline.

    A bound ``deadline`` is the chain's whole budget: it gates the loop
    and clamps each attempt's read timeout. With ``stamp_origin`` each
    attempt stamps now + its read timeout as the deadline header instead.
    ``kwargs`` go to ``utils.http_client.send`` (``body``, ``stream``).
    Returns the answer; once attempts, budget or deadline run out, raises
    the last transport error or returns the last retryable-status answer.
    """
    from . import http_client

    dest = destination(url)
    policy = policy or RetryPolicy.from_config()
    budget = get_budget(dest)
    budget.deposit()
    breaker = get_breaker(dest)
    attempts = max(1, policy.attempts) if retryable else 1
    headers = dict(headers or {})
    last_exc: Optional[Exception] = None
    last_resp = None
    for attempt in range(attempts):
        attempt_timeout = timeout
        if deadline is not None:
            remaining = deadline - time.time()
            if remaining <= 0:
                incr("kubeml_http_deadline_expired_total", dest)
                if last_exc is not None:
                    raise last_exc
                if last_resp is not None:
                    return last_resp
                raise DeadlineExpiredError(
                    f"deadline expired before {method} {url}")
            attempt_timeout = clamp_timeout(timeout, remaining)
        elif stamp_origin:
            rt = read_timeout(timeout)
            if rt is not None:
                headers[DEADLINE_HEADER] = format_deadline(time.time() + rt)
        if use_breaker and not breaker.allow():
            incr("kubeml_http_breaker_rejected_total", dest)
            raise CircuitOpenError(
                f"circuit open for {dest} (failing {method} {url} fast)")
        if attempt:
            incr("kubeml_http_retries_total", dest)
        try:
            if chaos().client_fault(url):
                raise TransportError(
                    f"chaos: injected client-side connection error to {dest}")
            resp = http_client.send(method, url, headers=headers,
                                    timeout=attempt_timeout, **kwargs)
        except TransportError as e:
            if use_breaker:
                breaker.record_failure()
            last_exc, last_resp = e, None
        except Exception:
            # anything else must settle the breaker too: a half-open probe
            # that neither succeeds nor fails would wedge the destination
            if use_breaker:
                breaker.record_failure()
            raise
        else:
            # any answer, a 5xx too, shows the destination is reachable:
            # only transport failures feed the breaker
            breaker.record_success()
            if last_resp is not None:
                last_resp.close()
            last_exc, last_resp = None, resp
            if resp.status_code not in RETRY_STATUSES:
                return resp
        if attempt + 1 >= attempts:
            break
        if not budget.withdraw():
            incr("kubeml_http_retry_budget_exhausted_total", dest)
            break
        delay = policy.delay(attempt)
        if deadline is not None:
            delay = min(delay, max(deadline - time.time(), 0.0))
        if delay > 0:
            time.sleep(delay)
    if last_exc is not None:
        raise last_exc
    return last_resp

"""The port's control-plane resilience (``kubeml_tpu_torch/utils/
resilience.py``, ``utils/http_client.py``, ``utils/httpd.py``'s chaos
middleware) on the CPU, beside the JAX package's.

The cases of ``tests/test_resilience.py`` that apply to the port run
against a port ``httpd`` service: the retry policy and budget, the circuit
breaker, the retry loop (503s, keyed replay, a dead destination, the
half-open probe, ``use_breaker=False``), deadlines (the origin's read
timeout does not use up the retries), chaos (server error, reset, client)
and the bounded registries. Parity with JAX: the chaos fault sequence
for one seed, ``RetryPolicy.delay`` under one seeded ``random.Random``, a
scripted breaker's states, ``render_metrics``'s lines, and the flags each
client call carries. The acceptance case trains a small K-AVG job through
a port ``LocalCluster`` under JAX's chaos settings, waiting on the job's
history, each wait with its own deadline.
"""

import random
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from kubeml_tpu.utils import resilience as jres
from kubeml_tpu_torch.api.errors import KubeMLError, OverloadedError
from kubeml_tpu_torch.utils import http_client as http
from kubeml_tpu_torch.utils import resilience
from kubeml_tpu_torch.utils.httpd import Router, Service, StreamResponse

WAIT = 120.0  # seconds any cluster wait may take before the test fails


@pytest.fixture(autouse=True)
def _fresh_resilience():
    """Breakers, budgets and counters are process-wide: isolate each test."""
    resilience.reset_state()
    jres.reset_state()
    yield
    resilience.reset_state()
    jres.reset_state()


@pytest.fixture
def service():
    """A live port httpd with recording routes: (url, state)."""
    state = {"calls": {}, "headers": {}, "bodies": []}

    def record(req):
        name = req.params["name"]
        state["calls"][name] = state["calls"].get(name, 0) + 1
        state["headers"][name] = {k.lower(): v for k, v in req.headers.items()}
        return {"name": name, "calls": state["calls"][name]}

    def flaky(req):
        n = state["calls"]["flaky"] = state["calls"].get("flaky", 0) + 1
        state["bodies"].append(req.body)
        if n < int(req.params["succeed_on"]):
            raise KubeMLError("transient", 503)
        return {"calls": n}

    def slow(req):
        time.sleep(0.5)
        return record(req)

    def slow_once(req):
        n = state["calls"]["slow_once"] = state["calls"].get("slow_once",
                                                             0) + 1
        if n == 1:
            time.sleep(1.0)
        return {"calls": n}

    def stream(req):
        n = state["calls"]["stream"] = state["calls"].get("stream", 0) + 1
        if n < int(req.params["succeed_on"]):
            raise KubeMLError("not yet", 503)
        return StreamResponse(iter([{"row": 0}, {"row": 1}, {"done": True}]))

    def shed(req):
        state["calls"]["shed"] = state["calls"].get("shed", 0) + 1
        raise OverloadedError("queue full", retry_after=7.0)

    router = Router("resilience-test")
    router.route("GET", "/echo/{name}", record)
    router.route("POST", "/echo/{name}", record)
    router.route("GET", "/flaky/{succeed_on}", flaky)
    router.route("POST", "/flaky/{succeed_on}", flaky)
    router.route("POST", "/slow/{name}", slow)
    router.route("GET", "/slowonce", slow_once)
    router.route("GET", "/stream/{succeed_on}", stream)
    router.route("POST", "/shed", shed)
    svc = Service(router, "127.0.0.1", 0).start()
    try:
        yield svc.url, state
    finally:
        svc.stop()


# --- RetryPolicy / RetryBudget ---


def test_retry_policy_backoff_bounds():
    p = resilience.RetryPolicy(attempts=5, backoff=0.1, backoff_max=0.4)
    rng = random.Random(0)
    for attempt in range(6):
        d = p.delay(attempt, rng)
        cap = min(0.1 * 2 ** attempt, 0.4)
        assert 0.5 * cap <= d <= cap


def test_retry_policy_from_config(monkeypatch):
    from kubeml_tpu_torch.api.config import Config, set_config

    monkeypatch.setenv("KUBEML_RETRY_ATTEMPTS", "7")
    monkeypatch.setenv("KUBEML_RETRY_BACKOFF", "0.25")
    set_config(Config())
    try:
        p = resilience.RetryPolicy.from_config()
        assert p.attempts == 7 and p.backoff == 0.25
    finally:
        monkeypatch.undo()
        set_config(Config())


def test_config_fields_and_defaults_equal_jax(monkeypatch):
    from kubeml_tpu.api.config import Config as JConfig
    from kubeml_tpu_torch.api.config import Config

    names = ("retry_attempts", "retry_backoff", "retry_backoff_max",
             "retry_budget", "breaker_threshold", "breaker_cooldown")
    assert ([getattr(Config(), n) for n in names]
            == [getattr(JConfig(), n) for n in names] == [3, 0.1, 2.0, 0.2,
                                                          5, 5.0])
    for var, n, v in (("KUBEML_RETRY_BACKOFF_MAX", "retry_backoff_max", 9.5),
                      ("KUBEML_RETRY_BUDGET", "retry_budget", 0.7),
                      ("KUBEML_BREAKER_THRESHOLD", "breaker_threshold", 11),
                      ("KUBEML_BREAKER_COOLDOWN", "breaker_cooldown", 0.5)):
        monkeypatch.setenv(var, str(v))
        assert getattr(Config(), n) == getattr(JConfig(), n) == v


def test_retry_budget_throttles():
    b = resilience.RetryBudget(ratio=0.5, cap=3.0, initial=1.0)
    assert b.withdraw()
    assert not b.withdraw()
    for _ in range(2):
        b.deposit()
    assert b.withdraw()
    for _ in range(100):
        b.deposit()
    assert b.tokens == 3.0


# --- CircuitBreaker ---


def test_breaker_opens_half_opens_and_recovers():
    br = resilience.CircuitBreaker(threshold=3, cooldown=0.1, dest="d")
    for _ in range(2):
        br.record_failure()
    assert br.state == "closed"
    br.record_failure()
    assert br.state == "open"
    assert not br.allow()
    time.sleep(0.12)
    assert br.allow()
    assert br.state == "half-open"
    assert not br.allow()  # a second probe waits for the first
    br.record_success()
    assert br.state == "closed" and br.allow()


def test_breaker_failed_probe_reopens():
    br = resilience.CircuitBreaker(threshold=1, cooldown=0.05, dest="d")
    br.record_failure()
    assert br.state == "open"
    time.sleep(0.06)
    assert br.allow()
    br.record_failure()
    assert br.state == "open"
    assert not br.allow()


def test_breaker_success_resets_consecutive_count():
    br = resilience.CircuitBreaker(threshold=3, cooldown=1.0, dest="d")
    for _ in range(2):
        br.record_failure()
    br.record_success()
    for _ in range(2):
        br.record_failure()
    assert br.state == "closed"


# --- the retry loop against a live server ---


def test_idempotent_get_retries_through_503(service):
    url, state = service
    r = http.get(f"{url}/flaky/3", timeout=5)
    assert r.status_code == 200 and r.json()["calls"] == 3
    assert resilience.counter_value("kubeml_http_retries_total",
                                    resilience.destination(url)) == 2


def test_unkeyed_post_is_not_retried(service):
    url, state = service
    r = http.post(f"{url}/flaky/3", json={}, timeout=5)
    assert r.status_code == 503 and state["calls"]["flaky"] == 1
    assert resilience.counter_value("kubeml_http_retries_total",
                                    resilience.destination(url)) == 0


def test_keyed_post_retries_and_replays(service):
    url, state = service
    r = http.post(f"{url}/flaky/3", json={}, timeout=5,
                  idempotency_key="abc123")
    assert r.status_code == 200 and state["calls"]["flaky"] == 3
    r2 = http.post(f"{url}/flaky/3", json={}, timeout=5,
                   idempotency_key="abc123")
    assert r2.status_code == 200 and r2.json() == r.json()
    assert state["calls"]["flaky"] == 3  # answered from the record
    assert resilience.counter_value("kubeml_http_idempotent_replays_total",
                                    "resilience-test") >= 1
    r3 = http.post(f"{url}/echo/a", json={}, timeout=5, idempotency_key="k2")
    assert r3.json()["calls"] == 1


def test_every_attempt_sends_the_same_body(service):
    """A multipart body is built once: the three attempts carry the same
    bytes (one boundary)."""
    url, state = service
    r = http.post(f"{url}/flaky/3", files={"corpus": ("c.txt", b"abc"),
                                           "seq-len": (None, "16")},
                  timeout=5, idempotency_key=True)
    assert r.status_code == 200
    assert len(state["bodies"]) == 3 and len(set(state["bodies"])) == 1
    assert b"abc" in state["bodies"][0]


def test_429_is_never_retried_and_its_retry_after_reaches_the_caller(
        service):
    url, state = service
    r = http.post(f"{url}/shed", json={}, timeout=5, retryable=True)
    assert r.status_code == 429 and state["calls"]["shed"] == 1
    assert r.headers["retry-after"] == "7"
    with pytest.raises(OverloadedError) as e:
        http.check(r)
    assert e.value.retry_after == 7.0


def test_stream_retries_until_the_head_arrives(service):
    url, state = service
    r = http.get(f"{url}/stream/2", timeout=5, stream=True)
    assert r.status_code == 200 and state["calls"]["stream"] == 2
    assert list(http.ndjson(r)) == [{"row": 0}, {"row": 1}, {"done": True}]


def test_breaker_opens_on_dead_destination_and_fails_fast():
    dead = "http://127.0.0.1:9"  # the discard port: nothing listens
    for _ in range(6):
        with pytest.raises(http.TransportError):
            http.get(f"{dead}/x", timeout=0.5)
    br = resilience.get_breaker("127.0.0.1:9")
    assert br.state == "open"
    assert resilience.counter_value("kubeml_http_breaker_open_total",
                                    "127.0.0.1:9") == 1
    t0 = time.monotonic()
    with pytest.raises(resilience.CircuitOpenError) as e:
        http.get(f"{dead}/x", timeout=5)
    assert time.monotonic() - t0 < 0.5
    assert isinstance(e.value, http.TransportError)
    assert e.value.status_code == 503
    assert resilience.counter_value("kubeml_http_breaker_rejected_total",
                                    "127.0.0.1:9") >= 1


def test_breaker_closes_via_half_open_probe_on_recovery(service,
                                                        monkeypatch):
    url, state = service
    br = resilience.get_breaker(resilience.destination(url))
    monkeypatch.setattr(br, "cooldown", 0.1)
    monkeypatch.setenv("KUBEML_CHAOS_CLIENT", "1.0")
    for _ in range(br.threshold):
        with pytest.raises(http.TransportError):
            http.post(f"{url}/echo/down", json={}, timeout=5)
    assert br.state == "open"
    monkeypatch.setenv("KUBEML_CHAOS_CLIENT", "0")
    with pytest.raises(resilience.CircuitOpenError):
        http.get(f"{url}/echo/ping", timeout=5)
    time.sleep(0.12)
    r = http.get(f"{url}/echo/ping", timeout=5)  # the half-open probe
    assert r.status_code == 200 and br.state == "closed"


def test_unexpected_send_exception_settles_the_breaker(monkeypatch):
    """An exception that is not a TransportError still records a failure:
    a half-open probe that neither succeeds nor fails would wedge the
    destination."""
    def boom(*a, **k):
        raise ValueError("mid-body drop")

    monkeypatch.setattr(http, "send", boom)
    br = resilience.CircuitBreaker(threshold=1, cooldown=30.0, dest="d")
    monkeypatch.setitem(resilience._breakers, "127.0.0.1:9", br)
    br.record_failure()
    br._opened_at -= 60  # the cooldown has passed
    with pytest.raises(ValueError):
        resilience.resilient_request("GET", "http://127.0.0.1:9/x",
                                     retryable=False, timeout=1)
    assert br.state == "open"
    br._opened_at -= 60
    assert br.allow()


def test_http_statuses_do_not_feed_the_breaker(service):
    url, state = service
    br = resilience.get_breaker(resilience.destination(url))
    for _ in range(br.threshold + 2):
        r = http.post(f"{url}/flaky/notanumber", json={}, timeout=5)
        assert r.status_code == 500
    for _ in range(br.threshold + 2):
        r = http.post(f"{url}/flaky/100", json={}, timeout=5)
        assert r.status_code == 503
    assert br.state == "closed"


def test_use_breaker_false_bypasses_the_breaker():
    for _ in range(8):
        with pytest.raises(http.TransportError):
            http.get("http://127.0.0.1:9/x", timeout=0.5, use_breaker=False)
    assert resilience.get_breaker("127.0.0.1:9").state == "closed"


def test_concurrent_duplicate_keyed_post_executes_once(service):
    url, state = service
    results = []

    def send():
        r = http.post(f"{url}/slow/racekey", json={}, timeout=10,
                      idempotency_key="race-1")
        results.append(r.json())

    t1 = threading.Thread(target=send)
    t2 = threading.Thread(target=send)
    t1.start()
    time.sleep(0.1)
    t2.start()
    t1.join(30)
    t2.join(30)
    assert len(results) == 2 and results[0] == results[1]
    assert state["calls"]["racekey"] == 1


def test_registries_and_counter_labels_are_bounded():
    for i in range(resilience.MAX_DESTINATIONS + 10):
        resilience.get_breaker(f"h:{i}")
        resilience.get_budget(f"h:{i}")
    assert len(resilience._breakers) <= resilience.MAX_DESTINATIONS
    assert len(resilience._budgets) <= resilience.MAX_DESTINATIONS
    for i in range(resilience.MAX_LABELS_PER_METRIC + 10):
        resilience.incr("kubeml_http_retries_total", f"d{i}")
    labels = [k for k in resilience.counters_snapshot()
              if k[0] == "kubeml_http_retries_total"]
    assert len(labels) <= resilience.MAX_LABELS_PER_METRIC
    assert resilience.counter_value(
        "kubeml_http_retries_total",
        f"d{resilience.MAX_LABELS_PER_METRIC + 9}") == 1


# --- deadlines ---


def test_deadline_header_round_trip():
    d = time.time() + 3.5
    assert resilience.parse_deadline(
        resilience.format_deadline(d)) == pytest.approx(d)
    for bad in (None, "", "garbage", "-5"):
        assert resilience.parse_deadline(bad) is None


def test_clamp_timeout_caps_read_not_connect():
    assert resilience.clamp_timeout(10.0, 2.0) == 2.0
    assert resilience.clamp_timeout((3.0, 10.0), 2.0) == (3.0, 2.0)
    assert resilience.clamp_timeout(None, 2.0) == 2.0
    assert resilience.clamp_timeout(1.0, 5.0) == 1.0
    assert resilience.read_timeout((1.0, 4.0)) == 4.0
    d = resilience.deadline_from_timeout((1.0, 4.0))
    assert time.time() + 3 < d <= time.time() + 4


def test_server_rejects_expired_deadline_with_504(service):
    url, state = service
    r = http.request("POST", f"{url}/echo/dead", json={}, timeout=5,
                     headers={resilience.DEADLINE_HEADER:
                              str(time.time() - 1)})
    assert r.status_code == 504 and "dead" not in state["calls"]
    assert resilience.counter_value("kubeml_http_deadline_rejected_total",
                                    "resilience-test") >= 1


def test_bound_deadline_propagates_and_binds_downstream(service):
    url, state = service
    d = time.time() + 30
    with resilience.bind_deadline(d):
        http.get(f"{url}/echo/p", timeout=5)
    sent = state["headers"]["p"].get(resilience.DEADLINE_HEADER)
    assert sent is not None and float(sent) == pytest.approx(d)


def test_origin_stamps_deadline_from_timeout(service):
    url, state = service
    before = time.time()
    http.get(f"{url}/echo/q", timeout=7)
    sent = float(state["headers"]["q"][resilience.DEADLINE_HEADER])
    assert before + 6 < sent < time.time() + 8


def test_expired_bound_deadline_fails_before_sending(service):
    url, state = service
    with resilience.bind_deadline(time.time() - 1):
        with pytest.raises(resilience.DeadlineExpiredError) as e:
            http.get(f"{url}/echo/never", timeout=5)
    assert "never" not in state["calls"] and e.value.status_code == 504


def test_origin_read_timeout_still_retries(monkeypatch):
    """At the origin a read timeout does not use up the retries: each
    attempt stamps a fresh deadline instead of gating the loop (the port
    once made now + read timeout the whole chain's budget)."""
    calls = {"n": 0, "deadlines": []}

    def always_timeout(method, url, *, headers, timeout=None, **kw):
        calls["n"] += 1
        calls["deadlines"].append(float(headers[resilience.DEADLINE_HEADER]))
        raise http.TransportError("read timed out", 504)

    monkeypatch.setattr(http, "send", always_timeout)
    with pytest.raises(http.TransportError):
        http.get("http://127.0.0.1:9/x", timeout=0.2)
    assert calls["n"] == 3
    assert calls["deadlines"] == sorted(calls["deadlines"])


def test_origin_read_timeout_retries_against_a_live_server(service):
    url, state = service
    r = http.get(f"{url}/slowonce", timeout=(3.05, 0.3))
    assert r.status_code == 200 and r.json()["calls"] == 2
    assert resilience.counter_value("kubeml_http_retries_total",
                                    resilience.destination(url)) == 1


def test_bound_deadline_gates_the_retries(service):
    url, state = service
    t0 = time.monotonic()
    with resilience.bind_deadline(time.time() + 0.5):
        r = http.get(f"{url}/flaky/1000", timeout=5)
    assert r.status_code == 503 and time.monotonic() - t0 < 3.0


# --- chaos ---


def test_chaos_seeded_determinism():
    a = resilience.ChaosConfig(server_p=0.5, seed=42)
    b = resilience.ChaosConfig(server_p=0.5, seed=42)
    fa = [a.server_fault("/x") for _ in range(50)]
    assert fa == [b.server_fault("/x") for _ in range(50)]
    assert any(f is not None for f in fa) and any(f is None for f in fa)


def test_chaos_route_scoping_and_exemptions():
    c = resilience.ChaosConfig(server_p=1.0, routes="^/train", modes="error")
    assert c.server_fault("/train")[0] == "error"
    assert c.server_fault("/generate") is None
    c2 = resilience.ChaosConfig(server_p=1.0, modes="error")
    assert c2.server_fault("/health") is None
    assert c2.server_fault("/metrics") is None
    assert c2.client_fault("http://h:1/health") is False


def test_chaos_server_error_mode(service, monkeypatch):
    url, state = service
    monkeypatch.setenv("KUBEML_CHAOS", "1.0")
    monkeypatch.setenv("KUBEML_CHAOS_MODES", "error")
    r = http.post(f"{url}/echo/x", json={}, timeout=5)
    assert r.status_code == 500 and "chaos" in r.json()["error"]
    assert "x" not in state["calls"]  # injected before dispatch
    assert resilience.counter_value("kubeml_chaos_injected_total",
                                    "error") >= 1
    assert http.get(f"{url}/health", timeout=5).status_code == 200


def test_chaos_server_reset_mode_then_retry_recovers(service, monkeypatch):
    url, state = service
    monkeypatch.setenv("KUBEML_CHAOS", "1.0")
    monkeypatch.setenv("KUBEML_CHAOS_MODES", "reset")
    with pytest.raises(http.TransportError):
        http.post(f"{url}/echo/y", json={}, timeout=5)
    assert "y" not in state["calls"]
    monkeypatch.setenv("KUBEML_CHAOS", "0.4")
    monkeypatch.setenv("KUBEML_CHAOS_SEED", "3")
    r = http.get(f"{url}/echo/z", timeout=5)
    assert r.status_code == 200


def test_chaos_client_injection(service, monkeypatch):
    url, state = service
    monkeypatch.setenv("KUBEML_CHAOS_CLIENT", "1.0")
    with pytest.raises(http.TransportError):
        http.post(f"{url}/echo/c", json={}, timeout=5)
    assert "c" not in state["calls"]
    assert resilience.counter_value("kubeml_chaos_injected_total",
                                    "client") >= 1


# --- ReplayCache, envelopes, metrics, knobs ---


def test_replay_cache_ttl_and_bound():
    rc = resilience.ReplayCache(max_entries=2, ttl=0.05)
    rc.put("POST", "/a", "k", "ra")
    assert rc.get("POST", "/a", "k") == "ra"
    assert rc.get("POST", "/a", "other") is None
    time.sleep(0.06)
    assert rc.get("POST", "/a", "k") is None
    rc.put("POST", "/a", "1", "r1")
    rc.put("POST", "/a", "2", "r2")
    rc.put("POST", "/a", "3", "r3")
    assert rc.get("POST", "/a", "1") is None
    assert rc.get("POST", "/a", "3") == "r3"


def test_retry_after_survives_the_envelope_across_hops():
    from kubeml_tpu_torch.api.errors import error_from_envelope

    e = OverloadedError("queue full", retry_after=12.0)
    rebuilt = error_from_envelope(e.to_json(), 429)
    assert isinstance(rebuilt, OverloadedError)
    assert rebuilt.retry_after == 12.0
    assert error_from_envelope(rebuilt.to_json(), 429).retry_after == 12.0


def test_metrics_render_includes_resilience_series():
    from kubeml_tpu_torch.ps.metrics import MetricsRegistry

    resilience.incr("kubeml_http_retries_total", "h:1")
    resilience.get_breaker("h:1")
    text = MetricsRegistry().render()
    assert 'kubeml_http_retries_total{dest="h:1"} 1' in text
    assert 'kubeml_http_breaker_state{dest="h:1"} 0' in text
    assert "kubeml_serving_requests_overload_total" in text
    assert "kubeml_serving_deadline_expired_total" in text


def test_update_timeout_knob_and_timeouts_helper(monkeypatch):
    from kubeml_tpu_torch.api.config import Config

    monkeypatch.setenv("KUBEML_UPDATE_TIMEOUT", "7.5")
    assert Config().update_timeout == 7.5
    t = http.timeouts(30)
    assert isinstance(t, tuple) and t[1] == 30 and 0 < t[0] < 30
    assert http.timeouts(10, connect=2.0) == (2.0, 10)


# --- parity with the JAX package ---


def test_chaos_fault_sequence_equals_jax_route_by_route():
    kw = dict(server_p=0.3, client_p=0.2, routes="^/(train|update|job)",
              max_delay=0.05, seed=1234)
    ours, theirs = resilience.ChaosConfig(**kw), jres.ChaosConfig(**kw)
    routes = ["/train", "/update/j1", "/job", "/generate", "/health",
              "/metrics", "/train", "/jobs/x"] * 40
    got, want = [], []
    for i, path in enumerate(routes):
        got.append(ours.server_fault(path))
        want.append(theirs.server_fault(path))
        if i % 3 == 0:
            got.append(ours.client_fault(f"http://h:1{path}"))
            want.append(theirs.client_fault(f"http://h:1{path}"))
    assert got == want
    assert {f[0] for f in got if isinstance(f, tuple)} == {
        "delay", "error", "reset"}
    assert True in got
    for mode in ("delay", "error", "reset", "client"):
        assert (resilience.counter_value("kubeml_chaos_injected_total", mode)
                == jres.counter_value("kubeml_chaos_injected_total", mode))


def test_chaos_from_env_equals_jax(monkeypatch):
    for k, v in (("KUBEML_CHAOS", "0.1"), ("KUBEML_CHAOS_CLIENT", "0.05"),
                 ("KUBEML_CHAOS_SEED", "99"), ("KUBEML_CHAOS_DELAY", "0.05"),
                 ("KUBEML_CHAOS_MODES", "reset,delay,bogus")):
        monkeypatch.setenv(k, v)
    ours, theirs = resilience.chaos(), jres.chaos()
    assert (ours.server_p, ours.client_p, ours.modes, ours.max_delay) == (
        theirs.server_p, theirs.client_p, theirs.modes, theirs.max_delay)
    assert ([ours.server_fault("/x") for _ in range(200)]
            == [theirs.server_fault("/x") for _ in range(200)])
    monkeypatch.setenv("KUBEML_CHAOS_SEED", "100")
    assert resilience.chaos() is not ours  # rebuilt on a new fingerprint


def test_retry_delays_equal_jax_under_one_seed():
    kw = dict(attempts=6, backoff=0.05, backoff_max=0.7)
    ours, theirs = resilience.RetryPolicy(**kw), jres.RetryPolicy(**kw)
    a, b = random.Random(5), random.Random(5)
    assert ([ours.delay(i % 6, a) for i in range(40)]
            == [theirs.delay(i % 6, b) for i in range(40)])


def test_scripted_breaker_states_equal_jax(monkeypatch):
    clock = {"t": 1000.0}
    monkeypatch.setattr(time, "monotonic", lambda: clock["t"])
    ours = resilience.CircuitBreaker(threshold=3, cooldown=5.0, dest="d")
    theirs = jres.CircuitBreaker(threshold=3, cooldown=5.0, dest="d")
    script = ["fail", "fail", "ok", "fail", "fail", "fail", "allow",
              "tick", "allow", "allow", "fail", "allow", "tick", "allow",
              "ok", "allow", "fail", "fail", "fail", "tick", "allow", "ok"]
    trace = []
    for step in script:
        row = []
        for br in (ours, theirs):
            if step == "fail":
                br.record_failure()
                row.append(None)
            elif step == "ok":
                br.record_success()
                row.append(None)
            elif step == "allow":
                row.append(br.allow())
        if step == "tick":
            clock["t"] += 6.0
        assert row[:1] == row[1:2], step
        assert ours.state == theirs.state, step
        assert ours.state_value == theirs.state_value
        trace.append(ours.state)
    assert {"closed", "open", "half-open"} <= set(trace)


def test_render_metrics_equal_jax():
    for mod in (resilience, jres):
        mod.incr("kubeml_http_retries_total", "h:1", 3)
        mod.incr("kubeml_chaos_injected_total", "reset")
        mod.incr("kubeml_http_deadline_rejected_total", 'ps "x"')
        mod.incr("kubeml_http_sent_bytes_total", "/train", 120)
        mod.get_breaker("h:1").record_failure()
        mod.get_breaker("h:2")
    assert resilience.render_metrics() == jres.render_metrics()


# the (method, path) of each client call, with the flags JAX passes
CLIENT_CALLS = [
    ("ctl", "train"), ("ctl", "infer"), ("ctl", "generate"),
    ("ctl", "generate_stream"), ("ctl", "create"), ("ctl", "create_text"),
    ("ctl", "tokenizer"), ("ctl", "fn_create"), ("ctl", "preempt"),
    ("ctl", "quantize"), ("ctl", "stop"), ("ps", "start_task"),
    ("ps", "update_task"), ("ps", "infer"), ("ps", "stop_task"),
    ("ps", "preempt_task"), ("ps", "jobs_snapshot"), ("ps", "drain_serving"),
    ("sched", "submit_train"), ("sched", "infer"), ("sched", "generate"),
    ("sched", "generate_stream"), ("sched", "update_job"),
    ("sched", "job_preempted"), ("sched", "jobs_snapshot")]


class _FakeResponse:
    status_code = 200
    content = b"{}"
    headers = {}

    def json(self):
        return {"id": "j", "predictions": [], "tokens": [[1]],
                "lengths": [1], "pruned": 0}

    def iter_lines(self):
        return iter(())

    def close(self):
        pass


def _drive(kind, call, pkg):
    """Make one client call of ``pkg`` ("jax" or "port")."""
    if pkg == "jax":
        from kubeml_tpu.api.types import (GenerateRequest, TrainRequest,
                                          TrainTask)
        from kubeml_tpu.controller.client import KubemlClient
        from kubeml_tpu.ps.transport import PSClient
        from kubeml_tpu.scheduler.transport import SchedulerClient
    else:
        from kubeml_tpu_torch.api.types import (GenerateRequest,
                                                TrainRequest, TrainTask)
        from kubeml_tpu_torch.controller.client import KubemlClient
        from kubeml_tpu_torch.ps.transport import PSClient
        from kubeml_tpu_torch.scheduler.transport import SchedulerClient
    url = "http://h:1"
    task = TrainTask(job_id="j", parameters=TrainRequest(function_name="f",
                                                         dataset="d"))
    if kind == "ctl":
        c = KubemlClient(url)
        return {
            "train": lambda: c.networks().train(task.parameters),
            "infer": lambda: c.networks().infer("j", [[1.0]]),
            "generate": lambda: c.networks().generate("j", [[1, 2]]),
            "generate_stream": lambda: c.networks().generate(
                "j", [[1, 2]], stream=True),
            "create": lambda: c.datasets().create("d", np.zeros(2),
                                                  np.zeros(2), np.zeros(1),
                                                  np.zeros(1)),
            "create_text": lambda: c.datasets().create_text(
                "d", "a b", seq_len=4, train_bpe=300),
            "tokenizer": lambda: c.datasets().tokenizer("d"),
            "fn_create": lambda: c.functions().create("f", "x = 1"),
            "preempt": lambda: c.tasks().preempt("j"),
            "quantize": lambda: c.checkpoints().quantize("j"),
            "stop": lambda: c.tasks().stop("j"),
        }[call]()
    if kind == "ps":
        c = PSClient(url)
        return {
            "start_task": lambda: c.start_task(task),
            "update_task": lambda: c.update_task("j", 2),
            "infer": lambda: c.infer("j", [[1.0]]),
            "stop_task": lambda: c.stop_task("j"),
            "preempt_task": lambda: c.preempt_task("j"),
            "jobs_snapshot": lambda: c.jobs_snapshot(),
            "drain_serving": lambda: c.drain_serving(),
        }[call]()
    c = SchedulerClient(url)
    gen = GenerateRequest(model_id="j", prompts=[[1, 2]])
    sgen = GenerateRequest(model_id="j", prompts=[[1, 2]], stream=True)
    return {
        "submit_train": lambda: c.submit_train(task.parameters),
        "infer": lambda: c.infer("j", [[1.0]]),
        "generate": lambda: c.generate(gen),
        "generate_stream": lambda: c.generate(sgen),
        "update_job": lambda: c.update_job(task),
        "job_preempted": lambda: c.job_preempted(task),
        "jobs_snapshot": lambda: c.jobs_snapshot(),
    }[call]()


def test_client_calls_carry_the_flags_of_their_jax_twins(monkeypatch):
    from kubeml_tpu.utils import traced_http

    seen = {"jax": [], "port": []}

    def recorder(pkg):
        def request(method, url, *, retryable=None, idempotency_key=None,
                    use_breaker=True, **kw):
            seen[pkg].append((method, url.split("?")[0], retryable,
                              bool(idempotency_key), use_breaker,
                              bool(kw.get("stream"))))
            return _FakeResponse()
        return request

    monkeypatch.setattr(traced_http, "request", recorder("jax"))
    monkeypatch.setattr(http, "request", recorder("port"))
    for kind, call in CLIENT_CALLS:
        for pkg in ("jax", "port"):
            _drive(kind, call, pkg)
        assert seen["port"][-1] == seen["jax"][-1], (kind, call)
    assert len(seen["port"]) == len(CLIENT_CALLS)
    retried = [s for s in seen["port"] if s[2] or s[3] or s[0] != "POST"]
    assert len(retried) == len(CLIENT_CALLS)  # every call may retry


# --- acceptance: a K-AVG job under 10 % chaos on every hop ---

LENET_FN = """
from kubeml_tpu_torch.data.dataset import KubeDataset
from kubeml_tpu_torch.models.lenet import LeNet
from kubeml_tpu_torch.runtime.model import KubeModel


class Model(KubeModel):
    def __init__(self):
        super().__init__(KubeDataset("blobs"))

    def build(self):
        return LeNet(num_classes=10, in_shape=(16, 16, 1))
"""

CHAOS_ENV = {"KUBEML_CHAOS": "0.1", "KUBEML_CHAOS_CLIENT": "0.05",
             "KUBEML_CHAOS_SEED": "1234", "KUBEML_CHAOS_DELAY": "0.05",
             "KUBEML_RETRY_ATTEMPTS": "5", "KUBEML_RETRY_BUDGET": "10",
             "KUBEML_BREAKER_THRESHOLD": "100"}


@pytest.fixture
def chaos_cluster(tmp_path, monkeypatch):
    from kubeml_tpu_torch.api.config import Config, get_config, set_config
    from kubeml_tpu_torch.cluster import LocalCluster

    for k, v in CHAOS_ENV.items():
        monkeypatch.setenv(k, v)
    cfg = Config(data_root=Path(tmp_path / "kubeml"), controller_port=0,
                 scheduler_port=0, ps_port=0, storage_port=0)
    saved = get_config()
    set_config(cfg)  # the retry and breaker knobs are read from it
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with LocalCluster(config=cfg, device="cpu") as c:
            yield c
    finally:
        torch.set_num_threads(threads)
        set_config(saved)


@pytest.mark.chaos
def test_train_completes_under_injected_network_faults(chaos_cluster):
    from kubeml_tpu_torch.api.types import TrainOptions, TrainRequest
    from kubeml_tpu_torch.controller import KubemlClient

    client = KubemlClient(chaos_cluster.controller_url)
    r = np.random.default_rng(0)
    y = r.integers(0, 10, size=256)
    x = r.standard_normal((256, 16, 16, 1)).astype(np.float32)
    x[np.arange(256), y, :, 0] += 2.0
    client.datasets().create("blobs", x, y, x[:64], y[:64])
    client.functions().create("ctiny", LENET_FN)
    req = TrainRequest(
        model_type="ctiny", batch_size=16, epochs=2, dataset="blobs",
        lr=0.05, function_name="ctiny",
        options=TrainOptions(default_parallelism=2, k=2,
                             static_parallelism=True, precision="f32"))
    job_id = client.networks().train(req)
    deadline = time.monotonic() + WAIT
    hist = None
    while time.monotonic() < deadline:  # the job's history, not the tasks
        try:
            hist = client.histories().get(job_id)
            break
        except KubeMLError as e:
            if e.status_code != 404:
                raise
            time.sleep(0.2)
    assert hist is not None, f"job {job_id} did not finish within {WAIT} s"
    assert len(hist.train_loss) == 2, hist.to_dict()
    assert all(np.isfinite(v) for v in hist.train_loss)
    assert "error" not in (hist.task or {})
    metrics = http.get(f"{chaos_cluster.ps_api.url}/metrics",
                       timeout=10).text
    assert "kubeml_chaos_injected_total{" in metrics
    assert "kubeml_http_retries_total{" in metrics
    snap = resilience.counters_snapshot()
    assert sum(v for (m, _), v in snap.items()
               if m == "kubeml_chaos_injected_total") > 0
    assert sum(v for (m, _), v in snap.items()
               if m == "kubeml_http_retries_total") > 0

"""The port's span tracer (``kubeml_tpu_torch/utils/tracing.py``) against
the JAX package's ``kubeml_tpu/utils/tracing.py``, on the CPU.

The cases of JAX ``tests/test_tracing_failures.py`` (the tracer, W3C
trace context, nesting, two processes, the device profile, here a
``torch.profiler`` trace of CPU activity) run on the port's tracer; and on
the same inputs the two packages agree exactly: ``parse_traceparent``
over one corpus of valid and malformed headers, ``merge_chrome_trace`` and
``Tracer.summary`` over the same span dicts.
"""

import json
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from kubeml_tpu.utils import tracing as jtracing
from kubeml_tpu_torch.utils import tracing
from kubeml_tpu_torch.utils.tracing import Tracer

REPO = Path(__file__).resolve().parent.parent


# --- the tracer ---


def test_tracer_disabled_records_nothing():
    t = Tracer()
    with t.span("x") as s:
        assert s is None
    t.record("y", 1.0)
    assert t.add_span("z", 0.0, 1.0) is None
    assert t.spans() == []


def test_tracer_spans_and_summary():
    t = Tracer(enabled=True)
    with t.span("outer", job="j1"):
        with t.span("inner"):
            pass
        with t.span("inner"):
            pass
    assert len(t.spans()) == 3
    assert len(t.spans("inner")) == 2
    s = t.summary()
    assert s["inner"]["count"] == 2
    assert s["outer"]["count"] == 1
    assert s["outer"]["max_s"] >= s["inner"]["max_s"]
    assert t.spans("outer")[0].attrs == {"job": "j1"}


def test_tracer_record_external_duration():
    t = Tracer(enabled=True)
    t.record("device_step", 0.25, round=3)
    (s,) = t.spans()
    assert s.duration == 0.25 and s.attrs["round"] == 3


def test_tracer_chrome_export_and_flush(tmp_path):
    t = Tracer(enabled=True)
    with t.span("epoch", epoch=0):
        pass
    path = t.flush(tmp_path / "trace.json")
    data = json.loads(path.read_text())
    (ev,) = data["traceEvents"]
    assert ev["name"] == "epoch" and ev["ph"] == "X"
    assert ev["dur"] >= 0 and ev["args"] == {"epoch": 0}
    assert Tracer(enabled=True).flush(tmp_path / "empty.json") is None


def test_tracer_thread_safety():
    t = Tracer(enabled=True)

    def worker():
        for _ in range(200):
            with t.span("w"):
                pass

    threads = [threading.Thread(target=worker) for _ in range(8)]
    [x.start() for x in threads]
    [x.join() for x in threads]
    assert len(t.spans()) == 1600


def test_tracer_concurrent_nesting_stays_per_thread():
    """The context stack is per thread: each thread's inner spans parent
    under its own outer span."""
    t = Tracer(enabled=True)

    def worker(i):
        for _ in range(50):
            with t.span(f"outer{i}"):
                with t.span(f"inner{i}"):
                    pass

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    [x.start() for x in threads]
    [x.join() for x in threads]
    by_id = {s.span_id: s for s in t.spans()}
    for s in t.spans():
        if s.name.startswith("inner"):
            parent = by_id[s.parent_id]
            assert parent.name == f"outer{s.name[len('inner'):]}"
            assert parent.trace_id == s.trace_id
        else:
            assert s.parent_id is None


def test_tracer_max_spans_is_a_ring(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SPANS", 5)
    t = Tracer(enabled=True)
    for i in range(9):
        t.record(f"s{i}", 0.01)
    assert len(t.spans()) == 5
    assert t.dropped == 4
    assert [s.name for s in t.spans()] == ["s4", "s5", "s6", "s7", "s8"]
    t.clear()
    assert t.dropped == 0 and t.spans() == []


def test_add_span_names_its_identity_and_task_spans():
    t = Tracer(enabled=True, service="svc")
    with t.span("hop") as hop:
        pass
    req = t.add_span("serving.request", 10.0, 2.0, trace_id=hop.trace_id,
                     parent_id=hop.span_id, job="r1")
    child = t.add_span("serving.decode", 11.0, -1.0, trace_id=req.trace_id,
                       parent_id=req.span_id, job="r1")
    t.record("elsewhere", 0.1)
    assert child.duration == 0.0 and req.service == "svc"
    # the task's spans: those tagged job=r1 and their trace's other spans
    assert sorted(s.name for s in t.task_spans("r1")) == [
        "hop", "serving.decode", "serving.request"]
    d = t.task_dicts("r1")[0]
    assert set(d) == {"name", "start", "duration", "thread", "attrs",
                      "trace_id", "span_id", "parent_id", "service", "pid"}


# --- trace identity and propagation ---

# valid and malformed traceparent headers, held to JAX's decoding
TRACEPARENTS = [
    None, "", "garbage", "00-zz-xx-01",
    "00-" + "a" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "A" * 32 + "-" + "B" * 16 + "-01",
    "  00-" + "a" * 32 + "-" + "b" * 16 + "-00  ",
    "01-" + "c" * 32 + "-" + "d" * 16 + "-01",
    "00-" + "0" * 32 + "-" + "1" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "0" * 16 + "-01",
    "ff-" + "a" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "a" * 31 + "-" + "b" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "b" * 17 + "-01",
    "00-" + "a" * 32 + "-" + "b" * 16,
    "00_" + "a" * 32 + "_" + "b" * 16 + "_01",
    "00-" + "g" * 32 + "-" + "b" * 16 + "-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
]


@pytest.mark.parametrize("header", TRACEPARENTS)
def test_parse_traceparent_equals_jax(header):
    got = tracing.parse_traceparent(header)
    want = jtracing.parse_traceparent(header)
    if want is None:
        assert got is None
    else:
        assert (got.trace_id, got.span_id) == (want.trace_id, want.span_id)
        assert got.traceparent() == want.traceparent()


def test_traceparent_round_trip():
    ctx = tracing.TraceContext(tracing.new_trace_id(), tracing.new_span_id())
    header = ctx.traceparent()
    assert header == f"00-{ctx.trace_id}-{ctx.span_id}-01"
    assert tracing.parse_traceparent(header) == ctx


def test_span_identity_nesting_and_inbound_context():
    t = Tracer(enabled=True, service="svc")
    with t.span("root") as root:
        with t.span("child") as child:
            pass
    assert root.trace_id == child.trace_id
    assert child.parent_id == root.span_id and root.parent_id is None
    ctx = tracing.TraceContext(tracing.new_trace_id(), tracing.new_span_id())
    with tracing.use_context(ctx):
        assert tracing.current_context() == ctx
        hdrs = tracing.trace_headers({"X-Other": "1"})
        assert hdrs["traceparent"] == ctx.traceparent()
        assert hdrs["X-Other"] == "1"
        # the caller's own header wins
        assert tracing.trace_headers({"traceparent": "mine"}) == {
            "traceparent": "mine"}
        with t.span("served") as s:
            pass
    assert s.trace_id == ctx.trace_id and s.parent_id == ctx.span_id
    assert tracing.current_context() is None
    assert tracing.trace_headers() == {}
    with tracing.use_context(None):
        assert tracing.current_context() is None


def test_bind_task_and_log_filter():
    import logging

    rec = logging.LogRecord("x", logging.INFO, __file__, 1, "m", (), None)
    f = tracing.TraceLogFilter()
    assert f.filter(rec) and (rec.trace_id, rec.task_id) == ("-", "-")
    ctx = tracing.TraceContext("ab" * 16, "cd" * 8)
    with tracing.use_context(ctx), tracing.bind_task("job-1"):
        assert tracing.current_task() == "job-1"
        f.filter(rec)
    assert (rec.trace_id, rec.task_id) == ("ab" * 16, "job-1")
    assert tracing.current_task() is None
    logger = logging.getLogger("kubeml.test.tracing")
    handler = logging.StreamHandler()
    logger.addHandler(handler)
    try:
        tracing.add_log_context(logger)
        tracing.add_log_context(logger)
        assert sum(isinstance(x, tracing.TraceLogFilter)
                   for x in handler.filters) == 1
    finally:
        logger.removeHandler(handler)


def test_two_process_propagation():
    """A child process handed a traceparent records spans under the
    parent's trace id and span; the merged trace has one row a service."""
    t = Tracer(enabled=True, service="parent")
    child_script = (
        "import json, sys\n"
        "from kubeml_tpu_torch.utils import tracing\n"
        "t = tracing.Tracer(enabled=True, service='child')\n"
        "ctx = tracing.parse_traceparent(sys.argv[1])\n"
        "with tracing.use_context(ctx):\n"
        "    with t.span('child.work', job='j1'):\n"
        "        pass\n"
        "print(json.dumps([s.to_dict() for s in t.spans()]))\n"
        "sys.exit(1 if 'torch' in sys.modules else 0)\n")
    with t.span("parent.request", job="j1") as parent_span:
        header = tracing.current_context().traceparent()
        out = subprocess.run([sys.executable, "-c", child_script, header],
                             capture_output=True, text=True, timeout=120,
                             cwd=REPO)
    # the tracer imports no torch (the CLI's client commands use it)
    assert out.returncode == 0, out.stderr
    (child,) = json.loads(out.stdout)
    assert child["trace_id"] == parent_span.trace_id
    assert child["parent_id"] == parent_span.span_id
    assert child["service"] == "child"
    assert child["pid"] != parent_span.to_dict()["pid"]
    merged = tracing.merge_chrome_trace([parent_span.to_dict(), child])
    rows = [e["args"]["name"] for e in merged["traceEvents"]
            if e["ph"] == "M"]
    assert rows == ["parent", "child"]


# --- held to JAX on the same span dicts ---


def _spans(seed: int, n: int = 40):
    """Span dicts from a seed: several services (one missing, so its pid
    names the row), nested parents, attributes of every JSON kind."""
    rng = np.random.default_rng(seed)
    services = ["controller", "ps", "worker", "worker-1", ""]
    out = []
    for i in range(n):
        parent = out[int(rng.integers(0, i))]["span_id"] if i else None
        out.append({
            "name": f"phase{int(rng.integers(0, 6))}",
            "start": float(1.7e9 + rng.uniform(0, 100)),
            "duration": float(rng.uniform(0, 3)),
            "thread": int(rng.integers(1, 2 ** 40)),
            "attrs": {"job": "t1", "epoch": int(rng.integers(0, 4)),
                      "bytes": float(rng.integers(0, 1 << 20)),
                      "flag": bool(rng.integers(0, 2)), "note": None},
            "trace_id": "ab" * 16, "span_id": f"{i:016x}",
            "parent_id": parent,
            "service": services[int(rng.integers(0, len(services)))],
            "pid": int(rng.integers(100, 103))})
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_chrome_trace_equals_jax(seed):
    spans = _spans(seed)
    assert tracing.merge_chrome_trace(spans) == \
        jtracing.merge_chrome_trace(spans)


@pytest.mark.parametrize("seed", [0, 1])
def test_summary_and_chrome_export_equal_jax(seed):
    """The same spans recorded into each package's tracer give the same
    summary, and the same Chrome events but for the pid."""
    rng = np.random.default_rng(seed)
    records = [(f"s{int(rng.integers(0, 5))}", float(rng.uniform(0, 2)),
                {"round": int(rng.integers(0, 9))}) for _ in range(30)]
    ours, theirs = Tracer(enabled=True), jtracing.Tracer(enabled=True)
    for name, dur, attrs in records:
        ours.add_span(name, 100.0, dur, **attrs)
        theirs.add_span(name, 100.0, dur, **attrs)
    assert ours.summary() == theirs.summary()

    def events(t):
        return [{k: v for k, v in e.items() if k not in ("pid", "tid")}
                for e in t.to_chrome_trace()]

    assert events(ours) == events(theirs)


def test_process_tracer_from_the_environment(tmp_path, monkeypatch):
    monkeypatch.setattr(tracing, "_global", Tracer())
    monkeypatch.setattr(tracing, "_atexit_armed", True)
    monkeypatch.delenv("KUBEML_TRACE", raising=False)
    assert not tracing.get_tracer().enabled
    monkeypatch.setenv("KUBEML_TRACE", str(tmp_path))
    t = tracing.get_tracer()
    assert t.enabled and t.out_dir == tmp_path
    with t.span("x"):
        pass
    assert t.flush().name == f"kubeml-trace-{__import__('os').getpid()}.json"


# --- the device profile ---


def test_device_profile_writes_a_chrome_trace_of_cpu_activity(tmp_path):
    x = torch.ones(64, 64)
    with tracing.device_profile(tmp_path / "prof") as prof:
        (x @ x).sum()
    assert prof is not None
    (path,) = (tmp_path / "prof").glob("device-trace-*.json")
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("mm" in n for n in names), sorted(names)[:20]
    # a second trace into the same directory does not overwrite the first
    with tracing.device_profile(tmp_path / "prof"):
        x.sum()
    assert len(list((tmp_path / "prof").glob("device-trace-*.json"))) == 2


def test_device_profile_raises_on_a_profiler_failure(tmp_path, monkeypatch):
    import torch.profiler as tp

    class Broken:
        def __init__(self, *a, **kw):
            raise RuntimeError("no profiler backend")

    monkeypatch.setattr(tp, "profile", Broken)
    with pytest.raises(RuntimeError, match="no profiler backend"):
        with tracing.device_profile(tmp_path):
            pass

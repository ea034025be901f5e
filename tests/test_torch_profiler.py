"""The port's performance attribution (``kubeml_tpu_torch/utils/
profiler.py``), error hook (``utils/errorhook.py``), span collector
(``ps/traces.py``) and the HTTP byte counters of ``utils/http_client.py``
against the JAX package's, on the CPU.

The cases of JAX ``tests/test_profiler.py`` (accounting, ``record_io``
spans, the flight recorder, ``ProfileSession``, ``classify``,
``gap_attribution``, attribution, Perfetto counter tracks, the error
hook's payload, ``TraceStore``) run on the port; and on the same inputs
the two packages give equal ``attribution_report``,
``perfetto_with_counters`` and ``TraceStore`` contents, equal per-route
byte counters for the same calls, and error-hook payloads with the same
keys. ``classify`` takes the H100's peaks on a card named so.
"""

import http.server
import json
import threading
import time

import numpy as np
import pytest

from kubeml_tpu.ps.traces import TraceStore as JTraceStore
from kubeml_tpu.utils import profiler as jprofiler
from kubeml_tpu.utils import resilience as jresilience
from kubeml_tpu.utils import traced_http
from kubeml_tpu.utils import tracing as jtracing
from kubeml_tpu_torch.ps.traces import TraceStore
from kubeml_tpu_torch.utils import http_client, profiler, resilience, tracing
from kubeml_tpu_torch.utils.httpd import Response, Router, Service


@pytest.fixture(autouse=True)
def _clean_accounting():
    for mod in (profiler, jprofiler):
        mod.reset_accounting()
        mod.get_recorder().clear()
    yield
    for mod in (profiler, jprofiler):
        mod.reset_accounting()
        mod.get_recorder().clear()


@pytest.fixture
def traced():
    """The port's process tracer, on and empty for the test."""
    tracer = tracing.get_tracer()
    tracer.clear()
    tracer.enable()
    try:
        yield tracer
    finally:
        tracer.disable()
        tracer.clear()


# --- byte accounting ---


def test_account_totals_and_bandwidth_histogram():
    profiler.account("stage_round", 1024)
    profiler.account("stage_round", 1024)
    profiler.account("weights.publish", 10_000, 0.5)
    text = "\n".join(profiler.render_metrics())
    assert 'kubeml_dataplane_bytes_total{phase="stage_round"} 2048' in text
    assert 'kubeml_dataplane_events_total{phase="stage_round"} 2' in text
    assert ('kubeml_staging_bandwidth_bytes_per_sec_bucket{phase='
            '"stage_round"') not in text
    assert ('kubeml_staging_bandwidth_bytes_per_sec_count{phase='
            '"weights.publish"} 1') in text
    # every event enters the flight recorder
    phases = [e["phase"] for e in profiler.get_recorder().tail()
              if e.get("kind") == "dataplane"]
    assert phases == ["stage_round", "stage_round", "weights.publish"]


def test_record_io_spans_carry_byte_attributes(traced):
    profiler.record_io("weights.publish", 4096, 0.25, flops=8.0, version=3)
    (span,) = traced.spans("weights.publish")
    assert span.attrs["bytes"] == 4096
    assert span.attrs["bandwidth_bps"] == pytest.approx(16384.0)
    assert span.attrs["flops"] == 8.0 and span.attrs["version"] == 3
    assert span.duration == pytest.approx(0.25)
    # untraced: the counters only
    traced.disable()
    profiler.record_io("weights.publish", 4096, 0.25)
    assert len(traced.spans("weights.publish")) == 1
    assert profiler.counters_snapshot()["dataplane"]["weights.publish"][
        "events"] == 2


def test_tree_nbytes():
    tree = {"a": np.zeros((4, 4), np.float32),
            "b": [np.zeros(3, np.int8), {"c": np.zeros(2, np.float64)}]}
    assert profiler.tree_nbytes(tree) == 64 + 3 + 16


def test_data_plane_seams_account_as_jax(tmp_path):
    """A dataset read (``ShardStore.load_subset_range``) accounts its
    bytes under ``dataset.read`` as JAX's store does; a sharded save and
    restore record ``ckpt.save`` and ``ckpt.restore`` with their bytes
    (JAX's seams), as spans when tracing is on."""
    from kubeml_tpu.storage.store import ShardStore as JShardStore
    from kubeml_tpu_torch.storage.sharded_checkpoint import \
        ShardedCheckpointStore
    from kubeml_tpu_torch.storage.store import ShardStore

    rng = np.random.default_rng(0)
    x = rng.standard_normal((200, 4, 4, 1)).astype(np.float32)
    y = rng.integers(0, 10, 200)
    for mod, store in ((profiler, ShardStore(root=tmp_path / "port")),
                       (jprofiler, JShardStore(root=tmp_path / "jax"))):
        store.create("d", x, y, x[:64], y[:64])
        store.get("d").load_subset_range("train", 1, 3)
    assert profiler.counters_snapshot()["dataplane"]["dataset.read"] == \
        jprofiler.counters_snapshot()["dataplane"]["dataset.read"]
    tracer = tracing.get_tracer()
    tracer.clear()
    tracer.enable()
    try:
        ck = ShardedCheckpointStore(root=tmp_path / "ckpt")
        tree = {"params": {"w": np.ones((8, 4), np.float32)}}
        ck.save("j", tree, epoch=0, tag="ep00000")
        ck.restore("j", "ep00000")
        spans = {s.name: s.attrs for s in tracer.spans()}
    finally:
        tracer.disable()
        tracer.clear()
    assert spans["ckpt.save"]["bytes"] == spans["ckpt.restore"]["bytes"] \
        == 128
    assert spans["ckpt.save"]["job"] == "j"
    phases = profiler.counters_snapshot()["dataplane"]
    assert phases["ckpt.save"]["bytes"] == phases["ckpt.restore"][
        "bytes"] == 128


# --- the HTTP byte counters, per route ---


def _echo_service():
    router = Router("bytes-test")
    router.route("POST", "/echo", lambda req: {"got": len(req.body or b"")})
    router.route("GET", "/update/{id}", lambda req: {"id": req.params["id"]})
    router.route("GET", "/blob", lambda req: Response(b"x" * 777,
                                                      content_type="a/b"))
    return Service(router, "127.0.0.1", 0).start()


CALLS = [("POST", "/echo", {"pad": "x" * 100}), ("GET", "/update/job-17",
                                                 None),
         ("GET", "/update/job-18", None), ("POST", "/echo", {"n": [1, 2]}),
         ("GET", "/blob", None), ("GET", "/", None)]
METRICS = ("kubeml_http_sent_bytes_total", "kubeml_http_received_bytes_total")
ROUTES = ("/echo", "/update", "/blob", "/")


def _counters(mod):
    return {(m, r): mod.counter_value(m, r) for m in METRICS for r in ROUTES}


def test_route_label_equals_jax():
    for url in ("http://h:1/update/job-17", "http://h:1/", "http://h:1",
                "http://h:1/a/b/c?x=1", "http://h:1//tasks//x"):
        assert http_client.route_label(url) == traced_http.route_label(url)


def test_http_byte_counters_per_route_equal_jax():
    svc = _echo_service()
    try:
        deltas = []
        for call, mod in ((lambda m, u, j: http_client.request(
                m, u, json=j, timeout=5), resilience),
                          (lambda m, u, j: traced_http.request(
                              m, u, json=j, timeout=5), jresilience)):
            before = _counters(mod)
            for method, path, body in CALLS:
                resp = call(method, f"{svc.url}{path}", body)
                assert resp.status_code in (200, 404)
            after = _counters(mod)
            deltas.append({k: after[k] - before[k] for k in after})
        ours, theirs = deltas
        assert ours == theirs
        assert ours[("kubeml_http_sent_bytes_total", "/echo")] >= 100
        assert ours[("kubeml_http_received_bytes_total", "/blob")] == 777
        # a streamed answer counts its Content-Length, its body unread
        before = resilience.counter_value(METRICS[1], "/blob")
        resp = http_client.get(f"{svc.url}/blob", stream=True, timeout=5)
        assert resilience.counter_value(METRICS[1], "/blob") - before == 777
        assert len(resp.content) == 777
    finally:
        svc.stop()


# --- profiling sessions and classification ---


def test_profile_session_report_classifies_phases():
    s = profiler.ProfileSession("bench")
    with s:
        with s.phase("stage", nbytes=1_000_000):
            time.sleep(0.01)
        with s.phase("mixed", bytes=10, flops=5.0, tag="t") as ph:
            ph.bytes += 90
    s.note_phase("compute", 2.0, flops=4e12)
    rep = s.report()
    rows = {r["phase"]: r for r in rep["phases"]}
    assert rows["stage"]["bound"] == "transfer-bound"
    assert rows["stage"]["bandwidth_bps"] > 0
    assert rows["compute"]["bound"] == "compute-bound"
    assert rows["compute"]["flops_per_sec"] == pytest.approx(2e12)
    assert rows["mixed"]["bytes"] == 100 and rows["mixed"]["flops"] == 5.0
    assert sum(r["share"] for r in rep["phases"]) == pytest.approx(1.0)
    assert "device_trace_dir" not in rep


def test_profile_session_phase_spans_carry_final_totals(traced):
    s = profiler.ProfileSession("sess")
    with s.phase("load", bytes=5) as ph:
        ph.bytes += 5
    (span,) = traced.spans("sess.load")
    assert span.attrs["bytes"] == 10.0


def test_profile_session_device_trace_of_cpu_activity(tmp_path):
    import torch

    s = profiler.ProfileSession("dev", device_trace_dir=tmp_path / "dt")
    with s:
        with s.phase("mm"):
            torch.ones(32, 32) @ torch.ones(32, 32)
    rep = s.report()
    assert rep["device_trace_dir"] == str(tmp_path / "dt")
    assert "device_trace_error" not in rep
    (path,) = (tmp_path / "dt").glob("device-trace-*.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def test_profile_session_keeps_a_device_trace_error(tmp_path, monkeypatch):
    import torch.profiler as tp

    class Broken:
        def __init__(self, *a, **kw):
            raise RuntimeError("no CUPTI")

    monkeypatch.setattr(tp, "profile", Broken)
    s = profiler.ProfileSession("dev", device_trace_dir=tmp_path / "dt")
    with s:
        with s.phase("p"):
            pass
    rep = s.report()
    assert rep["device_trace_error"] == "no CUPTI"
    assert [r["phase"] for r in rep["phases"]] == ["p"]


def test_profile_session_dump_appends_jsonl(tmp_path):
    s = profiler.ProfileSession("d")
    s.note_phase("a", 1.0, nbytes=10)
    out = tmp_path / "prof.jsonl"
    s.dump(out, gap={"x": 1})
    s.dump(out)
    rows = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert len(rows) == 2 and rows[0]["session"] == "d"
    assert rows[0]["gap"] == {"x": 1} and "ts" in rows[1]


def test_gap_attribution_equals_jax():
    for args in ((32791.3, 14810.5, 8192, 12_582_912, 3e12),
                 (100.0, 100.0, 10, 0, None), (0, 0, 0, 0, None)):
        assert profiler.gap_attribution(*args) == \
            jprofiler.gap_attribution(*args)
    g = profiler.gap_attribution(32791.3, 14810.5, 8192, 12_582_912)
    assert g["staging_share"] == pytest.approx(0.548, abs=0.01)


def test_classify_roofline_terms_on_the_cpu():
    assert profiler.device_peaks() == (None, None)
    for nbytes, flops in ((0, 0), (1e9, 0), (0, 1e9), (1e9, 1e11),
                          (1e9, 1e10), (1.0, 99.0)):
        assert profiler.classify(nbytes, flops) == \
            jprofiler.classify(nbytes, flops)


def test_classify_takes_the_h100_peaks(monkeypatch):
    monkeypatch.setattr(profiler, "_card_name",
                        lambda: "nvidia h100 80gb hbm3")
    assert profiler.device_peaks() == (989e12, 3.35e12)
    # 100 FLOP a byte: compute-bound by the CPU's rule, but on an H100
    # the bytes take longer (295 FLOP a byte is its balance point)
    assert profiler.classify(1e9, 1e11) == "transfer-bound"
    assert profiler.classify(1e9, 3e11) == "compute-bound"
    monkeypatch.setenv("KUBEML_PEAK_FLOPS", "100")
    monkeypatch.setenv("KUBEML_HBM_BW", "1000")
    assert profiler.device_peaks() == (100e12, 1000e9)
    assert profiler.classify(1e9, 1e11) == "compute-bound"


# --- the flight recorder ---


def test_flight_recorder_ring_is_bounded_and_dumps(tmp_path):
    rec = profiler.FlightRecorder(capacity=4)
    for i in range(10):
        rec.note({"kind": "dataplane", "phase": f"p{i}", "bytes": i})
    tail = rec.tail(10)
    assert len(tail) == 4
    assert tail[-1]["phase"] == "p9" and tail[0]["phase"] == "p6"
    with tracing.bind_task("job-9"):
        path = rec.dump("test", out_dir=tmp_path)
    record = json.loads(path.read_text())
    assert record["reason"] == "test" and record["task_id"] == "job-9"
    assert [e["phase"] for e in record["events"]] == ["p6", "p7", "p8", "p9"]
    assert "counters" in record and "http_counters" in record


def test_flight_recorder_off_and_without_a_dir(monkeypatch):
    monkeypatch.delenv("KUBEML_FLIGHT_DIR", raising=False)
    assert profiler.FlightRecorder(capacity=2).dump("nope") is None
    off = profiler.FlightRecorder(capacity=0)
    off.note({"kind": "x"})
    assert off.tail() == []


def test_flight_recorder_receives_tracer_spans(traced):
    rec = profiler.get_recorder()
    with traced.span("job.round", job="j-fr", bytes=123):
        pass
    spans = [e for e in rec.tail() if e.get("kind") == "span"]
    assert spans and spans[-1]["name"] == "job.round"
    assert spans[-1]["bytes"] == 123 and spans[-1]["job"] == "j-fr"
    assert spans[-1]["trace_id"]


# --- the error hook ---


class _Hook:
    """A local webhook receiver: the JSON bodies it was posted."""

    def __init__(self):
        got = self.got = []

        class H(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                got.append(json.loads(
                    self.rfile.read(int(self.headers["Content-Length"]))))
                self.send_response(200)
                self.end_headers()

            def log_message(self, *a):
                pass

        self.srv = http.server.HTTPServer(("127.0.0.1", 0), H)
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.srv.server_address[1]}/hook"

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()


def test_errorhook_payload_carries_the_flight_tail(tmp_path, monkeypatch):
    from kubeml_tpu_torch.utils.errorhook import report_error

    hook = _Hook()
    try:
        profiler.account("weights.publish", 999, 0.1)
        monkeypatch.setenv("KUBEML_ERROR_WEBHOOK", hook.url)
        monkeypatch.setenv("KUBEML_FLIGHT_DIR", str(tmp_path / "flight"))
        with tracing.use_context(tracing.TraceContext("ab" * 16, "cd" * 8)), \
                tracing.bind_task("job-7"):
            report_error("job-failure", "boom", wait=True, job_id="job-7")
        (payload,) = hook.got
        assert payload["trace_id"] == "ab" * 16
        assert payload["task_id"] == "job-7" and payload["error"] == "boom"
        phases = [e.get("phase") for e in payload["flight_recorder"]]
        assert "weights.publish" in phases
        (dump,) = (tmp_path / "flight").glob("flight-*.json")
        assert json.loads(dump.read_text())["reason"] == \
            "errorhook:job-failure"
        assert payload["flight_dump"] == str(dump)
        # fire-and-forget by default
        report_error("job-start-failure", "later")
        deadline = time.monotonic() + 10
        while len(hook.got) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert hook.got[1]["context"] == "job-start-failure"
    finally:
        hook.close()


def test_errorhook_without_a_webhook_still_dumps(tmp_path, monkeypatch):
    from kubeml_tpu_torch.utils.errorhook import report_error

    monkeypatch.delenv("KUBEML_ERROR_WEBHOOK", raising=False)
    monkeypatch.setenv("KUBEML_FLIGHT_DIR", str(tmp_path))
    report_error("job-failure", "boom")
    assert len(list(tmp_path.glob("flight-*.json"))) == 1


def test_errorhook_payload_keys_equal_jax(tmp_path, monkeypatch):
    from kubeml_tpu.utils.errorhook import report_error as jreport
    from kubeml_tpu_torch.utils.errorhook import report_error

    hook = _Hook()
    try:
        monkeypatch.setenv("KUBEML_ERROR_WEBHOOK", hook.url)
        monkeypatch.setenv("KUBEML_FLIGHT_DIR", str(tmp_path))
        profiler.account("ckpt.save", 10, 0.1)
        jprofiler.account("ckpt.save", 10, 0.1)
        with tracing.use_context(tracing.TraceContext("ab" * 16, "cd" * 8)), \
                tracing.bind_task("j1"):
            report_error("job-failure", "boom", wait=True, job_id="j1")
        with jtracing.use_context(jtracing.TraceContext("ab" * 16,
                                                        "cd" * 8)), \
                jtracing.bind_task("j1"):
            jreport("job-failure", "boom", wait=True, job_id="j1")
        ours, theirs = hook.got
        assert set(ours) == set(theirs)
        for key in ("source", "context", "error", "job_id", "trace_id",
                    "task_id"):
            assert ours[key] == theirs[key], key
        assert [set(e) for e in ours["flight_recorder"]] == \
            [set(e) for e in theirs["flight_recorder"]]
    finally:
        hook.close()


# --- span-tree attribution (`kubeml profile`) ---


def _span(name, start, dur, service="worker", **attrs):
    return {"name": name, "start": start, "duration": dur, "thread": 1,
            "attrs": attrs, "trace_id": "t" * 32, "span_id": name[:16],
            "service": service, "pid": 1}


def _random_spans(seed: int, n: int = 60):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        attrs = {}
        if rng.uniform() < 0.6:
            attrs["bytes"] = float(rng.integers(0, 1 << 24))
        if rng.uniform() < 0.4:
            attrs["flops"] = float(rng.uniform(0, 1e12))
        if rng.uniform() < 0.05:
            attrs["bytes"] = "not-a-number"
        out.append(_span(f"phase{int(rng.integers(0, 7))}",
                         float(rng.uniform(0, 50)), float(rng.uniform(0, 5)),
                         service=["worker", "ps", "worker-1"][i % 3],
                         **attrs))
    out.append("not-a-dict")
    return out


def test_attribution_report_aggregates_bytes_and_flops():
    spans = [_span("job.round", 1.0, 0.5, bytes=1000, flops=5e9),
             _span("job.round", 2.0, 0.5, bytes=1000, flops=5e9),
             _span("weights.publish", 3.0, 0.1, bytes=500),
             _span("scheduler POST /job", 3.5, 0.01)]
    rep = profiler.attribution_report(
        spans, counters={"worker": {"dataplane": {}}})
    rows = {r["phase"]: r for r in rep["phases"]}
    assert rows["job.round"]["bytes"] == 2000
    assert rows["job.round"]["flops"] == 1e10
    assert rows["job.round"]["count"] == 2
    assert rows["weights.publish"]["bound"] == "transfer-bound"
    assert rows["scheduler POST /job"]["bound"] == "host"
    assert rep["total_bytes"] == 2500
    assert rep["counters"]["worker"] == {"dataplane": {}}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_attribution_and_perfetto_equal_jax(seed):
    spans = _random_spans(seed)
    counters = {"worker": {"dataplane": {"x": {"bytes": 1.0}}}}
    assert profiler.attribution_report(spans, counters) == \
        jprofiler.attribution_report(spans, counters)
    dicts = [s for s in spans if isinstance(s, dict)]
    assert profiler.perfetto_with_counters(dicts) == \
        jprofiler.perfetto_with_counters(dicts)


def test_perfetto_export_emits_counter_tracks():
    spans = [_span("job.round", 1.0, 0.5, bytes=1000),
             _span("job.round", 2.0, 0.5, bytes=3000)]
    trace = profiler.perfetto_with_counters(spans)
    counters = [e for e in trace["traceEvents"] if e["ph"] == "C"]
    byte_track = [e for e in counters
                  if e["name"] == "dataplane_bytes_total"]
    assert [e["args"]["bytes"] for e in byte_track] == [1000.0, 4000.0]
    bw_track = [e for e in counters
                if e["name"] == "transfer_bandwidth_MBps/worker"]
    assert bw_track and bw_track[0]["args"]["MBps"] == pytest.approx(0.002)
    names = {e["args"]["name"] for e in trace["traceEvents"]
             if e["ph"] == "M"}
    assert "dataplane" in names
    assert profiler.perfetto_with_counters([])["traceEvents"] == []


def test_perfetto_cumulative_track_is_monotonic_under_overlap():
    spans = [_span("a", 0.0, 10.0, bytes=1_000_000),
             _span("b", 1.0, 1.0, bytes=2_000_000)]
    trace = profiler.perfetto_with_counters(spans)
    values = [e["args"]["bytes"] for e in sorted(
        (e for e in trace["traceEvents"]
         if e["ph"] == "C" and e["name"] == "dataplane_bytes_total"),
        key=lambda e: e["ts"])]
    assert values == sorted(values) and values[-1] == 3_000_000.0


# --- the span collector ---


def _store_ops(store):
    """One sequence of adds over the caps; the store's contents after."""
    store.add("a", [{"span_id": str(i)} for i in range(5)])
    store.add_counters("a", "worker", {"dataplane": {"x": {"bytes": 1.0}}})
    store.add_counters("a", "ps", {"dataplane": {}})
    store.add("b", [{"span_id": "b0"}, "not-a-dict"])
    store.add_counters("z", "w", "not-a-dict")
    store.add("c", [{"span_id": "c0"}])
    store.add_counters("d", "worker", {"n": 1})
    store.add("a", [{"span_id": "a-again"}])
    store.clear("c")
    return {t: (store.get(t), store.get_counters(t), store.dropped(t))
            for t in "abcdz"}


def test_trace_store_equals_jax():
    assert _store_ops(TraceStore(max_tasks=2, max_spans_per_task=3)) == \
        _store_ops(JTraceStore(max_tasks=2, max_spans_per_task=3))


def test_trace_store_bounds_and_eviction():
    ts = TraceStore(max_tasks=2, max_spans_per_task=3)
    assert ts.add("a", [{"span_id": str(i)} for i in range(5)]) == 3
    assert len(ts.get("a")) == 3 and ts.dropped("a") == 2
    ts.add_counters("a", "worker", {"dataplane": {}})
    ts.add("b", [{"span_id": "b0"}])
    ts.add("c", [{"span_id": "c0"}])  # evicts the oldest task, "a"
    assert ts.get("a") == [] and ts.get_counters("a") == {}
    assert ts.dropped("a") == 0
    ts.add("a", ["not-a-dict"])
    assert ts.get("a") == []

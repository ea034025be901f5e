"""The port's distributed tracing end to end on the CPU, against the JAX
package's (``tests/test_observability.py``).

* one train request crossing CLI -> controller -> scheduler -> PS -> job
  leaves one trace: one ``trace_id``, one root (``cli.train``), no
  dangling parent, every ``job.epoch`` under ``ps.job.run``; the merged
  Chrome trace has a process row per service; ``/metrics`` has the job's
  latency histograms;
* the same request in a JAX ``LocalCluster`` and in a port one gives the
  same tree of (name, service, parent's name);
* ``kubeml trace`` writes the Chrome file and ``kubeml profile`` the
  per-phase report; an unknown task is a 404;
* a standalone runner (another process) posts its spans, which stitch
  under the request's trace;
* a served request's spans are complete for each outcome: completed,
  failed, timeout, canceled.
"""

import collections
import json
import os
import time

import pytest
import torch

from kubeml_tpu_torch.api.config import Config
from kubeml_tpu_torch.api.errors import KubeMLError
from kubeml_tpu_torch.api.types import (GenerateRequest, TrainOptions,
                                        TrainRequest)
from kubeml_tpu_torch.cluster import LocalCluster
from kubeml_tpu_torch.controller import KubemlClient
from kubeml_tpu_torch.utils import tracing
from test_torch_standalone import JAX_TINY_FN, TINY_FN, blobs

WAIT = 120.0
PORTS = dict(controller_port=0, scheduler_port=0, ps_port=0, storage_port=0)
JOB = "obsjob"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def traced():
    """The port's process tracer, on and empty, as a cluster's."""
    tracer = tracing.get_tracer()
    tracer.clear()
    tracer.enable()
    service = tracer.service
    tracer.service = "kubeml"
    try:
        yield tracer
    finally:
        tracer.disable()
        tracer.clear()
        tracer.service = service


def train_request(options, job_id=JOB, epochs=2):
    return options["request"](
        function_name="tiny", dataset="blobs", epochs=epochs, batch_size=16,
        lr=0.05, job_id=job_id, options=options["options"](
            default_parallelism=2, static_parallelism=True, k=2,
            checkpoint_every=1, precision="f32"))


def train_traced(client, tracer, types, fn, job_id=JOB):
    """One train request under the CLI's root span, waited on until the
    task list no longer holds it; returns the job id."""
    x, y = blobs(256, 0)
    client.datasets().create("blobs", x, y, x[:64], y[:64])
    client.functions().create("tiny", fn)
    with tracer.span("cli.train", service="cli"):
        jid = client.networks().train(train_request(types, job_id))
    deadline = time.monotonic() + WAIT
    while time.monotonic() < deadline:
        try:
            client.histories().get(jid)
        except Exception as e:  # either package's KubeMLError
            assert getattr(e, "status_code", None) == 404, e
        else:
            if all(t.job_id != jid for t in client.tasks().list()):
                return jid
        time.sleep(0.1)
    raise AssertionError(f"job {jid} did not finish within {WAIT} s")


PORT_TYPES = dict(request=TrainRequest, options=TrainOptions)


@pytest.fixture(scope="module")
def port_trace(tmp_path_factory):
    """A port cluster with its tracer on, after one traced train request:
    (cluster, client, job id, the task's trace)."""
    tracer = tracing.get_tracer()
    tracer.clear()
    tracer.enable()
    tracer.service = "kubeml"
    root = tmp_path_factory.mktemp("obs") / "kubeml"
    try:
        with LocalCluster(config=Config(data_root=root, **PORTS),
                          device="cpu") as cluster:
            client = KubemlClient(cluster.controller_url)
            jid = train_traced(client, tracer, PORT_TYPES, TINY_FN)
            yield cluster, client, jid, client.tasks().trace(jid)
    finally:
        tracer.disable()
        tracer.clear()


def tree(spans):
    """The multiset of (name, service, parent's name) of a trace."""
    by_id = {s["span_id"]: s for s in spans}
    return collections.Counter(
        (s["name"], s["service"],
         by_id[s["parent_id"]]["name"] if s["parent_id"] in by_id
         else s["parent_id"]) for s in spans)


def check_stitched(spans, trace_ids):
    """One trace id, one root (``cli.train``), no dangling parent."""
    assert len(trace_ids) == 1
    assert all(s["trace_id"] == trace_ids[0] for s in spans)
    ids = {s["span_id"] for s in spans}
    roots = [s for s in spans if not s["parent_id"]]
    assert [r["name"] for r in roots] == ["cli.train"]
    assert all(s["parent_id"] in ids for s in spans if s["parent_id"])


def test_ps_trace_merge_dedupes_span_ids(tmp_path, traced):
    """``get_trace`` merges posted spans with this process's own and
    keeps one of each ``span_id``."""
    from kubeml_tpu_torch.ps.parameter_server import ParameterServer

    ps = ParameterServer(config=Config(data_root=tmp_path / "k"),
                         device="cpu")
    with traced.span("job.epoch", job="tj", epoch=0):
        pass
    local = traced.task_dicts("tj")
    ps.post_trace("tj", local + [{
        "name": "runner.extra", "start": 1.0, "duration": 0.1,
        "thread": 1, "attrs": {"job": "tj"},
        "trace_id": local[0]["trace_id"], "span_id": "feedbeeffeedbeef",
        "parent_id": local[0]["span_id"], "service": "worker", "pid": 1}],
        counters={"phases": {}}, service="worker")
    trace = ps.get_trace("tj")
    assert trace["task_id"] == "tj"
    assert sorted(s["name"] for s in trace["spans"]) == ["job.epoch",
                                                         "runner.extra"]
    assert trace["trace_ids"] == [local[0]["trace_id"]]
    assert set(trace["counters"]) == {"worker", "kubeml"}


def test_train_request_yields_one_stitched_trace(port_trace):
    cluster, _, jid, trace = port_trace
    spans = trace["spans"]
    assert {"cli", "controller", "scheduler", "ps", "worker"} <= {
        s["service"] for s in spans}
    check_stitched(spans, trace["trace_ids"])
    by_id = {s["span_id"]: s for s in spans}
    epochs = [s for s in spans if s["name"] == "job.epoch"]
    assert len(epochs) == 2
    assert all(by_id[s["parent_id"]]["name"] == "ps.job.run"
               for s in epochs)
    chrome = tracing.merge_chrome_trace(spans)
    rows = {e["args"]["name"] for e in chrome["traceEvents"]
            if e["ph"] == "M"}
    assert {"cli", "controller", "scheduler", "ps", "worker"} <= rows
    from kubeml_tpu_torch.utils import http_client

    text = http_client.get(f"{cluster.ps_api.url}/metrics", timeout=10).text
    for metric in ("kubeml_job_epoch_seconds", "kubeml_job_round_seconds",
                   "kubeml_job_merge_seconds"):
        assert f"# TYPE {metric} histogram" in text
        assert f'{metric}_bucket{{jobid="{jid}",le="+Inf"}}' in text
    assert f'kubeml_job_epoch_seconds_count{{jobid="{jid}"}} 2' in text


def test_span_tree_equals_jax(port_trace, tmp_path):
    """The same train request through a JAX ``LocalCluster``: the same
    tree of (name, service, parent's name)."""
    from kubeml_tpu.api.config import Config as JConfig
    from kubeml_tpu.api.types import TrainOptions as JOptions
    from kubeml_tpu.api.types import TrainRequest as JRequest
    from kubeml_tpu.cluster import LocalCluster as JCluster
    from kubeml_tpu.controller.client import KubemlClient as JClient
    from kubeml_tpu.utils import tracing as jtracing

    tracer = jtracing.get_tracer()
    tracer.clear()
    tracer.enable()
    tracer.service = "kubeml"
    try:
        with JCluster(config=JConfig(data_root=tmp_path / "jax",
                                     compile_cache="0", tsdb_enable=False,
                                     **PORTS)) as jc:
            client = JClient(jc.controller.url)
            jid = train_traced(client, tracer, dict(
                request=JRequest, options=JOptions), JAX_TINY_FN)
            want = client.tasks().trace(jid)
    finally:
        tracer.disable()
        tracer.clear()
    got = port_trace[3]
    assert tree(got["spans"]) == tree(want["spans"])
    assert tree(got["spans"])[("job.round", "worker", "job.epoch")] == 4


def test_cli_trace_and_profile(port_trace, tmp_path, capsys):
    from kubeml_tpu_torch.cli import main

    cluster, _, jid, _ = port_trace
    url = ["--url", cluster.controller_url]
    out = tmp_path / "trace.json"
    assert main([*url, "trace", jid, "-o", str(out)]) == 0
    events = json.loads(out.read_text())["traceEvents"]
    rows = {e["args"]["name"] for e in events if e["ph"] == "M"}
    assert {"cli", "controller", "scheduler", "ps", "worker"} <= rows
    xs = [e for e in events if e["ph"] == "X"]
    assert len({e["args"]["trace_id"] for e in xs}) == 1
    assert "spans from" in capsys.readouterr().out
    perfetto = tmp_path / "profile.json"
    assert main([*url, "profile", jid, "-o", str(perfetto)]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["task_id"] == jid and len(report["trace_ids"]) == 1
    phases = {r["phase"]: r for r in report["phases"]}
    assert phases["job.checkpoint"]["bytes"] > 0
    assert phases["job.round"]["bytes"] > 0 and phases["job.round"][
        "count"] == 4
    assert "kubeml" in report["counters"]
    counters = [e for e in json.loads(perfetto.read_text())["traceEvents"]
                if e["ph"] == "C"]
    assert counters


def test_trace_of_an_unknown_task_is_404(port_trace):
    _, client, _, _ = port_trace
    with pytest.raises(KubeMLError) as err:
        client.tasks().trace("nope1234")
    assert err.value.status_code == 404


def test_a_runner_process_posts_spans_that_stitch(tmp_path, traced,
                                                  monkeypatch):
    """A standalone runner traces with ``KUBEML_TRACE`` (inherited from
    the PS) and posts its spans at the job's end: they carry its pid and
    stitch under the request's root."""
    monkeypatch.setenv("KUBEML_TRACE", str(tmp_path / "runner-traces"))
    cfg = Config(data_root=tmp_path / "kubeml", standalone_jobs=True,
                 **PORTS)
    with LocalCluster(config=cfg, device="cpu") as cluster:
        client = KubemlClient(cluster.controller_url)
        jid = train_traced(client, traced, PORT_TYPES, TINY_FN,
                           job_id="runnerjob")
        trace = client.tasks().trace(jid)
    spans = trace["spans"]
    check_stitched(spans, trace["trace_ids"])
    worker = [s for s in spans if s["service"] == "worker"]
    assert worker and all(s["pid"] != os.getpid() for s in worker)
    assert len({s["pid"] for s in worker}) == 1
    names = {s["name"] for s in worker}
    assert {"job.epoch", "runner.publish_weights"} <= names
    assert "worker" in trace["counters"]


@pytest.mark.parametrize("parked", [True, False])
def test_a_preempted_jobs_requeue_continues_its_trace(tmp_path, traced,
                                                     parked):
    """A preempted job resubmitted with ``resume=True`` (parked first
    when a preemption controller runs) is scheduled under its task's
    ``traceparent``: the resumed job's spans stay in its trace."""
    from kubeml_tpu_torch.api.types import JobState, TrainTask

    cfg = Config(data_root=tmp_path / "kubeml", preempt_monitor=parked,
                 **PORTS)
    parent = tracing.TraceContext(tracing.new_trace_id(),
                                  tracing.new_span_id())
    with LocalCluster(config=cfg, device="cpu") as cluster:
        sched = cluster.scheduler
        seen = []
        submit = sched.submit_train

        def recording(req):
            seen.append((req.job_id, req.options.resume,
                         tracing.current_context()))
            return submit(req)

        sched.submit_train = recording
        sched.stop()  # nothing pops the queue: the requeue stays queued
        task = TrainTask(job_id="pjob", state=JobState(),
                         parameters=train_request(PORT_TYPES, "pjob"),
                         trace_parent=parent.traceparent())
        sched.job_preempted(task)
        if parked:
            assert cluster.preemption.parked_ids() == ["pjob"]
            assert cluster.preemption.requeue_parked() == 1
        (job_id, resume, ctx), = seen
        assert (job_id, resume) == ("pjob", True)
        assert (ctx.trace_id, ctx.span_id) == (parent.trace_id,
                                               parent.span_id)
        queued = sched.queue.pop(timeout=1.0)
        assert queued.job_id == "pjob"
        assert queued.trace_parent == parent.traceparent()


# --- serving spans ------------------------------------------------------


def tiny_decoder(**kw):
    from kubeml_tpu_torch.models.gpt import CausalTransformer
    from kubeml_tpu_torch.serving.batcher import BatchingDecoder

    model = CausalTransformer(vocab_size=61, max_len=64, embed_dim=32,
                              depth=2, num_heads=2, seed=0, device="cpu")
    return BatchingDecoder(model, slots=2, chunk_steps=2, device="cpu", **kw)


def serving_spans(tracer, request_id):
    spans = tracer.task_dicts(request_id)
    by_name = collections.defaultdict(list)
    for s in spans:
        by_name[s["name"]].append(s)
    (req,) = by_name["serving.request"]
    for name, group in by_name.items():
        if name != "serving.request":
            assert all(s["parent_id"] == req["span_id"]
                       and s["trace_id"] == req["trace_id"] for s in group)
    return req, {n: len(g) for n, g in by_name.items()}


def test_served_request_spans_for_each_outcome(traced):
    """Each outcome leaves one ``serving.request`` span with its outcome
    and the children its timeline reached, under the submitter's
    context."""
    prompt = [[1, 2, 3, 4]]
    parent = tracing.TraceContext(tracing.new_trace_id(),
                                  tracing.new_span_id())
    dec = tiny_decoder()
    try:
        with tracing.use_context(parent):
            done = dec.wait(dec.submit(GenerateRequest(
                prompts=prompt, max_new_tokens=6)), timeout=300)
        req, names = serving_spans(traced, done["request_id"])
        assert req["attrs"]["outcome"] == "completed"
        assert req["attrs"]["tokens"] == 6
        assert (req["trace_id"], req["parent_id"]) == (parent.trace_id,
                                                      parent.span_id)
        assert names == {"serving.request": 1, "serving.queue_wait": 1,
                         "serving.prefill": 1, "serving.decode": 1}

        slow = dec.submit(GenerateRequest(prompts=prompt,
                                          max_new_tokens=48))
        with pytest.raises(KubeMLError) as e:
            dec.wait(slow, timeout=0.0)
        assert e.value.status_code == 504
        req, names = serving_spans(traced, slow.request_id)
        assert req["attrs"]["outcome"] == "timeout"
        assert names["serving.request"] == 1

        with dec._cond:  # held: the request stays queued
            queued = dec.submit(GenerateRequest(prompts=prompt,
                                                max_new_tokens=4))
        dec.cancel(queued)
        req, names = serving_spans(traced, queued.request_id)
        assert req["attrs"]["outcome"] == "canceled"
        assert names["serving.request"] == 1
    finally:
        dec.close()

    dec = tiny_decoder()
    real = dec._decode_chunk

    def faulty(size):
        raise RuntimeError("injected")

    dec._decode_chunk = faulty
    try:
        entry = dec.submit(GenerateRequest(prompts=prompt,
                                           max_new_tokens=12))
        with pytest.raises(KubeMLError):
            dec.wait(entry, timeout=300)
        req, names = serving_spans(traced, entry.request_id)
        assert req["attrs"]["outcome"] == "failed"
        assert names["serving.request"] == 1
    finally:
        dec._decode_chunk = real
        dec.close()
    # one serving.request a request, whatever its outcome
    assert sum(s.name == "serving.request" for s in traced.spans()) == 4


def test_served_request_spans_off_cost_nothing():
    """With the tracer off a served request records no span."""
    tracer = tracing.get_tracer()
    tracer.disable()
    tracer.clear()
    dec = tiny_decoder()
    try:
        dec.wait(dec.submit(GenerateRequest(prompts=[[1, 2, 3]],
                                            max_new_tokens=3)), timeout=300)
    finally:
        dec.close()
    assert tracer.spans() == []

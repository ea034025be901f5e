"""The port's HTTP surface against the JAX package's, on the CPU.

A JAX ``LocalCluster`` and a port ``LocalCluster(device="cpu")``, every
service on port 0, serve one tiny-GPT ``final`` checkpoint (the JAX
suite's tiny config from ``tests/torch_port_helpers.py``, written once and
copied into both data roots, each with a function of the same name
written against its own package). The same request list goes to both
controllers and both parameter servers: ``/health``, ``/generate``
one-shot and streamed, ``/infer``, listings, unknown ids (404), bad
bodies (400), wrong methods (405), the PS's job routes,
``/serving/restored`` and ``/serving/drain``. Held equal: the status
codes, the JSON bodies (error envelopes byte for byte, ``created_at``
taken out) and the greedy tokens. The trace routes (``/tasks/{id}/
trace``, ``/traces/{id}``) answer an unknown task as JAX's do. The port
answers a live job's ``/generate`` and the routes of its unported modules
(``/slo``, ``/metrics/history``) with a 400 that names them, where the
JAX package serves them.
"""

import pytest
import torch

from kubeml_tpu.api.config import Config as JConfig
from kubeml_tpu.cluster import LocalCluster as JCluster
from kubeml_tpu.storage.checkpoint import CheckpointStore as JStore
from kubeml_tpu_torch.api.config import Config
from kubeml_tpu_torch.api.types import TrainTask
from kubeml_tpu_torch.cluster import LocalCluster
from kubeml_tpu_torch.ps.parameter_server import _JobRecord
from kubeml_tpu_torch.utils import http_client as http
from torch_port_helpers import VOCAB, jax_init, jax_tiny, numpy_tree

JOB = "tinylm"
SERVE = dict(serving_slots=2, serving_chunk_steps=4, serving_page_tokens=4)
PORTS = dict(controller_port=0, scheduler_port=0, ps_port=0, storage_port=0)

PORT_FN = """
from kubeml_tpu_torch.data.dataset import KubeDataset
from kubeml_tpu_torch.models.gpt import CausalTransformer
from kubeml_tpu_torch.runtime.model import KubeModel

class Model(KubeModel):
    def __init__(self):
        super().__init__(KubeDataset("tokens"))
    def build(self):
        return CausalTransformer(vocab_size=%d, max_len=48, embed_dim=32,
                                 depth=2, num_heads=2, device="cpu")
""" % VOCAB

JAX_FN = """
import optax
from kubeml_tpu.data.dataset import KubeDataset
from kubeml_tpu.models.gpt import CausalTransformer
from kubeml_tpu.runtime.model import KubeModel

class Model(KubeModel):
    def __init__(self):
        super().__init__(KubeDataset("tokens"))
    def build(self):
        return CausalTransformer(vocab_size=%d, max_len=48, embed_dim=32,
                                 depth=2, num_heads=2)
    def configure_optimizers(self):
        return optax.sgd(self.lr)
""" % VOCAB


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("routes")
    jroot, proot = tmp / "jax", tmp / "port"
    weights = numpy_tree(jax_init(jax_tiny()))
    JStore(root=jroot / "checkpoints").save(
        JOB, weights, epoch=1, tag="final",
        meta={"request": {"function_name": "lmfn"}})
    (proot / "checkpoints" / JOB).mkdir(parents=True)
    (proot / "checkpoints" / JOB / "final.npz").write_bytes(
        (jroot / "checkpoints" / JOB / "final.npz").read_bytes())
    jcfg = JConfig(data_root=jroot, paged_attn="gather",
                   int8_matmul_impl="dot", compile_cache="0",
                   tsdb_enable=False, **SERVE, **PORTS)
    pcfg = Config(data_root=proot, **SERVE, **PORTS)
    jc = JCluster(config=jcfg).start()
    pc = LocalCluster(config=pcfg, device="cpu").start()
    try:
        jc.registry.create("lmfn", JAX_FN)
        pc.registry.create("lmfn", PORT_FN)
        yield jc, pc
    finally:
        pc.stop()
        jc.stop()


def call(base, method, path, body=None, raw=None):
    """(status, parsed JSON body or text) of one request."""
    r = http.request(method, base + path, json=body, data=raw,
                     timeout=(5, 120))
    try:
        out = r.json()
    except ValueError:
        out = r.text
    return r.status_code, out


def both(clusters, method, path, body=None, raw=None, ps=False):
    jc, pc = clusters
    jurl = jc.ps_api.url if ps else jc.controller.url
    purl = pc.ps_api.url if ps else pc.controller_url
    return (call(jurl, method, path, body, raw),
            call(purl, method, path, body, raw))


def tokens(result):
    return [t[:n] for t, n in zip(result["tokens"], result["lengths"])]


def stream(base, body):
    r = http.post(base + "/generate", json={**body, "stream": True},
                  timeout=(5, 120), stream=True)
    assert r.status_code == 200
    return list(http.ndjson(r))


def without(d, *keys):
    if isinstance(d, list):
        return [without(x, *keys) for x in d]
    return {k: v for k, v in d.items() if k not in keys}


def test_health_listings_and_errors_match(clusters):
    cases = [
        ("GET", "/health", None, None, False),
        ("GET", "/health", None, None, True),
        ("GET", "/tasks", None, None, False),
        ("GET", "/jobs", None, None, False),
        ("GET", "/dataset", None, None, False),
        ("GET", "/history", None, None, False),
        ("GET", "/checkpoint", None, None, False),
        ("GET", f"/checkpoint/{JOB}", None, None, False),
        ("GET", "/tasks", None, None, True),
        ("GET", "/jobs?journal=0", None, None, True),
        ("GET", "/serving/restored", None, None, True),
        # unknown ids: 404
        ("GET", "/history/nosuch", None, None, False),
        ("GET", "/dataset/nosuch", None, None, False),
        ("DELETE", "/tasks/nosuch", None, None, False),
        ("POST", "/tasks/nosuch/preempt", {}, None, False),
        ("GET", "/checkpoint/nosuch/export", None, None, False),
        ("DELETE", "/checkpoint/nosuch", None, None, False),
        ("GET", "/function/nosuch", None, None, False),
        ("POST", "/generate", {"model_id": "nosuch", "prompts": [[1, 2]],
                               "max_new_tokens": 2}, None, False),
        ("POST", "/infer", {"model_id": "nosuch", "data": [[1]]}, None,
         False),
        ("POST", "/update/nosuch", {"parallelism": 2}, None, True),
        ("DELETE", "/stop/nosuch", None, None, True),
        ("POST", "/preempt/nosuch", {}, None, True),
        ("POST", "/finish/nosuch", {}, None, True),
        ("GET", "/nosuch/route", None, None, False),
        # bad bodies: 400
        ("POST", "/generate", {"model_id": JOB, "prompts": [[1]],
                               "max_new_tokens": 0}, None, False),
        ("POST", "/generate", {"model_id": JOB, "prompts": [[1]],
                               "temperature": 0.5}, None, False),
        ("POST", "/generate", {"model_id": JOB, "prompts": [[1]],
                               "top_k": True}, None, False),
        ("POST", "/train", None, b"{not json", False),
        ("POST", "/train", {"function_name": "lmfn", "dataset": "nosuch"},
         None, False),
        ("POST", "/train", {"function_name": "nosuch", "dataset": "x",
                            "options": {"k": 0}}, None, False),
        ("POST", "/tasks/x/preempt", {"grace": -1}, None, False),
        ("POST", "/dataset/d", None, b"plain", False),
        ("POST", "/function/f", None, b"", False),
        ("POST", "/serving/drain", {"grace": "soon"}, None, True),
        ("GET", f"/checkpoint/{JOB}/export?epoch=x", None, None, False),
        # wrong methods: 405
        ("GET", "/train", None, None, False),
        ("DELETE", "/generate", None, None, False),
        ("PUT", "/history", None, None, False),
        ("GET", "/start", None, None, True),
    ]
    for method, path, body, raw, ps in cases:
        (js, jb), (ps_, pb) = both(clusters, method, path, body, raw, ps)
        assert (ps_, pb) == (js, jb), (method, path, js, jb, ps_, pb)
    # the function listings, but for the creation time
    (js, jb), (ps_, pb) = both(clusters, "GET", "/function")
    assert ps_ == js == 200
    assert [without(f, "created_at", "size") for f in pb] == [
        without(f, "created_at", "size") for f in jb]


def test_generate_one_shot_and_streamed_match(clusters):
    for prompts, n in (([[1, 2, 3, 4, 5]], 6), ([[7, 8, 9]], 10),
                       ([[3, 1, 4, 1, 5, 9, 2, 6]], 5)):
        body = {"model_id": JOB, "prompts": prompts, "max_new_tokens": n}
        (js, jb), (ps_, pb) = both(clusters, "POST", "/generate", body)
        assert js == ps_ == 200
        assert tokens(pb) == tokens(jb)
        jc, pc = clusters
        jlines = stream(jc.controller.url, body)
        plines = stream(pc.controller_url, body)
        assert [t for ln in plines for t in ln.get("tokens", [])] == \
            tokens(pb)[0]
        assert [t for ln in jlines for t in ln.get("tokens", [])] == \
            tokens(jb)[0]
        # request ids carry each decoder's random tag
        assert without(plines[-1], "request_id") == without(
            jlines[-1], "request_id") == {"done": True,
                                          "lengths": pb["lengths"]}


def test_infer_on_the_final_matches(clusters):
    body = {"model_id": JOB, "data": [[1, 2, 3, 4], [5, 6, 7, 8]]}
    (js, jb), (ps_, pb) = both(clusters, "POST", "/infer", body)
    assert js == ps_ == 200
    assert pb == jb


def test_trace_routes_of_an_unknown_task_answer_as_jax(clusters):
    """The controller's ``/tasks/{id}/trace`` of a task with no spans is
    JAX's 404, envelope and all; the PS's ``/traces/{id}`` is an empty
    trace, and a malformed post JAX's 400."""
    (js, jb), (ps_, pb) = both(clusters, "GET", "/tasks/nope1234/trace")
    assert js == ps_ == 404 and pb == jb
    (js, jb), (ps_, pb) = both(clusters, "GET", "/traces/nope1234", ps=True)
    assert js == ps_ == 200
    keys = ("task_id", "trace_ids", "dropped", "spans")
    assert {k: pb[k] for k in keys} == {k: jb[k] for k in keys}
    assert pb["spans"] == []
    (js, jb), (ps_, pb) = both(clusters, "POST", "/traces/nope1234",
                               body={"spans": "x"}, ps=True)
    assert js == ps_ == 400 and pb == jb


def test_port_refuses_what_it_has_not_ported(clusters):
    jc, pc = clusters
    for path, ps, module in (("/slo", False, "ps/slo.py"),
                             ("/metrics/history", False,
                              "utils/timeseries.py"),
                             ("/slo", True, "ps/slo.py"),
                             ("/metrics/history", True,
                              "utils/timeseries.py")):
        base = pc.ps_api.url if ps else pc.controller_url
        status, body = call(base, "GET", path)
        assert status == 400 and module in body["error"], (path, body)
        assert "not ported" in body["error"] and body["code"] == 400
    # a live job's /generate (the JAX package's dense path)
    with pc.ps._lock:
        pc.ps._jobs["livejob"] = _JobRecord(task=TrainTask(job_id="livejob"),
                                            job=None, thread=None)
    try:
        status, body = call(pc.controller_url, "POST", "/generate",
                            {"model_id": "livejob", "prompts": [[1]]})
    finally:
        with pc.ps._lock:
            pc.ps._jobs.pop("livejob")
    # a live job's /generate is ported (TrainJob.generate): a job still
    # starting answers 503, as the JAX server does
    assert status == 503 and "still starting" in body["error"]


def test_ps_metrics_share_the_jax_names(clusters):
    (js, jt), (ps_, pt) = both(clusters, "GET", "/metrics", ps=True)
    assert js == ps_ == 200

    def names(text):
        return {ln.split()[2] for ln in text.splitlines()
                if ln.startswith("# TYPE")}

    port, jax_ = names(pt), names(jt)
    assert port <= jax_
    assert {n for n in jax_ if n.startswith(("kubeml_job_", "kubeml_scale",
                                             "kubeml_preempt",
                                             "kubeml_scheduler",
                                             "kubeml_serving"))} <= port
    (js, jb), (ps_, pb) = both(clusters, "POST", "/metrics/j1",
                               {"train_loss": 1.5, "parallelism": 2,
                                "epoch": 1, "round_seconds": [0.1]}, ps=True)
    assert (ps_, pb) == (js, jb) == (200, {})
    (_, jt), (_, pt) = both(clusters, "GET", "/metrics", ps=True)
    for line in ('kubeml_job_train_loss{jobid="j1"} 1.5',
                 'kubeml_job_parallelism{jobid="j1"} 2.0',
                 'kubeml_job_round_seconds_count{jobid="j1"} 1'):
        assert line in jt and line in pt, line


def test_serving_drain_then_overload_match(clusters):
    """Last: after a drain the decoders refuse admissions (429)."""
    body = {"model_id": JOB, "prompts": [[1, 2, 3]], "max_new_tokens": 2}
    both(clusters, "POST", "/generate", body)  # the decoders exist
    (js, jb), (ps_, pb) = both(clusters, "POST", "/serving/drain",
                               {"grace": 0}, ps=True)
    assert js == ps_ == 200 and pb == jb
    assert pb == {"models": [JOB], "snapshots": 0, "written": []}
    (js, jb), (ps_, pb) = both(clusters, "POST", "/generate", body)
    assert (ps_, without(pb, "retry_after")) == (js, without(jb,
                                                             "retry_after"))
    assert ps_ == 429
    (js, jb), (ps_, pb) = both(clusters, "GET", "/serving/restored", ps=True)
    assert (ps_, pb) == (js, jb) == (200, [])

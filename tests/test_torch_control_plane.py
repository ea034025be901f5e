"""The port's control plane on the CPU: ``LocalCluster(device="cpu")`` with
every service on port 0, driven over HTTP through ``KubemlClient`` and
``kubeml_tpu_torch.cli.main``, training LeNet on a small seeded set.

Every wait is on the job's own state (``ParameterServer.wait``, the
history) with a deadline and a message, never on the task list. Held:

* a static run through ``/train`` has the history of a direct ``TrainJob``
  on the same seed and data (within 1e-6);
* an elastic run's parallelism trace is legal and agrees with
  ``/jobs/{id}/decisions``, and ``/metrics`` carries its training series;
* ``infer`` on a running job answers from the merged weights of the last
  completed round, not from a replica partway through its local steps
  (the live job is paused inside a round);
* stop, and an operator preempt that requeues the job with resume;
* a job stopped by a cluster shutdown is resumed by the next cluster from
  the journal;
* the CLI's commands, and SIGTERM across two ``cli start --device cpu``
  processes serving a tiny GPT: the drained rows restore in the second.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from kubeml_tpu_torch.api.config import Config
from kubeml_tpu_torch.api.errors import KubeMLError
from kubeml_tpu_torch.api.types import TrainOptions, TrainRequest
from kubeml_tpu_torch.cluster import LocalCluster
from kubeml_tpu_torch.controller import KubemlClient
from kubeml_tpu_torch.engine.job import TrainJob
from kubeml_tpu_torch.functions.registry import FunctionRegistry
from kubeml_tpu_torch.storage import HistoryStore, ShardStore

REPO = Path(__file__).resolve().parent.parent
WAIT = 120.0  # seconds any wait may take before the test fails

LENET_FN = """
from kubeml_tpu_torch.data.dataset import KubeDataset
from kubeml_tpu_torch.models.lenet import LeNet
from kubeml_tpu_torch.runtime.model import KubeModel


class Model(KubeModel):
    def __init__(self):
        super().__init__(KubeDataset("blobs"))

    def build(self):
        return LeNet(num_classes=10, in_shape=(16, 16, 1))

    def infer(self, variables, x):
        logits, _ = self.forward(variables, x, train=False)
        return logits
"""


TEXT_LM_FN = """
from kubeml_tpu_torch.data.dataset import KubeDataset
from kubeml_tpu_torch.data.text import BYTE_VOCAB
from kubeml_tpu_torch.models.gpt import CausalTransformer
from kubeml_tpu_torch.parallel.trainer import adamw
from kubeml_tpu_torch.runtime.model import KubeModel


class Model(KubeModel):
    def __init__(self):
        super().__init__(KubeDataset("t"))

    def build(self):
        return CausalTransformer(vocab_size=BYTE_VOCAB, max_len=32,
                                 embed_dim=16, depth=1, num_heads=2,
                                 mesh=self.mesh, device="cpu")

    def configure_optimizers(self, params):
        return adamw(self.lr)(params)
"""


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def blobs(n, seed):
    r = np.random.default_rng(seed)
    y = r.integers(0, 10, size=n)
    x = r.standard_normal((n, 16, 16, 1)).astype(np.float32)
    x[np.arange(n), y, :, 0] += 2.0  # a learnable row per class
    return x, y


def port_config(root, **kw):
    return Config(data_root=Path(root), controller_port=0, scheduler_port=0,
                  ps_port=0, storage_port=0, **kw)


@pytest.fixture
def cluster(tmp_path):
    with LocalCluster(config=port_config(tmp_path / "kubeml"),
                      device="cpu") as c:
        yield c


def setup_job_inputs(client):
    x, y = blobs(512, 0)
    xt, yt = blobs(128, 1)
    client.datasets().create("blobs", x, y, xt, yt)
    client.functions().create("lenet", LENET_FN)
    return xt


def request(epochs, parallelism=2, static=False, **opts):
    return TrainRequest(function_name="lenet", dataset="blobs",
                        epochs=epochs, batch_size=16, lr=0.05,
                        options=TrainOptions(default_parallelism=parallelism,
                                             static_parallelism=static, k=4,
                                             precision="f32", **opts))


def live_job(cluster, jid):
    """The running TrainJob of ``jid``, once the PS started it."""
    deadline = time.monotonic() + WAIT
    while time.monotonic() < deadline:
        with cluster.ps._lock:
            rec = cluster.ps._jobs.get(jid)
        if rec is not None and rec.job is not None:
            return rec.job
        time.sleep(0.01)
    raise AssertionError(f"job {jid} did not start within {WAIT} s")


def wait_job(cluster, jid, epochs=None):
    """Wait until ``jid`` has no live record and its history is saved
    (with ``epochs`` train losses when given); returns the history."""
    deadline = time.monotonic() + WAIT
    while time.monotonic() < deadline:
        with cluster.ps._lock:
            live = jid in cluster.ps._jobs
        if live:
            cluster.ps.wait(jid, timeout=1.0)
            continue
        try:
            h = cluster.history_store.get(jid)
        except KubeMLError:
            h = None
        if h is not None and (epochs is None
                              or len(h.train_loss) >= epochs):
            return h
        time.sleep(0.02)
    raise AssertionError(f"job {jid} did not finish within {WAIT} s")


def pause_inside_round(job, at_call):
    """Block the job thread in its per-sample loss at call ``at_call``
    (inside a round: earlier steps of the round already applied).
    Returns (paused, release) events."""
    paused, release = threading.Event(), threading.Event()
    calls = [0]
    base = job.model.per_sample_loss

    def loss(logits, labels):
        calls[0] += 1
        if calls[0] == at_call:
            paused.set()
            if not release.wait(WAIT):
                raise AssertionError("the test never released the job")
        return base(logits, labels)

    job.model.per_sample_loss = loss
    return paused, release


def test_static_train_over_http_matches_a_direct_trainjob(cluster, tmp_path):
    client = KubemlClient(cluster.controller_url)
    setup_job_inputs(client)
    jid = client.networks().train(request(3, static=True))
    h = wait_job(cluster, jid, 3)
    assert client.histories().get(jid).to_dict() == h.to_dict()
    assert not (h.task or {}).get("error")

    # the same request, seed and data through a TrainJob of its own
    cfg = Config(data_root=tmp_path / "direct")
    cfg.ensure_dirs()
    store = ShardStore(config=cfg)
    store.create("blobs", *blobs(512, 0), *blobs(128, 1))
    reg = FunctionRegistry(config=cfg)
    reg.create("lenet", LENET_FN)
    model = reg.load("lenet")
    req = request(3, static=True)
    model._set_params(lr=req.lr, batch_size=req.batch_size, epoch=0,
                      k=req.options.k, task="train")
    from kubeml_tpu_torch.storage import CheckpointStore

    want = TrainJob("direct", req, model, store=store,
                    history_store=HistoryStore(config=cfg),
                    checkpoint_store=CheckpointStore(config=cfg),
                    device="cpu").train()
    assert h.parallelism == want.parallelism == [2, 2, 2]
    for key in ("train_loss", "validation_loss", "accuracy"):
        np.testing.assert_allclose(getattr(h, key), getattr(want, key),
                                   rtol=0, atol=1e-6, err_msg=key)
    assert client.checkpoints().list(jid) == ["final"]
    decisions = client.tasks().decisions(jid)["decisions"]
    assert [d["reason"] for d in decisions] == ["new-task"]


def test_elastic_trace_is_legal_and_matches_decisions(cluster):
    client = KubemlClient(cluster.controller_url)
    setup_job_inputs(client)
    jid = client.networks().train(request(4, parallelism=2))
    h = wait_job(cluster, jid, 4)
    trace = h.parallelism
    decisions = client.tasks().decisions(jid)
    ds = decisions["decisions"]
    assert set(trace) <= {1, 2, 4, 8}
    assert decisions["total"] == len(ds) == 5  # the start and 4 epoch ends
    assert [d["to"] for d in ds[:4]] == trace
    assert [d["from"] for d in ds[1:]] == trace
    assert ds[0]["reason"] == "new-task" and ds[0]["to"] == 2
    text = client_metrics(cluster)
    assert f'kubeml_job_epoch_seconds_count{{jobid="{jid}"}} 4' in text
    assert f'kubeml_job_round_seconds_bucket{{jobid="{jid}"' in text
    assert 'kubeml_job_running_total{type="train"} 0' in text
    n = sum(1 for d in ds if d["direction"] == "new")
    assert f'kubeml_scale_decisions_total{{direction="new",reason=' \
           f'"new-task"}} {n}' in text


def client_metrics(cluster):
    from kubeml_tpu_torch.utils import http_client as http

    r = http.get(f"{cluster.ps_api.url}/metrics", timeout=(5, 30))
    assert r.status_code == 200
    return r.text


def test_live_infer_answers_from_the_merged_weights(tmp_path):
    """A LeNet job paused inside its second round, after worker 0's
    third local step: ``infer`` from this thread equals the model on the
    weights the first round merged (taken at the second round's first
    step, before any update) and differs from the live replica 0."""
    cfg = Config(data_root=tmp_path)
    cfg.ensure_dirs()
    store = ShardStore(config=cfg)
    store.create("blobs", *blobs(256, 0), *blobs(64, 1))
    reg = FunctionRegistry(config=cfg)
    reg.create("lenet", LENET_FN)
    model = reg.load("lenet")
    req = request(1, parallelism=2, static=True)
    model._set_params(lr=0.5, batch_size=16, epoch=0, k=4, task="train")
    req.lr = 0.5
    job = TrainJob("live", req, model, store=store,
                   history_store=HistoryStore(config=cfg), device="cpu")
    # rounds of 2 workers x 4 steps: call 9 opens round 2, call 11 is
    # worker 0's third step of it
    merged = {}
    base = model.per_sample_loss
    calls = [0]
    paused, release = threading.Event(), threading.Event()

    def loss(logits, labels):
        calls[0] += 1
        if calls[0] == 9:
            merged["vars"] = job.trainer.reference_variables(
                job._stacked_vars)
        if calls[0] == 11:
            paused.set()
            release.wait(WAIT)
        return base(logits, labels)

    model.per_sample_loss = loss
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("h", job.train()))
    t.start()
    try:
        assert paused.wait(WAIT), "the job never reached the pause"
        x = blobs(8, 3)[0]
        got = job.infer(x)
        want = job.trainer.infer_replica(
            {c: {k: torch.from_numpy(v) for k, v in leaves.items()}
             for c, leaves in merged["vars"].items()}, x)
        live = job.trainer.infer_replica(
            job.trainer._replica0(job._stacked_vars), x)
    finally:
        release.set()
        t.join(WAIT)
    assert not t.is_alive()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.abs(live - want).max() > 1e-4  # the replica had moved
    assert len(out["h"].train_loss) == 1


def test_concurrent_live_infer_reads_only_merged_weights(tmp_path):
    """Six threads call ``infer`` while a job trains, the switch interval
    shortened: every answer equals the model on one of the weights the
    job published at a round's edge (a read of a replica mid-round, or of
    a half-swapped module, would match none)."""
    cfg = Config(data_root=tmp_path)
    cfg.ensure_dirs()
    store = ShardStore(config=cfg)
    store.create("blobs", *blobs(512, 0), *blobs(64, 1))
    reg = FunctionRegistry(config=cfg)
    reg.create("lenet", LENET_FN)
    model = reg.load("lenet")
    model._set_params(lr=0.5, batch_size=16, epoch=0, k=2, task="train")
    req = request(2, parallelism=2, static=True)
    req.lr = 0.5
    job = TrainJob("busy", req, model, store=store,
                   history_store=HistoryStore(config=cfg), device="cpu")
    published = []
    base_publish = job._publish

    def publish():
        base_publish()
        published.append(job._published)

    job._publish = publish
    x = blobs(4, 5)[0]
    answers, errors = [], []
    done = threading.Event()

    def reader():
        try:
            while not done.is_set():
                if job._published is not None:
                    answers.append(job.infer(x))
        except Exception as e:  # surfaced after the join
            errors.append(e)

    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        readers = [threading.Thread(target=reader) for _ in range(6)]
        for t in readers:
            t.start()
        h = job.train()
    finally:
        done.set()
        sys.setswitchinterval(before)
        for t in readers:
            t.join(WAIT)
    assert not any(t.is_alive() for t in readers)
    assert not errors, errors
    assert len(h.train_loss) == 2 and len(published) > 4 and answers
    states = [job.trainer.infer_replica(p, x) for p in published]
    for a in answers:
        assert any(np.array_equal(a, s) for s in states)


def test_live_infer_over_http_while_paused(cluster):
    client = KubemlClient(cluster.controller_url)
    xt = setup_job_inputs(client)
    jid = client.networks().train(request(2, parallelism=2, static=True))
    job = live_job(cluster, jid)
    paused, release = pause_inside_round(job, 11)
    try:
        assert paused.wait(WAIT), "the job never reached the pause"
        got = client.networks().infer(jid, xt[:4])
        want = job.trainer.infer_replica(job._published, xt[:4])
        text = client_metrics(cluster)
    finally:
        release.set()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert 'kubeml_job_running_total{type="train"} 1' in text
    wait_job(cluster, jid, 2)
    # finished: the final export answers
    after = client.networks().infer(jid, xt[:4])
    np.testing.assert_allclose(after, job.infer(xt[:4]), rtol=0, atol=1e-5)


def test_stop_and_preempt_requeue_with_resume(cluster):
    client = KubemlClient(cluster.controller_url)
    setup_job_inputs(client)
    # stop
    jid = client.networks().train(request(30, static=True))
    job = live_job(cluster, jid)
    paused, release = pause_inside_round(job, 20)
    assert paused.wait(WAIT)
    assert [t.job_id for t in client.tasks().list()] == [jid]
    client.tasks().stop(jid)
    release.set()
    h = wait_job(cluster, jid)
    assert len(h.train_loss) < 30
    assert not list(cluster.ps._journal.dir.glob("*.json"))
    # preempt: a yield checkpoint, then the requeue resumes from it
    jid = client.networks().train(request(3, static=True,
                                          checkpoint_every=1))
    job = live_job(cluster, jid)
    paused, release = pause_inside_round(job, 40)  # inside epoch 2
    assert paused.wait(WAIT)
    client.tasks().preempt(jid, grace=WAIT)
    snap = {j["job_id"]: j for j in client.tasks().jobs()}
    assert snap[jid]["preempting"] is True
    release.set()
    deadline = time.monotonic() + WAIT
    while live_job(cluster, jid) is job:  # the requeued run replaces it
        assert time.monotonic() < deadline, "the preempted job was not " \
                                            "requeued"
        time.sleep(0.01)
    h = wait_job(cluster, jid, 3)
    ds = client.tasks().decisions(jid)["decisions"]
    assert [d["reason"] for d in ds] == ["new-task", "new-task"]
    assert len(h.train_loss) == 3 and not (h.task or {}).get("error")
    assert h.task["request"]["options"]["resume"] is True
    assert 'kubeml_preemptions_total{reason="operator"} 1' in \
        client_metrics(cluster)
    assert not list(cluster.ps._journal.dir.glob("*.json"))
    with pytest.raises(KubeMLError) as e:
        client.tasks().stop("nosuchjob")
    assert e.value.status_code == 404


def test_journal_recovery_after_a_shutdown_mid_job(tmp_path):
    root = tmp_path / "kubeml"
    with LocalCluster(config=port_config(root), device="cpu") as c1:
        client = KubemlClient(c1.controller_url)
        setup_job_inputs(client)
        jid = client.networks().train(request(4, static=True,
                                              checkpoint_every=1))
        job = live_job(c1, jid)
        paused, release = pause_inside_round(job, 40)  # inside epoch 2
        assert paused.wait(WAIT)
        c1.ps.stop_running_jobs()  # the shutdown's first step
        release.set()
        assert c1.ps.wait(jid, WAIT), "the stopped job did not end"
    journaled = [p.stem for p in (root / "journal").glob("*.json")]
    assert journaled == [jid]
    done_before = len(HistoryStore(root=root / "history").get(jid)
                      .train_loss)
    assert 1 <= done_before < 4
    with LocalCluster(config=port_config(root), device="cpu") as c2:
        h = wait_job(c2, jid, 4)
        assert h.task["request"]["options"]["resume"] is True
        assert h.parallelism == [2, 2, 2, 2]
        assert not (h.task or {}).get("error")
    assert not list((root / "journal").glob("*.json"))


def run_cli(capsys, url, *argv):
    from kubeml_tpu_torch.cli import main

    rc = main(["--url", url, *argv])
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_cli_commands(cluster, tmp_path, capsys, monkeypatch):
    from kubeml_tpu_torch.utils import tracing

    tracer = tracing.get_tracer()
    tracer.clear()
    monkeypatch.setattr(tracer, "enabled", True)
    url = cluster.controller_url
    x, y = blobs(256, 0)
    files = {}
    for name, a in (("x", x), ("y", y), ("xt", x[:64]), ("yt", y[:64])):
        files[name] = tmp_path / f"{name}.npy"
        np.save(files[name], a)
    fn = tmp_path / "lenet.py"
    fn.write_text(LENET_FN)
    assert run_cli(capsys, url, "dataset", "create", "-n", "blobs",
                   "--traindata", str(files["x"]), "--trainlabels",
                   str(files["y"]), "--testdata", str(files["xt"]),
                   "--testlabels", str(files["yt"]))[0] == 0
    rc, out, _ = run_cli(capsys, url, "dataset", "list")
    assert rc == 0 and '"train_set_size": 256' in out
    assert run_cli(capsys, url, "function", "create", "-n", "lenet",
                   "--code", str(fn))[0] == 0
    rc, out, _ = run_cli(capsys, url, "fn", "list")
    assert rc == 0 and '"lenet"' in out
    rc, out, _ = run_cli(capsys, url, "train", "-f", "lenet", "-d", "blobs",
                         "-e", "2", "-b", "16", "-p", "2", "--static",
                         "-K", "4", "--checkpoint-every", "1")
    assert rc == 0
    jid = out.strip()
    wait_job(cluster, jid, 2)
    rc, out, _ = run_cli(capsys, url, "history", "get", "--id", jid)
    assert rc == 0 and '"parallelism": [\n    2,\n    2\n  ]' in out
    rc, out, _ = run_cli(capsys, url, "decisions", jid)
    assert rc == 0 and "new-task" in out
    rc, out, _ = run_cli(capsys, url, "jobs")
    assert rc == 0 and out.strip() == "no jobs"
    rc, out, _ = run_cli(capsys, url, "task", "list", "--short")
    assert rc == 0 and out.strip() == ""
    rc, out, _ = run_cli(capsys, url, "task", "prune")
    assert rc == 0 and "pruned 0 tasks" in out
    rc, out, _ = run_cli(capsys, url, "checkpoint", "list", "--id", jid)
    assert rc == 0 and "ep00000" in out and "final" in out
    dest = tmp_path / "model.npz"
    assert run_cli(capsys, url, "checkpoint", "export", "--id", jid,
                   "--out", str(dest))[0] == 0
    assert dest.stat().st_size > 0
    np.save(tmp_path / "probe.npy", x[:3])
    rc, out, _ = run_cli(capsys, url, "infer", "-n", jid, "--datafile",
                         str(tmp_path / "probe.npy"))
    assert rc == 0 and len(eval(out)) == 3
    rc, _, err = run_cli(capsys, url, "task", "stop", "--id", "nosuch")
    assert rc == 1 and "not found" in err
    assert run_cli(capsys, url, "checkpoint", "delete", "--id", jid)[0] == 0
    assert run_cli(capsys, url, "history", "delete", "--id", jid)[0] == 0
    rc, out, _ = run_cli(capsys, url, "history", "prune")
    assert rc == 0 and "pruned" in out
    assert run_cli(capsys, url, "dataset", "delete", "-n", "blobs")[0] == 0
    assert run_cli(capsys, url, "function", "delete", "-n", "lenet")[0] == 0
    # the job ran traced: its merged trace and its per-phase profile
    rc, out, _ = run_cli(capsys, url, "trace", jid)
    assert rc == 0 and len(json.loads(out)["traceEvents"]) > 0
    rc, out, _ = run_cli(capsys, url, "profile", jid)
    assert rc == 0 and "job.epoch" in {
        r["phase"] for r in json.loads(out)["phases"]}
    for argv in (("slo",), ("top",)):
        rc, _, err = run_cli(capsys, url, *argv)
        assert rc == 2 and "not ported" in err, argv
    # `dataset create-text` and `generate --text` are ported: a byte-level
    # corpus, a one-epoch LM trained on it, prompted with text (streamed
    # and not, the same text)
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("\n\n".join(f"document {i} of a tiny corpus"
                                   for i in range(24)))
    rc, out, _ = run_cli(capsys, url, "dataset", "create-text", "-n", "t",
                         "--corpus", str(corpus), "--seq-len", "16")
    assert rc == 0 and '"tokenizer": "byte"' in out, out
    (tmp_path / "tlm.py").write_text(TEXT_LM_FN)
    assert run_cli(capsys, url, "function", "create", "-n", "tlm",
                   "--code", str(tmp_path / "tlm.py"))[0] == 0
    rc, out, _ = run_cli(capsys, url, "train", "-f", "tlm", "-d", "t", "-e",
                         "1", "-b", "4", "--engine", "spmd")
    assert rc == 0
    lm = out.strip()
    wait_job(cluster, lm, 1)
    texts = []
    for extra in ((), ("--stream",)):
        rc, out, err = run_cli(capsys, url, "generate", "-n", lm, "--text",
                               "document 3", "--max-new-tokens", "6",
                               *extra)
        assert rc == 0, err
        texts.append(out)
    assert texts[0] == texts[1] and texts[0].endswith("\n")
    # `logs` is ported: the cluster log (which `cli start` writes) filtered
    # by the id, and a missing log reported as JAX's command reports it
    from kubeml_tpu_torch.api import config as port_cfg

    saved = port_cfg.get_config()
    port_cfg.set_config(Config(data_root=tmp_path / "logsroot"))
    try:
        rc, _, err = run_cli(capsys, url, "logs", "--id", jid)
        assert rc == 1 and "no log file at" in err
        logs = tmp_path / "logsroot" / "logs"
        logs.mkdir(parents=True)
        (logs / "kubeml.log").write_text(f"a {jid} epoch 1/1\nother job\n")
        rc, out, _ = run_cli(capsys, url, "logs", "--id", jid)
        assert rc == 0 and out == f"a {jid} epoch 1/1\n"
    finally:
        port_cfg.set_config(saved)


TINY_GPT_FN = """
import torch
from kubeml_tpu_torch.data.dataset import KubeDataset
from kubeml_tpu_torch.models.gpt import CausalTransformer
from kubeml_tpu_torch.runtime.model import KubeModel


class Model(KubeModel):
    def __init__(self):
        super().__init__(KubeDataset("tokens"))

    def build(self):
        return CausalTransformer(vocab_size=64, max_len=64, embed_dim=32,
                                 depth=2, num_heads=2, device="cpu")
"""


def cli_start(root, snaps, log):
    env = dict(os.environ, KUBEML_DATA_ROOT=str(root),
               KUBEML_CONTROLLER_PORT="0", KUBEML_SCHEDULER_PORT="0",
               KUBEML_PS_PORT="0", KUBEML_STORAGE_PORT="0",
               KUBEML_SNAP_DIR=str(snaps), KUBEML_DRAIN_GRACE="0",
               KUBEML_SERVING_SLOTS="2", KUBEML_SERVING_PAGE_TOKENS="4",
               KUBEML_SERVING_CHUNK="1", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, (
                   str(REPO), os.environ.get("PYTHONPATH")))))
    with open(log, "ab") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "kubeml_tpu_torch.cli", "start",
             "--device", "cpu"], cwd=str(REPO), env=env,
            stdout=subprocess.PIPE, stderr=err, text=True)
    line = proc.stdout.readline()
    import re

    m = re.search(r"controller at (\S+); ps at (\S+)", line)
    if not m:
        proc.kill()
        proc.wait(30)
        raise AssertionError(f"cli start printed {line!r}: "
                             f"{Path(log).read_text()[-2000:]}")
    return proc, m.group(1), m.group(2)


def test_sigterm_drains_and_a_second_cli_start_restores(tmp_path):
    """``cli start --device cpu`` serving a tiny GPT's final: SIGTERM
    while two streams decode exits 0 and leaves KMS1 frames; a second
    ``cli start`` restores them at boot, and the restored streams end
    with the tokens of an uninterrupted run."""
    from kubeml_tpu_torch.interop.from_flax import to_flax
    from kubeml_tpu_torch.models.gpt import CausalTransformer
    from kubeml_tpu_torch.storage import FINAL_TAG, CheckpointStore
    from kubeml_tpu_torch.utils import http_client as http

    root, snaps = tmp_path / "kubeml", tmp_path / "snaps"
    cfg = Config(data_root=root)
    cfg.ensure_dirs()
    FunctionRegistry(config=cfg).create("tinygpt", TINY_GPT_FN)
    torch.manual_seed(0)
    model = CausalTransformer(vocab_size=64, max_len=64, embed_dim=32,
                              depth=2, num_heads=2, device="cpu")
    CheckpointStore(config=cfg).save(
        "lm", to_flax(model.state_dict()), epoch=1, tag=FINAL_TAG,
        meta={"request": {"function_name": "tinygpt"}})
    prompts = [[1, 2, 3, 4, 5], [9, 8, 7]]
    # the uninterrupted run, in process
    from kubeml_tpu_torch.ps import ParameterServer

    ps = ParameterServer(config=Config(data_root=root, serving_slots=2,
                                       serving_page_tokens=4,
                                       serving_chunk_steps=1), device="cpu")
    want = []
    for p in prompts:
        r = ps.generate("lm", {"prompts": [p], "max_new_tokens": 40})
        want.append(r["tokens"][0][:r["lengths"][0]])
    ps.close()

    log = tmp_path / "cli.log"
    proc, url, _ = cli_start(root, snaps, log)
    procs = [proc]
    try:
        client = KubemlClient(url, timeout=WAIT)
        partial, started = {}, threading.Barrier(3)
        eight = threading.Event()

        def stream(i):
            toks = []
            started.wait(WAIT)
            try:
                for part in client.networks().generate(
                        "lm", [prompts[i]], max_new_tokens=40, stream=True):
                    if "error" in part:
                        partial[i] = part["partial_tokens"][0]
                        return
                    toks += part.get("tokens", [])
                    if len(toks) >= 4:
                        eight.set()
                partial[i] = None  # finished before the signal
            except http.TransportError:
                partial[i] = toks

        threads = [threading.Thread(target=stream, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        started.wait(WAIT)
        assert eight.wait(WAIT), "no stream reached 4 tokens"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(WAIT) == 0, log.read_text()[-3000:]
        for t in threads:
            t.join(WAIT)
        frames = sorted(snaps.glob("*.kms"))
        assert frames, "no KMS1 frame left by the drain"
        proc2, _, ps_url = cli_start(root, snaps, log)
        procs.append(proc2)
        deadline = time.monotonic() + WAIT
        while True:
            rows = http.check(http.get(f"{ps_url}/serving/restored",
                                       timeout=(5, 30)))
            if rows and all(r["done"] or r["error"] for r in rows):
                break
            assert time.monotonic() < deadline, f"restored rows {rows}"
            time.sleep(0.05)
        assert len(rows) == len(frames)
        assert not any(r["error"] for r in rows)
        got = sorted(r["tokens"][0] for r in rows)
        assert all(g in want for g in got), (got, want)
        proc2.send_signal(signal.SIGTERM)
        assert proc2.wait(WAIT) == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(30)

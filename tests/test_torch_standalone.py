"""Standalone job runners of the port (``engine/job_runner.py`` and the
parameter server's standalone half) on the CPU: ``LocalCluster(device=
"cpu")`` with ``standalone_jobs=True`` and a tiny K-AVG function, each
job in a runner subprocess. One cluster serves every check; the jobs run
side by side.

* a static job through ``/train`` gives the history of the same job run
  threaded in the port (1e-6 relative; threaded jobs are held against JAX
  by ``tests/test_torch_train_job.py``), and ``kubeml logs --id`` prints
  its epoch lines from the runner's own log;
* the runner's HTTP surface answers as JAX's in-process ``JobRunner``
  does, code and body;
* the elastic round trip (runner -> scheduler -> PS -> runner ``/update``)
  follows the scheduler's decisions;
* a live job's ``/infer`` through the tensor socket, then the KMW1 wire
  (``tensor_sockets=False``), then the runner's JSON: equal predictions,
  the route counter naming each; then ``/stop``;
* a SIGKILLed runner: the monitor fails the job and frees its slot;
* a stalled runner exits 74 under a small ``function_timeout``.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from kubeml_tpu_torch.api.config import Config
from kubeml_tpu_torch.api.errors import KubeMLError
from kubeml_tpu_torch.api.types import TrainOptions, TrainRequest
from kubeml_tpu_torch.cluster import LocalCluster
from kubeml_tpu_torch.engine.job import TrainJob
from kubeml_tpu_torch.functions.registry import FunctionRegistry
from kubeml_tpu_torch.storage import CheckpointStore, HistoryStore, ShardStore
from kubeml_tpu_torch.utils import http_client

REPO = Path(__file__).resolve().parent.parent
WAIT = 120.0

TINY_FN = """
GATED = False

import os
import time

import torch
from kubeml_tpu_torch.data.dataset import KubeDataset
from kubeml_tpu_torch.runtime.model import KubeModel

GATE = os.environ.get("KUBEML_TEST_GATE", "") if GATED else ""


class Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.hidden = torch.nn.Linear(64, 32)
        self.out = torch.nn.Linear(32, 10)

    def forward(self, x, train=False):
        return self.out(torch.relu(self.hidden(x.flatten(1))))


class Model(KubeModel):
    def __init__(self):
        super().__init__(KubeDataset("blobs"))

    def build(self):
        torch.manual_seed(0)
        return Tiny()

    def per_sample_loss(self, logits, y):
        # a gated job holds its second epoch's first step while the gate
        # file exists (its first epoch's weights are published by then)
        while GATE and self.epoch >= 1 and os.path.exists(GATE):
            time.sleep(0.05)
        return super().per_sample_loss(logits, y)
"""

GATED_FN = TINY_FN.replace("GATED = False", "GATED = True")

HANG_FN = """
import time

import torch
from kubeml_tpu_torch.data.dataset import KubeDataset
from kubeml_tpu_torch.runtime.model import KubeModel


class Hang(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(64, 10)

    def forward(self, x, train=False):
        time.sleep(3600)  # wedged user code inside the runner
        return self.lin(x.flatten(1))


class Model(KubeModel):
    def __init__(self):
        super().__init__(KubeDataset("blobs"))

    def build(self):
        return Hang()
"""


def blobs(n, seed):
    r = np.random.default_rng(seed)
    y = r.integers(0, 10, size=n)
    x = r.standard_normal((n, 8, 8, 1)).astype(np.float32)
    x[np.arange(n), y % 8, :, 0] += 2.0
    return x, y


def request(epochs, fn="tiny", parallelism=2, static=True, **opts):
    return TrainRequest(function_name=fn, dataset="blobs", epochs=epochs,
                        batch_size=16, lr=0.05,
                        options=TrainOptions(
                            default_parallelism=parallelism,
                            static_parallelism=static, k=2, precision="f32",
                            **opts))


def setup_root(cfg):
    cfg.ensure_dirs()
    ShardStore(config=cfg).create("blobs", *blobs(256, 0), *blobs(64, 1))
    reg = FunctionRegistry(config=cfg)
    reg.create("tiny", TINY_FN)
    reg.create("gated", GATED_FN)
    reg.create("hang", HANG_FN)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("standalone")
    gate = root / "gate"
    gate.touch()
    with pytest.MonkeyPatch.context() as mp:
        # the runners inherit the environment: one thread each, the gate
        mp.setenv("OMP_NUM_THREADS", "1")
        mp.setenv("KUBEML_TEST_GATE", str(gate))
        cfg = Config(data_root=root / "kubeml", controller_port=0,
                     scheduler_port=0, ps_port=0, storage_port=0,
                     standalone_jobs=True)
        setup_root(cfg)
        with LocalCluster(config=cfg, device="cpu") as cluster:
            sched = cluster.scheduler
            jobs = {
                "static": sched.submit_train(request(2)),
                "elastic": sched.submit_train(request(3, parallelism=1,
                                                      static=False)),
                "live": sched.submit_train(request(2, fn="gated",
                                                   validate_every=0)),
                "killed": sched.submit_train(request(99)),
            }
            try:
                yield cluster, jobs, gate, root
            finally:
                gate.unlink(missing_ok=True)  # no runner stays held


def record(cluster, jid, running=True):
    deadline = time.monotonic() + WAIT
    while time.monotonic() < deadline:
        with cluster.ps._lock:
            rec = cluster.ps._jobs.get(jid)
        if rec is not None and rec.url is not None and (
                not running or rec.task.status == "running"):
            return rec
        time.sleep(0.05)
    raise AssertionError(f"job {jid} has no runner after {WAIT} s")


def wait_done(cluster, jid):
    deadline = time.monotonic() + WAIT
    while time.monotonic() < deadline:
        cluster.ps.wait(jid, timeout=1.0)
        with cluster.ps._lock:
            live = jid in cluster.ps._jobs
        if not live:
            try:
                return cluster.history_store.get(jid)
            except KubeMLError:
                pass
        time.sleep(0.05)
    raise AssertionError(f"job {jid} did not finish within {WAIT} s")


def test_static_job_matches_the_threaded_job_and_logs(env, tmp_path, capsys):
    cluster, jobs, _, _ = env
    h = wait_done(cluster, jobs["static"])
    assert not (h.task or {}).get("error"), h.task
    assert h.parallelism == [2, 2]
    cfg = Config(data_root=tmp_path / "direct")
    setup_root(cfg)
    model = FunctionRegistry(config=cfg).load("tiny")
    req = request(2)
    model._set_params(lr=req.lr, batch_size=req.batch_size, epoch=0,
                      k=req.options.k, task="train")
    want = TrainJob("direct", req, model, store=ShardStore(config=cfg),
                    history_store=HistoryStore(config=cfg),
                    checkpoint_store=CheckpointStore(config=cfg),
                    device="cpu").train()
    for key in ("train_loss", "validation_loss", "accuracy"):
        np.testing.assert_allclose(getattr(h, key), getattr(want, key),
                                   rtol=1e-6, atol=0, err_msg=key)
    # its final served from the checkpoint: JSON numbers (float64) reach
    # a model that does not cast its input as float32, as JAX's default
    # dtype takes them
    x = blobs(4, 2)[0]
    served = cluster.ps.infer(jobs["static"], x.tolist())
    assert len(served) == 4 and served == cluster.ps.infer(jobs["static"], x)
    # the runner's own log, through `kubeml logs --id`
    from kubeml_tpu_torch.api import config as port_cfg
    from kubeml_tpu_torch.cli import main

    saved = port_cfg.get_config()
    port_cfg.set_config(cluster.cfg)
    try:
        assert main(["logs", "--id", jobs["static"]]) == 0
    finally:
        port_cfg.set_config(saved)
    out = capsys.readouterr().out
    assert f"{jobs['static']}: epoch 2/2 loss=" in out


def test_runner_http_surface_answers_as_jax(tmp_path):
    """Each probe to the port's runner and to JAX's in-process runner:
    the same status and body."""
    from kubeml_tpu.api.config import Config as JConfig
    from kubeml_tpu.engine.job_runner import JobRunner as JRunner
    from kubeml_tpu_torch.engine.job_runner import JobRunner as TRunner

    jcfg = JConfig(data_root=tmp_path / "jax")
    jcfg.ensure_dirs()
    tcfg = Config(data_root=tmp_path / "port", scheduler_port=1, ps_port=1)
    setup_root(tcfg)
    from kubeml_tpu.functions.registry import FunctionRegistry as JReg

    JReg(config=jcfg).create("tiny", JAX_TINY_FN)
    runners = (JRunner("unitjob", config=jcfg).start(),
               TRunner("unitjob", config=tcfg, device="cpu").start())
    task = {"job_id": "unitjob", "parameters": request(
        1, fn="tiny", validate_every=0).to_dict()}
    task["parameters"]["dataset"] = "nosuch"  # the job fails at once
    probes = [("GET", "/health", None), ("GET", "/state", None),
              ("POST", "/update", {"parallelism": 4}),
              ("POST", "/infer", {"data": [[0.0]]}),
              ("POST", "/generate", {"prompts": [[1]]}),
              ("DELETE", "/stop", None), ("POST", "/preempt", None),
              ("GET", "/weights", None), ("GET", "/weights?since=x", None),
              ("POST", "/start", task), ("POST", "/start", task),
              ("GET", "/weights?since=1", None)]
    try:
        for method, path, body in probes:
            answers = []
            for r in runners:
                resp = http_client.request(method, r.url + path, json=body,
                                           timeout=30)
                answers.append((resp.status_code, resp.json()))
            assert answers[0] == answers[1], (method, path, answers)
    finally:
        for r in runners:
            r.stop()


JAX_TINY_FN = """
import optax
import flax.linen as nn
from kubeml_tpu.runtime.model import KubeModel
from kubeml_tpu.data.dataset import KubeDataset

class Tiny(nn.Module):
    @nn.compact
    def __call__(self, x, train=False):
        return nn.Dense(10)(x.reshape((x.shape[0], -1)))

class Model(KubeModel):
    def __init__(self):
        super().__init__(KubeDataset("blobs"))
    def build(self):
        return Tiny()
    def configure_optimizers(self):
        return optax.sgd(self.lr)
"""


def test_elastic_round_trip_follows_the_decisions(env):
    cluster, jobs, _, _ = env
    jid = jobs["elastic"]
    h = wait_done(cluster, jid)
    assert len(h.train_loss) == 3 and not (h.task or {}).get("error")
    ds = cluster.scheduler.job_decisions(jid)["decisions"]
    # the start and one decision an epoch end; each epoch ran at the
    # parallelism the scheduler answered before it
    assert len(ds) == 4 and ds[0]["reason"] == "new-task"
    assert [d["to"] for d in ds[:3]] == h.parallelism
    assert max(h.parallelism) > 1, h.parallelism


def test_live_infer_through_socket_wire_and_json_then_stop(env):
    cluster, jobs, gate, _ = env
    ps, jid = cluster.ps, jobs["live"]
    rec = record(cluster, jid)
    assert rec.listening_s > 0  # the spawn to the runner's LISTENING line
    sock = cluster.cfg.job_socket_path(jid)
    # the runner holds its second epoch while the gate exists: wait until
    # it published the first
    deadline = time.monotonic() + WAIT
    while time.monotonic() < deadline:
        r = http_client.get(f"{rec.url}/weights", timeout=10)
        if r.status_code == 200 and sock.exists():
            break
        time.sleep(0.1)
    assert r.status_code == 200 and sock.exists()
    x = blobs(8, 2)[0].tolist()
    routes = dict(ps.infer_routes)
    via_socket = ps.infer(jid, x)
    assert ps.infer_routes["socket"] == routes["socket"] + 1
    cluster.cfg.tensor_sockets = False
    try:
        via_wire = ps.infer(jid, x)
        assert ps.infer_routes["wire"] == routes["wire"] + 1
        # a second pull while current is a 204 on the wire
        assert ps.infer(jid, x) == via_wire
        wire = ps._wire_weights
        ps._wire_weights = lambda *a: None  # nothing on the wire
        try:
            via_json = ps.infer(jid, x)
        finally:
            ps._wire_weights = wire
        assert ps.infer_routes["json"] == routes["json"] + 1
    finally:
        cluster.cfg.tensor_sockets = True
    assert via_socket == via_wire == via_json and len(via_json) == 8
    # /stop reaches the runner, which ends the job as stopped
    ps.stop_task(jid)
    gate.unlink(missing_ok=True)
    h = wait_done(cluster, jid)
    assert len(h.train_loss) <= 2
    with pytest.raises(KubeMLError) as e:
        ps.finish_standalone(jid, status="finished")
    assert e.value.status_code == 404


def test_killed_runner_fails_the_job_and_frees_the_slot(env):
    cluster, jobs, _, _ = env
    jid = jobs["killed"]
    rec = record(cluster, jid)
    rec.proc.kill()  # no /finish will come
    t0 = time.monotonic()
    while time.monotonic() - t0 < 10.0:  # the monitor polls every 2 s
        with cluster.ps._lock:
            if jid not in cluster.ps._jobs:
                break
        time.sleep(0.1)
    with cluster.ps._lock:
        assert jid not in cluster.ps._jobs
    h = cluster.history_store.get(jid)
    assert "exited with code" in (h.task or {}).get("error", "")
    assert jid not in [t.job_id for t in cluster.ps.list_tasks()]


def test_stalled_runner_exits_74(env):
    """A runner whose job stops making progress ends itself with exit 74
    (its stall watchdog) and the job is failed with the recycle reason."""
    cluster, _, _, root = env
    code = (
        "import sys\n"
        "from kubeml_tpu_torch.engine.job_runner import main\n"
        "sys.exit(main(sys.argv[1:]))\n")
    proc = subprocess.Popen(
        [sys.executable, "-c", code, "--job-id", "stall", "--device", "cpu",
         "--linger", "0"], cwd=REPO, stdout=subprocess.PIPE, text=True,
        env=dict(os.environ, KUBEML_DATA_ROOT=str(cluster.cfg.data_root),
                 KUBEML_FUNCTION_TIMEOUT="1", KUBEML_PS_PORT="1",
                 KUBEML_SCHEDULER_PORT="1", PYTHONPATH=str(REPO)))
    try:
        line = proc.stdout.readline()
        assert line.startswith("LISTENING "), line
        url = f"http://127.0.0.1:{int(line.split()[1])}"
        task = {"job_id": "stall", "parameters": request(
            1, fn="hang", validate_every=0).to_dict()}
        assert http_client.post(f"{url}/start", json=task,
                                timeout=30).status_code == 200
        assert proc.wait(timeout=60) == 74
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_runner_imports_nothing_of_jax():
    code = (
        "import sys\n"
        "import kubeml_tpu_torch.engine.job_runner as jr\n"
        "import kubeml_tpu_torch.engine.dataplane, kubeml_tpu_torch.native\n"
        "import kubeml_tpu_torch.native.weights, kubeml_tpu_torch.supervisor\n"
        "import kubeml_tpu_torch.scheduler.preemption\n"
        "import kubeml_tpu_torch.utils.profiler, kubeml_tpu_torch.engine.job\n"
        "import kubeml_tpu_torch.functions.registry\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'ml_dtypes', 'kubeml_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr

"""The port's preemption controller (``scheduler/preemption.py``) against
the JAX package's, and a preempted job's resume in the port.

* Both controllers, each with a fake parameter server and scheduler fed
  the same scripted telemetry on the same scripted clock, make the same
  decision on every poll: which poll preempts, the victim (priority, then
  tenant usage, then id, skipping a job mid-yield), the cooldown, the
  queue-depth, 429-rate (with a burst, and a decoder eviction that must
  not read as one) and p99 signals, park and requeue, and a requeue
  deferred on a 409. Exact equality.
* A threaded tiny job in a ``LocalCluster(device="cpu")`` with the
  preemption monitor on is preempted under forced overload, parked,
  requeued with ``resume=True`` once calm, and finishes; its final loss
  passes the JAX package's ``loss_parity`` rule
  (``kubeml_tpu/benchmarks/scenarios.py:758-770``) against the same job
  run uninterrupted.
"""

import time
from types import SimpleNamespace

import numpy as np
import pytest

from kubeml_tpu.api import config as jconfig
from kubeml_tpu.api import errors as jerrors
from kubeml_tpu.api import types as jtypes
from kubeml_tpu.scheduler import preemption as jpre
from kubeml_tpu_torch.api import config as tconfig
from kubeml_tpu_torch.api import errors as terrors
from kubeml_tpu_torch.api import types as ttypes
from kubeml_tpu_torch.scheduler import preemption as tpre

SETTINGS = dict(preempt_interval=1.0, preempt_queue_depth=3,
                preempt_overload_rate=1.0, preempt_p99=0.5,
                preempt_sustain=2, preempt_resume_sustain=3,
                preempt_cooldown=10.0)


def tele(queue=0.0, p99=0.0, overloads=(0.0,), ops=0.0):
    """Telemetry of one decoder per entry of ``overloads``."""
    return {f"m{i}": {"queue_depth": queue, "latency_p99_seconds": p99,
                      "requests_overload": float(n),
                      "overload_per_second": ops}
            for i, n in enumerate(overloads)}


# one entry a poll (1 s apart): the telemetry the PS reports
SCRIPT = (
    [tele()] * 2
    + [tele(queue=5)] * 3            # queue depth: preempt at the 2nd poll
    + [tele()]
    + [tele(overloads=(10,)), tele(overloads=(30,))]  # a 429 burst
    + [tele(overloads=(30, 5))] * 6  # a second decoder; the cooldown ends
    + [tele(overloads=(5,))]         # an eviction: the sum drops, calm
    + [tele(p99=0.9)] * 2            # the latency signal
    + [tele(ops=2.0)] * 2            # the decoders' own 429 rate
    + [tele()] * 8                   # calm: requeue, one deferred on a 409
)


class FakePS:
    def __init__(self, errors):
        self.errors = errors
        self.t = 0
        self.jobs = [
            {"job_id": "a-low", "status": "running", "priority": 0,
             "tenant": "t1"},
            {"job_id": "b-low", "status": "running", "priority": 0,
             "tenant": "t2"},
            {"job_id": "c-high", "status": "running", "priority": 5,
             "tenant": "t1"},
            {"job_id": "d-low", "status": "running", "priority": 0,
             "tenant": "t2"},
        ]
        self.preempted = []

    def serving_telemetry(self):
        return SCRIPT[self.t]

    def jobs_snapshot(self, include_journal=True):
        assert include_journal is False
        return [dict(j) for j in self.jobs]

    def preempt_task(self, job_id, reason="operator"):
        if job_id == "d-low":  # an unreachable runner: the next tick retries
            self.jobs = [j for j in self.jobs if j["job_id"] != "d-low"]
            raise self.errors.KubeMLError("runner unreachable", 502)
        for j in self.jobs:
            if j["job_id"] == job_id:
                j["preempting"] = True
        self.preempted.append((job_id, reason))


class Usage:
    def __init__(self, charges):
        self.charges = charges

    def get(self, tenant):
        return self.charges.get(tenant, 0.0)


class FakeScheduler:
    def __init__(self, errors):
        self.errors = errors
        self.usage = Usage({"t1": 5.0, "t2": 50.0})
        self.conflict_once = {"b-low"}
        self.submitted = []

    def submit_train(self, req):
        if req.job_id in self.conflict_once:
            self.conflict_once.discard(req.job_id)
            raise self.errors.KubeMLError(f"job {req.job_id} exists", 409)
        self.submitted.append((req.job_id, req.options.resume))
        return req.job_id


def run_script(pkg, monkeypatch):
    mod, cfg_mod, errors, types = pkg
    clock = SimpleNamespace(now=1000.0)
    fake_time = SimpleNamespace(monotonic=lambda: clock.now,
                                time=lambda: clock.now)
    monkeypatch.setattr(mod, "time", fake_time)
    ps, sched = FakePS(errors), FakeScheduler(errors)
    ctl = mod.PreemptionController(sched, ps,
                                   config=cfg_mod.Config(**SETTINGS))
    polled = []
    signals = ctl.signals
    ctl.signals = lambda: polled.append(signals()) or polled[-1]
    trace = []
    for t in range(len(SCRIPT)):
        clock.now = 1000.0 + t
        ps.t = t
        n_pre = len(ps.preempted)
        ctl.tick()
        sig = polled[-1]
        new = ps.preempted[n_pre:]
        for job_id, _ in new:  # the yield lands: the scheduler parks it
            ps.jobs = [j for j in ps.jobs if j["job_id"] != job_id]
            ctl.park(job_id, types.TrainRequest(
                function_name="f", job_id="",
                options=types.TrainOptions(priority=0)))
        trace.append({"t": t, "sig": {k: round(v, 9) for k, v in sig.items()},
                      "overloaded": ctl.overloaded(sig), "preempted": new,
                      "parked": ctl.parked_ids(),
                      "submitted": list(sched.submitted)})
    return trace


def test_controllers_decide_alike(monkeypatch):
    jax_trace = run_script((jpre, jconfig, jerrors, jtypes), monkeypatch)
    port_trace = run_script((tpre, tconfig, terrors, ttypes), monkeypatch)
    assert port_trace == jax_trace
    events = [(e["t"], e["preempted"]) for e in port_trace if e["preempted"]]
    # queue depth at its 2nd overloaded poll takes the lowest priority,
    # the heavier tenant first (b-low, t2); the 429 burst waits out the
    # cooldown, skips the failed d-low delivery and takes a-low
    assert events[0] == (3, [("b-low", "serving-overload")])
    assert events[1][1] == [("a-low", "serving-overload")]
    assert events[1][0] >= 13  # 10 s after the first
    last = port_trace[-1]
    # both requeued with resume=True, b-low after its 409
    assert last["parked"] == [] and sorted(last["submitted"]) == [
        ("a-low", True), ("b-low", True)]
    assert last["submitted"][0] == ("a-low", True)


def loss_parity(base_losses, losses) -> bool:
    """The JAX package's rule (benchmarks/scenarios.py:758-770): the final
    loss within the baseline's late wobble, floored at 0.05."""
    tol = (max(0.05, 3 * float(np.mean(np.abs(np.diff(base_losses[-5:])))))
           if len(base_losses) >= 5 else 0.05)
    return abs(float(losses[-1]) - float(base_losses[-1])) <= tol


def test_threaded_job_preempted_by_overload_resumes_to_parity(tmp_path,
                                                            monkeypatch):
    from test_torch_standalone import GATED_FN, TINY_FN, blobs, request

    from kubeml_tpu_torch.cluster import LocalCluster
    from kubeml_tpu_torch.engine.job import TrainJob
    from kubeml_tpu_torch.functions.registry import FunctionRegistry
    from kubeml_tpu_torch.storage import (CheckpointStore, HistoryStore,
                                          ShardStore)

    # the job holds its second epoch while the gate exists, so the
    # overload lands while it trains
    gate = tmp_path / "gate"
    gate.touch()
    monkeypatch.setenv("KUBEML_TEST_GATE", str(gate))
    cfg = tconfig.Config(data_root=tmp_path / "kubeml", controller_port=0,
                         scheduler_port=0, ps_port=0, storage_port=0,
                         preempt_monitor=True, preempt_interval=0.2,
                         preempt_queue_depth=3, preempt_overload_rate=1.0,
                         preempt_sustain=2, preempt_resume_sustain=5,
                         preempt_cooldown=10.0)
    cfg.ensure_dirs()
    ShardStore(config=cfg).create("blobs", *blobs(256, 0), *blobs(64, 1))
    reg = FunctionRegistry(config=cfg)
    reg.create("gated", GATED_FN)
    reg.create("tiny", TINY_FN)
    epochs = 8
    overloaded = [False]

    def wait_for(cond, what):
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if cond():
                return
            time.sleep(0.02)
        raise AssertionError(f"no {what} within 60 s")

    with LocalCluster(config=cfg, device="cpu") as cluster:
        try:
            ps = cluster.ps
            ps.serving_telemetry = lambda: (tele(queue=5) if overloaded[0]
                                            else tele())
            jid = cluster.scheduler.submit_train(
                request(epochs, fn="gated", validate_every=0))

            def at_epoch_two():
                with ps._lock:
                    rec = ps._jobs.get(jid)
                return rec is not None and rec.job is not None and \
                    len(rec.job.history.train_loss) >= 1

            wait_for(at_epoch_two, "first epoch")
            overloaded[0] = True
            wait_for(lambda: ps.metrics.preemptions_snapshot(), "preemption")
            overloaded[0] = False
            gate.unlink(missing_ok=True)
            wait_for(lambda: cluster.preemption.parked_ids() == [jid] or
                     cluster.scheduler.queue.job_ids(), "park")
            parked = cluster.history_store.get(jid)
            assert 1 <= len(parked.train_loss) < epochs

            def finished():
                with ps._lock:
                    if jid in ps._jobs:
                        return False
                try:
                    return len(cluster.history_store.get(
                        jid).train_loss) == epochs
                except terrors.KubeMLError:
                    return False

            wait_for(finished, "resumed finish")
            h = cluster.history_store.get(jid)
            assert not (h.task or {}).get("error")
            assert cluster.preemption.parked_ids() == []
            assert ps.metrics.preemptions_snapshot() == {
                "serving-overload": 1}
        finally:
            gate.unlink(missing_ok=True)  # no job thread stays held
    req = request(epochs, validate_every=0)
    model = reg.load("tiny")
    model._set_params(lr=req.lr, batch_size=req.batch_size, epoch=0,
                      k=req.options.k, task="train")
    base = TrainJob("base", req, model, store=ShardStore(config=cfg),
                    history_store=HistoryStore(config=cfg),
                    checkpoint_store=CheckpointStore(config=cfg),
                    device="cpu").train()
    assert loss_parity(base.train_loss, h.train_loss), (base.train_loss,
                                                        h.train_loss)


@pytest.mark.parametrize("field,env,default", [
    ("preempt_interval", "KUBEML_PREEMPT_INTERVAL", 1.0),
    ("preempt_queue_depth", "KUBEML_PREEMPT_QUEUE_DEPTH", 8),
    ("preempt_overload_rate", "KUBEML_PREEMPT_OVERLOAD_RATE", 1.0),
    ("preempt_p99", "KUBEML_PREEMPT_P99", 0.0),
    ("preempt_sustain", "KUBEML_PREEMPT_SUSTAIN", 3),
    ("preempt_resume_sustain", "KUBEML_PREEMPT_RESUME_SUSTAIN", 5),
    ("preempt_cooldown", "KUBEML_PREEMPT_COOLDOWN", 30.0),
    ("preempt_monitor", "KUBEML_PREEMPT_MONITOR", False),
    ("standalone_jobs", "STANDALONE_JOBS", False),
    ("tensor_sockets", "KUBEML_TENSOR_SOCKETS", True),
    ("use_native_loader", "KUBEML_NATIVE_LOADER", True),
    ("dataplane_codec", "KUBEML_DATAPLANE_CODEC", "delta"),
    ("dataplane_prefetch", "KUBEML_DATAPLANE_PREFETCH", 1)])
def test_config_fields_take_jax_variables_and_defaults(field, env, default,
                                                       monkeypatch):
    monkeypatch.delenv(env, raising=False)
    assert getattr(tconfig.Config(), field) == default == \
        getattr(jconfig.Config(), field)
    value = {bool: "1", int: "4", float: "2.5", str: "raw"}[type(default)]
    monkeypatch.setenv(env, value)
    assert getattr(tconfig.Config(), field) == getattr(jconfig.Config(),
                                                       field)

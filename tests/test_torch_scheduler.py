"""The port's scheduler pieces against the JAX package's, on the CPU: the
elastic policy with its decision log, the task queue, and the job
journal.

Held exactly equal: the policy's ``(parallelism, is_new)`` answers and
every decision record (all keys but the wall time ``t``) over seeded
epoch-time sequences of several jobs (with the limit flag, reseeds of an
unseen live job, and stale updates after a finish); the queue's pop
order, snapshot and depths over mixed priorities and tenants with usage
charged between pops; and a journal written by either package recovers
in the other with the same requests."""

import json

import numpy as np
import pytest
import torch

from kubeml_tpu.api.config import Config as JConfig
from kubeml_tpu.api.types import JobState as JJobState
from kubeml_tpu.api.types import TrainOptions as JOptions
from kubeml_tpu.api.types import TrainRequest as JRequest
from kubeml_tpu.api.types import TrainTask as JTask
from kubeml_tpu.ps.journal import JobJournal as JJournal
from kubeml_tpu.scheduler import decisions as jdecisions
from kubeml_tpu.scheduler.policy import ThroughputBasedPolicy as JPolicy
from kubeml_tpu.scheduler.queue import TaskQueue as JQueue
from kubeml_tpu.scheduler.queue import TenantUsage as JUsage
from kubeml_tpu_torch.api.config import Config
from kubeml_tpu_torch.api.types import (JobState, TrainOptions, TrainRequest,
                                        TrainTask)
from kubeml_tpu_torch.ps.journal import JobJournal
from kubeml_tpu_torch.scheduler import decisions
from kubeml_tpu_torch.scheduler.policy import (ThroughputBasedPolicy,
                                               next_power_down, next_power_up)
from kubeml_tpu_torch.scheduler.queue import TaskQueue, TenantUsage


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def tasks(job_id, default_p, parallelism, elapsed, priority=0, tenant=""):
    """The same task in both packages."""
    kw = dict(function_name="f", dataset="d")
    out = []
    for Task, Req, Opt, State in ((JTask, JRequest, JOptions, JJobState),
                                  (TrainTask, TrainRequest, TrainOptions,
                                   JobState)):
        out.append(Task(job_id=job_id, parameters=Req(
            **kw, options=Opt(default_parallelism=default_p,
                              priority=priority, tenant=tenant)),
            state=State(parallelism=parallelism, elapsed_time=elapsed)))
    return out


def decision_rows(log):
    rows = []
    for job in log.jobs():
        for d in log.for_job(job):
            d = dict(d)
            d.pop("t")
            rows.append(d)
    return rows


def test_the_reason_vocabulary_is_the_jax_one():
    assert decisions.REASONS == jdecisions.REASONS
    assert decisions.DIRECTIONS == jdecisions.DIRECTIONS


@pytest.mark.parametrize("p,cap", [(0, 8), (1, 8), (3, 8), (4, 8), (8, 8),
                                   (9, 16), (5, 6)])
def test_power_steps(p, cap):
    from kubeml_tpu.scheduler.policy import next_power_down as jdown
    from kubeml_tpu.scheduler.policy import next_power_up as jup

    assert next_power_up(p, cap) == jup(p, cap)
    assert next_power_down(p) == jdown(p)


@pytest.mark.parametrize("seed,limit,cap", [(0, False, 8), (1, False, 16),
                                            (2, True, 8), (3, False, 6),
                                            (4, True, 16)])
def test_policy_and_decisions_match_jax(seed, limit, cap):
    """Three jobs over seeded epoch times: a fresh start, a run of epoch
    reports whose times move around the thresholds, an unseen live job
    (reseed), a finish and its stale update, and an id reused after it."""
    rng = np.random.default_rng(seed)
    jp = JPolicy(default_parallelism=4, max_parallelism=cap,
                 limit_parallelism=limit)
    tp = ThroughputBasedPolicy(default_parallelism=4, max_parallelism=cap,
                               limit_parallelism=limit)
    jlog, tlog = jdecisions.DecisionLog(per_job=8), decisions.DecisionLog(
        per_job=8)
    jp.bind_decision_log(jlog)
    tp.bind_decision_log(tlog)
    state = {f"job{j}": 0 for j in range(3)}
    answers = []

    def ask(job, default_p, p, elapsed):
        jt, tt = tasks(job, default_p, p, elapsed)
        want, got = jp.calculate_parallelism(jt), tp.calculate_parallelism(tt)
        answers.append((want, got))
        return got

    for job in state:
        state[job] = ask(job, int(rng.integers(0, 12)), 0, -1.0)[0]
    t = {job: 10.0 for job in state}
    for step in range(40):
        job = f"job{int(rng.integers(0, 3))}"
        # epoch times around the thresholds: 0.8-1.5x the previous
        t[job] *= float(rng.choice([0.8, 1.0, 1.04, 1.06, 1.1, 1.19, 1.2,
                                    1.5]))
        got = ask(job, 4, state[job], t[job])
        if got is not None:
            state[job] = got[0]
        if step == 15:
            ask("unseen", 4, 2, 3.0)  # a live job the policy never saw
        if step == 25:
            jp.task_finished("job1")
            tp.task_finished("job1")
            assert ask("job1", 4, state["job1"], 1.0) is None  # stale
            state["job1"] = ask("job1", 2, 0, -1.0)[0]  # the id reused
    assert all(w == g for w, g in answers), answers
    assert decision_rows(tlog) == decision_rows(jlog)
    assert tlog.counts() == jlog.counts()
    assert [tlog.total(j) for j in tlog.jobs()] == [
        jlog.total(j) for j in jlog.jobs()]


@pytest.mark.parametrize("per_job,max_jobs", [(2, 2), (64, 256)])
def test_decision_log_retention_matches_jax(per_job, max_jobs):
    jlog = jdecisions.DecisionLog(per_job=per_job, max_jobs=max_jobs)
    tlog = decisions.DecisionLog(per_job=per_job, max_jobs=max_jobs)
    for i in range(12):
        job = f"j{i % 3}"
        for log, cls in ((jlog, jdecisions.ScaleDecision),
                         (tlog, decisions.ScaleDecision)):
            log.record(cls(job_id=job, from_p=i, to_p=i, direction="hold",
                           reason="steady", cached=1.0, elapsed=1.0, t=0.0))
    assert tlog.jobs() == jlog.jobs()
    assert [tlog.for_job(j) for j in tlog.jobs()] == [
        jlog.for_job(j) for j in jlog.jobs()]
    assert [tlog.total(f"j{i}") for i in range(3)] == [
        jlog.total(f"j{i}") for i in range(3)]
    with pytest.raises(ValueError):
        tlog.record(decisions.ScaleDecision(job_id="x", from_p=1, to_p=2,
                                            direction="up", reason="nope"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_queue_pops_in_the_jax_order(seed):
    """Mixed priorities and tenants, usage charged between pops: the same
    pop order, snapshot (pop order) and per-priority depths."""
    rng = np.random.default_rng(seed)
    ju, tu = JUsage(), TenantUsage()
    jq, tq = JQueue(usage=ju), TaskQueue(usage=tu)
    popped = ([], [])
    n = 0
    for step in range(30):
        if rng.random() < 0.6 or not len(tq):
            jt, tt = tasks(f"t{n}", 4, 0, -1.0,
                           priority=int(rng.choice([0, 0, 5, 100])),
                           tenant=str(rng.choice(["", "a", "b", "c"])))
            n += 1
            jq.push(jt)
            tq.push(tt)
        else:
            assert tq.snapshot() == jq.snapshot()
            assert tq.depths() == jq.depths()
            popped[0].append(jq.pop(timeout=0).job_id)
            popped[1].append(tq.pop(timeout=0).job_id)
        if rng.random() < 0.3:
            tenant, secs = str(rng.choice(["a", "b", "c"])), float(
                rng.uniform(0, 100))
            ju.charge(tenant, secs)
            tu.charge(tenant, secs)
    while len(tq):
        popped[0].append(jq.pop(timeout=0).job_id)
        popped[1].append(tq.pop(timeout=0).job_id)
    assert popped[1] == popped[0]
    assert len(jq) == 0 and tq.pop(timeout=0) is None
    assert tu.snapshot() == ju.snapshot()


class _Submitted:
    """A scheduler double that records what recovery resubmits."""

    def __init__(self):
        self.requests = []

    def submit_train(self, req):
        self.requests.append(req.to_dict())
        return req.job_id


def _request(Req, Opt, i):
    return Req(function_name=f"fn{i}", dataset="ds", epochs=3 + i,
               batch_size=32, lr=0.05, options=Opt(
                   default_parallelism=2, k=4, checkpoint_every=1,
                   priority=i, tenant="t"))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_journal_recovers_across_packages(tmp_path, writer):
    jj = JJournal(config=JConfig(data_root=tmp_path))
    tj = JobJournal(config=Config(data_root=tmp_path))
    assert jj.dir == tj.dir
    w, Req, Opt = ((jj, JRequest, JOptions) if writer == "jax"
                   else (tj, TrainRequest, TrainOptions))
    for i in range(3):
        w.record(f"job{i}", _request(Req, Opt, i))
    w.clear("job1")
    (tj.dir / "broken.json").write_text("{not json")
    # a read-only listing skips the corrupt entry in both
    assert tj.pending(quarantine=False) == jj.pending(quarantine=False)
    got, want = _Submitted(), _Submitted()
    assert tj.recover_into(got) == 2
    # the port quarantined the corrupt entry; restore it for the JAX scan
    (tj.dir / "broken.json.corrupt").rename(tj.dir / "broken.json")
    assert jj.recover_into(want) == 2
    assert got.requests == want.requests
    assert [r["job_id"] for r in got.requests] == ["job0", "job2"]
    assert all(r["options"]["resume"] for r in got.requests)
    on_disk = json.loads((tj.dir / "job0.json").read_text())
    assert set(on_disk) == {"job_id", "request"}


@pytest.mark.parametrize("name", ["TrainTask", "InferRequest", "JobInfo",
                                  "JobState"])
def test_wire_types_parse_in_both_packages(name):
    """One JSON body parses in either package and serialises back to the
    same dict (``started_at`` is the creation time)."""
    import kubeml_tpu.api.types as jtypes

    import kubeml_tpu_torch.api.types as ttypes

    J, T = getattr(jtypes, name), getattr(ttypes, name)
    kw = {"TrainTask": dict(job_id="j1", status="running", started_at=1.5,
                            trace_parent="00-ab-cd-01"),
          "InferRequest": dict(model_id="m", data=[[1, 2], [3, 4]]),
          "JobInfo": dict(job_id="j", status="running", parallelism=4,
                          function_name="f", dataset="d"),
          "JobState": dict(parallelism=8, elapsed_time=2.5)}[name]
    want = J(**kw).to_dict()
    if name == "TrainTask":
        want["parameters"]["options"]["priority"] = 7
        want["state"] = {"parallelism": 2, "elapsed_time": 1.0}
    got = T.from_dict(json.loads(json.dumps(want)))
    assert got.to_dict() == want
    assert J.from_dict(got.to_dict()).to_dict() == want
    assert (jtypes.JobStateEnum.__dict__.keys() - {"__doc__"} ==
            ttypes.JobStateEnum.__dict__.keys() - {"__doc__"})


@pytest.mark.parametrize("grace", [None, 0, 2.5, -1, float("nan"), "x",
                                   True])
def test_parse_grace_seconds_matches_jax(grace):
    from kubeml_tpu.api.types import parse_grace_seconds as jparse

    from kubeml_tpu_torch.api.types import parse_grace_seconds

    def outcome(fn):
        try:
            return fn(grace)
        except Exception as e:
            return (type(e).__name__, str(e), getattr(e, "status_code", None))

    assert outcome(parse_grace_seconds) == outcome(jparse)

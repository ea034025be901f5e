"""Rank functions for ``tests/test_torch_spmd_ranks.py``: a cluster over
gloo ranks on the CPU, rank 0 the leader (``LocalCluster``, no HTTP unless
a job is traced: then the followers post their spans to its PS) and every
other rank a follower (``engine.follower.run_follower``).

Spawned ranks import this module to find their function, so it imports
torch and the port only, never JAX. A rank writes what the test checks to
``{out}/rank{r}.pt``; :func:`torch_dist_ranks.run` reads them back, and
:func:`exit_codes` starts ranks whose processes may end on their own
(the stall watchdog, a dead leader) and returns their exit codes.
"""

from __future__ import annotations

import os
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from kubeml_tpu_torch.api.config import Config
from kubeml_tpu_torch.api.errors import KubeMLError
from kubeml_tpu_torch.api.types import (GenerateRequest, JobState,
                                        TrainOptions, TrainRequest,
                                        TrainTask)
from kubeml_tpu_torch.parallel import distributed as D
from kubeml_tpu_torch.utils import tracing

# a token LM of JAX tests/test_spmd_job.py (vocab 64, max_len 16, E 32,
# depth 2, 4 heads), built over the job's mesh
LM_FN = """
from kubeml_tpu_torch.data.dataset import KubeDataset
from kubeml_tpu_torch.models.gpt import CausalTransformer
from kubeml_tpu_torch.parallel.trainer import adamw
from kubeml_tpu_torch.runtime.model import KubeModel

class Tokens(KubeDataset):
    def __init__(self):
        super().__init__("tokens")

class Model(KubeModel):
    def __init__(self):
        super().__init__(Tokens())
    def build(self):
        return CausalTransformer(vocab_size=64, max_len=16, embed_dim=32,
                                 depth=2, num_heads=4, mesh=self.mesh,
                                 device="cpu")
    def configure_optimizers(self, params):
        return adamw(self.lr)(params)
"""

# LM_FN's model with a MoE block every other block (4 experts, top-2)
MOE_FN = LM_FN.replace("num_heads=4, mesh=self.mesh,",
                       "num_heads=4, moe_every=2, num_experts=4,\n"
                       "                                 mesh=self.mesh,")
assert "moe_every=2" in MOE_FN

# a step that never ends: the module's forward sleeps
HANG_FN = """
import time
import torch
from kubeml_tpu_torch.data.dataset import KubeDataset
from kubeml_tpu_torch.runtime.model import KubeModel

class Hang(torch.nn.Module):
    def __init__(self, mesh):
        super().__init__()
        self.mesh = mesh
        self.w = torch.nn.Parameter(torch.zeros(4))
    def forward(self, x, train=False, return_hidden=False, **kw):
        time.sleep(3600)

class Tokens(KubeDataset):
    def __init__(self):
        super().__init__("tokens")

class Model(KubeModel):
    def __init__(self):
        super().__init__(Tokens())
    def build(self):
        return Hang(self.mesh)
    def configure_optimizers(self, params):
        return torch.optim.SGD(params, lr=self.lr)
"""


def _save(out: str, rank: int, result) -> None:
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))


def request(job_id: str, epochs: int, **opts) -> TrainRequest:
    """The tests' SPMD request: B 16, lr 1e-3, f32, validated every
    epoch."""
    opts.setdefault("engine", "spmd")
    opts.setdefault("precision", "f32")
    opts.setdefault("validate_every", 1)
    return TrainRequest(batch_size=16, epochs=epochs, dataset="tokens",
                        lr=1e-3, function_name=opts.pop("fn", "lmfn"),
                        job_id=job_id, options=TrainOptions(**opts))


def _history(cluster, job_id: str) -> dict:
    h = cluster.history_store.get(job_id)
    return dict(train_loss=list(h.train_loss),
                validation_loss=list(h.validation_loss),
                accuracy=list(h.accuracy), parallelism=list(h.parallelism),
                error=(h.task or {}).get("error"))


def run_job(cluster, spec: dict) -> dict:
    """One job through the leader's parameter server: ``spec`` holds the
    job id (and a ``key`` to file its result under when an id runs
    twice), epochs and options, and optionally ``levels`` (the answers of
    a stubbed ``on_epoch_end``, in order), ``probe`` (ask the live job
    for inference and generation right after its start), ``metrics``
    (keep each epoch's ``MetricUpdate`` as the parameter server takes it,
    with the ``/metrics`` line of its MoE overflow gauge right after) and
    ``trace`` (submit under a ``cli.train`` root span, the task carrying
    its context as the scheduler's would, and keep the task's merged
    trace once every follower's spans have reached the collector)."""
    ps = cluster.ps
    levels = list(spec.get("levels", ()))
    asked, updates = [], []
    if spec.get("metrics"):
        take = type(ps.metrics).update.__get__(ps.metrics)

        def update(u):
            take(u)
            gauge = [ln for ln in ps.metrics.render().splitlines()
                     if ln.startswith("kubeml_job_moe_overflow{")]
            updates.append(dict(epoch=u.epoch, moe_overflow=u.moe_overflow,
                                gauge=gauge))
        ps.metrics.update = update
    if levels:
        def answer(job_id, state):
            asked.append(state.parallelism)
            return levels.pop(0)
        ps._epoch_end = answer
    task = TrainTask(job_id=spec["id"], state=JobState(),
                     parameters=request(spec["id"], spec["epochs"],
                                        **spec["opts"]))
    out = {}
    tracer = tracing.get_tracer()
    try:
        if spec.get("trace"):
            with tracer.span("cli.train", service="cli"):
                task.trace_parent = tracing.current_context().traceparent()
                ps.start_task(task)
        else:
            ps.start_task(task)
    except KubeMLError as e:
        return dict(start_error=(e.status_code, e.message))
    with ps._lock:  # a job that could not start may be gone already
        job = getattr(ps._jobs.get(spec["id"]), "job", None)
    if spec.get("probe"):
        for what, call in (
                ("infer", lambda: ps.infer(spec["id"], [[1, 2, 3]])),
                ("generate", lambda: ps.generate(spec["id"], GenerateRequest(
                    model_id=spec["id"], prompts=[[1, 2, 3]],
                    max_new_tokens=2)))):
            try:
                call()
                out[what] = None
            except KubeMLError as e:
                out[what] = (e.status_code, e.message)
    assert ps.wait(spec["id"], timeout=240), f"job {spec['id']} hung"
    if spec.get("trace"):
        # each follower posts its spans when its part of the job ends
        followers = {f"worker-{r}" for r in range(1, D.process_count())}
        deadline = time.monotonic() + 60
        while True:
            out["trace"] = ps.get_trace(spec["id"])
            if followers <= set(out["trace"]["counters"]) or \
                    time.monotonic() > deadline:
                break
            time.sleep(0.05)
    out.update(_history(cluster, spec["id"]), status=str(task.status),
               asked=asked, last_save=getattr(job, "last_save", None),
               restore_bytes=getattr(job, "last_restore_bytes", None),
               metrics=updates)
    ps.metrics.__dict__.pop("update", None)
    return out


def cluster_rank(rank: int, out: str, spec: dict) -> None:
    """Rank 0 runs ``spec["jobs"]`` one after another through a
    ``LocalCluster`` and stops it; the others follow. Then, when
    ``spec["restore"]`` names a sharded checkpoint ``(job id, tag, mesh
    axes)``, every rank restores it onto that mesh and keeps its blocks."""
    from kubeml_tpu_torch.cluster import LocalCluster
    from kubeml_tpu_torch.engine.follower import run_follower

    assert D.init_distributed(device="cpu")
    root = spec["roots"][rank] if "roots" in spec else spec["root"]
    cfg = Config(data_root=Path(root), **spec.get("cfg", {}))
    res = {}
    # a traced world: every rank traces, and the leader serves HTTP (on
    # free ports) so that the followers can post their spans to its PS
    traced = any(job.get("trace") for job in spec["jobs"])
    if traced:
        tracing.get_tracer().enable()
        for key in ("controller_port", "scheduler_port", "ps_port",
                    "storage_port"):
            setattr(cfg, key, 0)
    if rank == 0:
        cluster = LocalCluster(config=cfg, device="cpu", serve_http=traced)
        cluster.start(recover=False)
        if traced:
            D.get_dist_context().put("test/ps_port", str(cfg.ps_port))
        try:
            res["jobs"] = {job.get("key", job["id"]): run_job(cluster, job)
                           for job in spec["jobs"]}
        finally:
            cluster.stop()
    else:
        try:
            LocalCluster(config=cfg, device="cpu", serve_http=False)
        except RuntimeError as e:
            res["cluster_refused"] = str(e)
        if traced:
            cfg.ps_port = int(D.get_dist_context().get("test/ps_port"))
        res["jobs_followed"] = run_follower(config=cfg)
    if spec.get("restore"):
        from kubeml_tpu_torch.interop.from_flax import from_flax
        from kubeml_tpu_torch.parallel.mesh import make_mesh
        from kubeml_tpu_torch.storage.sharded_checkpoint import \
            ShardedCheckpointStore

        job_id, tag, axes = spec["restore"]
        mesh = make_mesh(**axes)
        ck = ShardedCheckpointStore(root=cfg.checkpoints_dir).restore(
            job_id, tag, mesh=mesh)
        res["restore"] = dict(
            coord=mesh.coord, bytes_read=ck.bytes_read,
            blocks={k: v.numpy() for k, v in from_flax(ck.variables).items()})
    _save(out, rank, res)


def stall_rank(rank: int, out: str, spec: dict) -> None:
    """A job whose step never ends: rank 0 submits it, rank 1 follows;
    the stall watchdog must end both processes."""
    from kubeml_tpu_torch.cluster import LocalCluster
    from kubeml_tpu_torch.engine.follower import run_follower

    assert D.init_distributed(device="cpu")
    cfg = Config(data_root=Path(spec["root"]), function_timeout=3.0)
    if rank == 0:
        cluster = LocalCluster(config=cfg, device="cpu", serve_http=False)
        cluster.start(recover=False)
        cluster.ps.start_task(TrainTask(
            job_id="stall001", state=JobState(),
            parameters=request("stall001", 1, fn="hangfn",
                               static_parallelism=True, validate_every=0)))
        cluster.ps.wait("stall001", timeout=120)
    else:
        run_follower(config=cfg)
    _save(out, rank, "watchdog did not fire")


def dead_leader_rank(rank: int, out: str, spec: dict) -> None:
    """Ranks over a ``TCPStore`` on rank 0: rank 0 boots the cluster and
    its process dies; rank 1's follower loop must end, not hang."""
    from kubeml_tpu_torch.cluster import LocalCluster
    from kubeml_tpu_torch.engine.follower import run_follower

    assert D.init_distributed(coordinator_address=spec["coordinator"],
                              device="cpu")
    cfg = Config(data_root=Path(spec["root"]))
    if rank == 0:
        LocalCluster(config=cfg, device="cpu", serve_http=False).start(
            recover=False)
        time.sleep(1.0)  # the follower waits for a command meanwhile
        os._exit(0)
    t0 = time.monotonic()
    try:
        run_follower(config=cfg)
        got = "returned"
    except Exception as e:
        got = f"{type(e).__name__}: {e}"
    _save(out, rank, dict(error=got, seconds=time.monotonic() - t0))
    os._exit(0)  # the group's teardown would wait for the dead leader


def exit_codes(fn, world: int, *args, timeout_s: float = 120.0) -> list:
    """Start ``world`` ranks of ``fn(rank, out, *args)`` (as
    ``parallel.distributed.spawn`` does) and return (their exit codes,
    each rank's saved result or None), stopping any still alive after
    ``timeout_s`` (its code then reads None)."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="kubeml_ranks_") as tmp:
        out = os.path.join(tmp, "out")
        os.mkdir(out)
        ctx = mp.start_processes(
            D._rank_main, args=(fn, world, f"file://{tmp}/store",
                                (out, *args)),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        while (any(p.is_alive() for p in ctx.processes)
               and time.monotonic() < deadline):
            time.sleep(0.2)
        codes = []
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)
                codes.append(None)
            else:
                codes.append(p.exitcode)
        results = []
        for r in range(world):
            path = os.path.join(out, f"rank{r}.pt")
            results.append(torch.load(path, weights_only=False)
                           if os.path.exists(path) else None)
        return codes, results


def token_data(n: int, seed: int, l: int = 16, vocab: int = 64):
    """JAX tests/test_spmd_job.py's token rows (the last column PAD)."""
    r = np.random.default_rng(seed)
    x = r.integers(1, vocab, size=(n, l)).astype(np.int32)
    x[:, -1] = 0
    return x

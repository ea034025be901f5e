"""The follower loop of a cluster over ranks: the port of
``kubeml_tpu/engine/follower.py``.

Under ``kubeml start`` on every rank of a process group
(``parallel.distributed.init_distributed``), rank 0, the leader, boots
the control plane (``cluster.LocalCluster``) and every other rank runs
:func:`run_follower`:

* wait for the leader's next command (``DistContext.broadcast_obj``, a
  read of the process group's store, so the leader announces exactly when
  the followers wait);
* on ``train``: build the same job from the broadcast task, put an
  acknowledgement under ``kubeml/ack/{run}/{rank}`` (``ok``, or the error
  that stopped the build), wait for the leader's ``go`` and run the job:
  every collective the leader's job thread issues is issued here too, in
  the same order;
* on ``serve`` (meshed serving, the parameter server's
  ``_mesh_decoder``): build the serving mesh with the leader, and on a
  rank of it this rank's block of the finished model
  (``ps.parameter_server.load_mesh_module``), acknowledge as for a job,
  and on the leader's ``go`` keep the module for the decoder's
  ``serve_init``; then ``serve_init``, ``serve_op`` and ``serve_close``
  run this rank's shard of the leader's ``BatchingDecoder(mesh=)``
  (``serving.batcher.ServingFollower``): every forward and collective
  the leader's engine runs, in the same order;
* on ``shutdown``: return.

A follower's spans carry the service ``worker-{rank}``; a job runs under
the task's trace context (``TrainTask.trace_parent``) and its id, and at
its end the rank posts its spans to the leader's parameter server
(``utils.tracing.post_task_spans`` to ``ps_url``), so the job's trace
holds every rank.

The leader runs one job over ranks at a time (the parameter server's
dist lock), since every rank must issue its collectives in one order.
Datasets, deployed functions and checkpoints must be visible to every
rank (one data root, or a shared file system). A ``KubeMLError`` from the
job is deterministic (every rank's copy raises it at the same point, and
the leader records it), so the follower logs it and waits for the next
command; any other fault, and one of the card's that may strike this
rank alone (``engine.failures.is_one_sided_fault``), ends the process,
so that the leader's collectives with it raise instead of hanging, and
the job resumes after a restart. The stall watchdog ends a rank whose job stops making progress.
Any fault while running a serving op ends the process too (the leader
waits in the op's collectives): the leader's decoder then fails its
requests with a retryable 503, and the next request builds it again.
Run a follower alone with ``python -m kubeml_tpu_torch.engine.follower``
(the three ``KUBEML_*`` launch variables set).
"""

from __future__ import annotations

import argparse
import logging
import time
from typing import Optional

log = logging.getLogger("kubeml.follower")


def run_follower(config=None) -> int:
    """The follower's loop; returns the number of jobs it ran."""
    from ..api.config import get_config
    from ..api.errors import KubeMLError
    from ..api.types import TrainTask
    from ..functions.registry import FunctionRegistry
    from ..parallel.distributed import get_dist_context
    from ..serving.batcher import ServingFollower
    from ..storage.checkpoint import CheckpointStore
    from ..storage.history import HistoryStore
    from ..storage.store import ShardStore
    from ..utils import tracing
    from ..utils.watchdog import arm_stall_watchdog
    from . import job_class_for
    from .failures import is_one_sided_fault

    cfg = config or get_config()
    dist = get_dist_context()
    if dist.is_leader:
        raise RuntimeError("run_follower must not run on rank 0")
    # one worker rank of every job it follows: its spans read per rank in
    # the merged trace
    tracing.get_tracer().service = f"worker-{dist.rank}"
    registry = FunctionRegistry(config=cfg)
    store = ShardStore(config=cfg)
    history_store = HistoryStore(config=cfg)
    ckpt_store = CheckpointStore(config=cfg)
    serving = ServingFollower()
    jobs = 0
    log.info("follower %d/%d ready (awaiting leader commands)", dist.rank,
             dist.size)
    while True:
        cmd = dist.broadcast_obj(None)
        if not isinstance(cmd, dict) or cmd.get("cmd") == "shutdown":
            log.info("follower %d: shutdown", dist.rank)
            return jobs
        if cmd.get("cmd") == "serve":
            _serve(dist, cmd, registry, ckpt_store, serving)
            continue
        if cmd.get("cmd") in ("serve_init", "serve_op", "serve_close"):
            serving.handle(cmd)
            continue
        if cmd.get("cmd") != "train":
            log.warning("follower %d: unknown command %r", dist.rank, cmd)
            continue
        task = TrainTask.from_dict(cmd["task"])
        request = task.parameters
        # the start handshake: build the job, acknowledge, and enter the
        # collectives only after the leader's go, so a build that fails
        # here (no function or dataset on this rank) fails the job on the
        # leader instead of hanging its first collective
        job = None
        ack = "ok"
        try:
            model = registry.load(request.function_name)
            model._set_params(lr=request.lr, batch_size=request.batch_size,
                              epoch=0, k=request.options.k, task="train")
            request.options.default_parallelism = (
                task.state.parallelism
                or request.options.default_parallelism)
            job = job_class_for(request.options)(
                task.job_id, request, model, store=store,
                history_store=history_store, checkpoint_store=ckpt_store,
                dist=dist)
        except Exception as e:
            ack = f"err: {e}"
            log.error("follower %d: job %s start failed: %s", dist.rank,
                      task.job_id, e)
        dist.put(f"kubeml/ack/{cmd['run']}/{dist.rank}", ack)
        go = bool(dist.broadcast_obj(None).get("go"))
        if not go or job is None:
            log.warning("follower %d: job %s aborted before start",
                        dist.rank, task.job_id)
            continue
        job.heartbeat = time.time()  # armed against now, not the build
        guard = arm_stall_watchdog(
            job, cfg.function_timeout,
            f"dist job {task.job_id} (follower {dist.rank})")
        try:
            with tracing.use_context(
                    tracing.parse_traceparent(task.trace_parent)), \
                    tracing.bind_task(task.job_id):
                job.train()
            log.info("follower %d: job %s done", dist.rank, task.job_id)
        except KubeMLError as e:
            if is_one_sided_fault(e):
                # the other ranks did not raise this and wait for this one
                # in a collective: end the process, so theirs fail too
                raise
            log.error("follower %d: job %s failed: %s", dist.rank,
                      task.job_id, e)
        finally:
            guard.set()
            # this rank's spans to the leader's collector
            tracing.post_task_spans(cfg.ps_url, task.job_id)
        jobs += 1


def _serve(dist, cmd, registry, ckpt_store, serving) -> None:
    """A ``serve`` announcement: the serving mesh (built with every
    rank), this rank's block of the model on it, the acknowledgement,
    the leader's go."""
    from ..parallel.mesh import serving_mesh
    from ..ps.parameter_server import load_mesh_module

    mesh = serving_mesh(cmd["mesh"])
    module, ack = None, "ok"
    if mesh.member:
        try:
            module = load_mesh_module(registry, ckpt_store, cmd, mesh)
        except Exception as e:
            ack = f"err: {e}"
            log.error("follower %d: serving %s failed: %s", dist.rank,
                      cmd["model"], e)
    dist.put(f"kubeml/ack/{cmd['run']}/{dist.rank}", ack)
    go = bool(dist.broadcast_obj(None).get("go"))
    serving.pending = (module, mesh) if go and module is not None else None


def main(argv: Optional[list] = None) -> int:
    from ..parallel.distributed import init_distributed

    parser = argparse.ArgumentParser(
        prog="python -m kubeml_tpu_torch.engine.follower",
        description="a follower rank of a kubeml-tpu-torch cluster")
    parser.add_argument("--device", default=None,
                        help="cpu to run CPU ranks over gloo (default: the "
                             "card)")
    parser.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                        help="the process group's backend (default: nccl "
                             "for CUDA ranks, gloo for CPU ranks)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if not init_distributed(backend=args.backend, device=args.device):
        raise SystemExit("a follower needs a process group: set "
                         "KUBEML_COORDINATOR, KUBEML_NUM_PROCESSES and "
                         "KUBEML_PROCESS_ID")
    run_follower()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())

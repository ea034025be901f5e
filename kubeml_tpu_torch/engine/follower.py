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
* on ``shutdown``: return.

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
    from ..storage.checkpoint import CheckpointStore
    from ..storage.history import HistoryStore
    from ..storage.store import ShardStore
    from ..utils.watchdog import arm_stall_watchdog
    from . import job_class_for
    from .failures import is_one_sided_fault

    cfg = config or get_config()
    dist = get_dist_context()
    if dist.is_leader:
        raise RuntimeError("run_follower must not run on rank 0")
    registry = FunctionRegistry(config=cfg)
    store = ShardStore(config=cfg)
    history_store = HistoryStore(config=cfg)
    ckpt_store = CheckpointStore(config=cfg)
    jobs = 0
    log.info("follower %d/%d ready (awaiting leader commands)", dist.rank,
             dist.size)
    while True:
        cmd = dist.broadcast_obj(None)
        if not isinstance(cmd, dict) or cmd.get("cmd") == "shutdown":
            log.info("follower %d: shutdown", dist.rank)
            return jobs
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
        jobs += 1


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

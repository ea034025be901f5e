"""The whole control plane in one process: the port of
``kubeml_tpu/cluster.py``'s ``LocalCluster``.

Storage, PS, scheduler and controller share their stores and call each
other in process; with ``serve_http`` every service also listens on its
configured port (0: any free port, read back into the config, so
``cfg.controller_url`` and the others dial the bound ports). ``start``
resubmits the jobs a previous process journaled (``resume=True``).

``device=None`` runs the jobs and the serving engines on the card (and
raises without one); ``device="cpu"`` runs them on the CPU, as the tests
do.

In a process group of several ranks (``parallel.distributed.
init_distributed`` first) the cluster runs on rank 0 only, the leader,
and refuses to start on another rank, which runs ``engine.follower.
run_follower`` instead (JAX :42-55); its parameter server announces each
job to the followers (and, under ``serving_mesh``, each meshed decoder:
``/generate`` over the first ranks of the group), and ``stop`` stops the
running jobs and closes the meshed decoders before it releases the
followers.

With ``preempt_monitor`` the cluster runs the preemption controller
(``scheduler/preemption.py``): it watches the serving overload signals,
preempts the lowest-priority training job and parks it until serving is
calm. With ``standalone_jobs`` each job runs in a runner process of its
own (``engine/job_runner.py``); ``stop`` ends them with SIGTERM, keeping
their journal entries. Not ported: the telemetry sampler.
"""

from __future__ import annotations

import logging
from typing import Optional

from .api.config import Config, get_config
from .controller.controller import Controller
from .functions.registry import FunctionRegistry
from .ps.parameter_server import ParameterServer
from .ps.transport import PSAPI
from .scheduler.scheduler import Scheduler
from .scheduler.transport import SchedulerAPI
from .storage.history import HistoryStore
from .storage.service import StorageService
from .storage.store import ShardStore

log = logging.getLogger("kubeml.cluster")


class LocalCluster:
    """Every service in one process, sharing its stores."""

    def __init__(self, config: Optional[Config] = None, device=None,
                 serve_http: bool = True):
        self.cfg = config or get_config()
        from .parallel.distributed import get_dist_context, process_count

        self.dist = None
        if process_count() > 1:
            self.dist = get_dist_context()
            if not self.dist.is_leader:
                raise RuntimeError(
                    "LocalCluster runs on rank 0; the other ranks run "
                    "kubeml_tpu_torch.engine.follower.run_follower")
        self.cfg.ensure_dirs()
        self.serve_http = serve_http
        self.store = ShardStore(config=self.cfg)
        self.history_store = HistoryStore(config=self.cfg)
        self.registry = FunctionRegistry(config=self.cfg)
        self.ps = ParameterServer(
            registry=self.registry, store=self.store,
            history_store=self.history_store, config=self.cfg, device=device,
            dist=self.dist)
        self.scheduler = Scheduler(self.ps, config=self.cfg)
        self.ps.bind_scheduler(self.scheduler)
        self.preemption = None
        if self.cfg.preempt_monitor:
            from .scheduler.preemption import PreemptionController

            self.preemption = PreemptionController(
                self.scheduler, self.ps, config=self.cfg)
            self.scheduler.preemption = self.preemption
        self.controller = Controller(
            self.scheduler, self.ps, store=self.store,
            history_store=self.history_store, registry=self.registry,
            config=self.cfg)
        self.storage_service: Optional[StorageService] = None
        self.scheduler_api: Optional[SchedulerAPI] = None
        self.ps_api: Optional[PSAPI] = None

    def start(self, recover: bool = True) -> "LocalCluster":
        self.scheduler.start()
        if self.preemption is not None:
            self.preemption.start()
            log.info("preemption controller running (queue>=%d, 429/s>=%g, "
                     "p99>=%gs; grace %gs)", self.cfg.preempt_queue_depth,
                     self.cfg.preempt_overload_rate, self.cfg.preempt_p99,
                     self.cfg.preempt_grace)
        if self.serve_http:
            self.controller.start()
            self.cfg.controller_port = self.controller.service.port
            self.storage_service = StorageService(
                store=self.store, config=self.cfg).start()
            self.cfg.storage_port = self.storage_service.service.port
            self.scheduler_api = SchedulerAPI(self.scheduler,
                                              config=self.cfg).start()
            self.cfg.scheduler_port = self.scheduler_api.service.port
            self.ps_api = PSAPI(self.ps, config=self.cfg).start()
            self.cfg.ps_port = self.ps_api.service.port
            log.info("kubeml-torch cluster up: controller at %s",
                     self.controller.url)
        if recover:
            # jobs a previous process journaled resubmit with resume=True
            try:
                n = self.ps._journal.recover_into(self.scheduler)
                if n:
                    log.info("recovered %d interrupted job(s) from the "
                             "journal", n)
            except Exception:
                log.exception("journal recovery failed (non-fatal)")
        return self

    def stop(self) -> None:
        # jobs first (they keep their journal entries), then the followers
        # (a job over ranks holds the dist lock until its epoch ends), then
        # the scheduler: a job thread waiting for an epoch-end answer gives
        # up after update_timeout at the latest, and a stopped job answers
        # nobody
        if self.preemption is not None:
            self.preemption.stop()
        self.ps.shutdown_standalone_jobs()
        self.ps.stop_running_jobs()
        self.ps.announce_shutdown()
        self.scheduler.stop()
        if self.serve_http:
            for svc in (self.controller, self.storage_service,
                        self.scheduler_api, self.ps_api):
                if svc is not None:
                    svc.stop()
        self.ps.close()

    @property
    def controller_url(self) -> str:
        return self.controller.url

    def __enter__(self) -> "LocalCluster":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

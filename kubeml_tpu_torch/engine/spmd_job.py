"""SPMDJob, the control-plane job over the SPMD engine: the port of
``kubeml_tpu/engine/spmd_job.py``, on one card or over the ranks of a
process group.

``kubeml train --engine spmd`` deploys the same kind of function file as
a K-AVG job; its dataset is token ids ``[N, L]`` in the shard store (the
labels are ignored: language modelling trains on the tokens). The job
builds a mesh (``parallel.mesh``; the user's ``build()`` may read
``self.mesh``), trains the module with
:class:`~kubeml_tpu_torch.parallel.trainer.SPMDTrainer` and the next-token
loss, and reports per epoch the mean train loss, the eval loss and the
next-token top-1 accuracy.

* Batches are consecutive ``[batch_size, L]`` slabs; the remainder rows
  past a ``dp``-divisible batch are dropped. Step ``i`` of epoch ``e``
  draws its dropout from the seed ``fold_in(seed, e * 100003 + i)``
  (JAX's derivation with ``models.layers.fold_in``). Each step stamps
  ``heartbeat``.
* ``goal_accuracy`` (%) and ``goal_loss`` (eval loss; a perplexity target
  P is ``ln P``) stop the job early after a validated epoch.
* Checkpoints every ``checkpoint_every`` epochs, flat (``storage.
  checkpoint``, keeping ``checkpoint_keep``) or sharded under
  ``sharded_checkpoints`` (``storage.sharded_checkpoint``), weights in the
  Flax layout (``interop.from_flax.to_flax``); ``resume`` continues from
  the newest of them (``engine.resume``; a sharded job falls back to a
  flat checkpoint), onto the job's own mesh whatever mesh wrote it.
  ``preempt()`` leaves at the next step (the next epoch over ranks) and
  writes a resume checkpoint in place of the final export, which a
  finished job writes flat, or sharded under ``sharded_checkpoints``.
* ``infer`` and ``generate`` serve the live model between steps (under
  the step lock) on one card, and answer 409 over ranks.

**Over ranks** (``dist``, a ``parallel.distributed.DistContext`` of
several ranks; JAX :65-137, 197-402, 422-615). One rank stands for one
JAX device: the job over a world of N ranks is JAX's job over N devices,
its mesh ``mesh_shape_for(N, **mesh_shape)`` with ``dp`` filling the
rest. Every rank runs the same job in lockstep and feeds every step the
same global batch (the trainer takes its block). Rank 0 (the leader, whose
job thread the parameter server runs) decides and broadcasts over the
store: stop at each epoch's top (no break mid-epoch, which would strand
the others in a collective), the epoch's metrics (so every rank's history
and goal checks agree), the elastic level, the preempt decision before
the save branch, and the resume checkpoint. The leader alone pushes
metrics (a MoE model's overflow among them, global on every rank),
writes flat checkpoints (``_host_params`` gathers the ``tp`` shards, a
pipelined model's ``pp`` stages and a MoE model's ``ep`` experts
collectively first; only
the disk write is non-fatal) and saves the history; a sharded save is
written by every rank, each its own slices, behind three world
barriers.

The elastic remesh (JAX :422-494) resizes ``dp`` between epochs when the
scheduler asks (``pp``, ``ep``, ``sp`` and ``tp``, the model axes, stay
as the request set them): :func:`spmd_elastic_device_count` with ``size`` the
number of hosts (every host contributes equally; on one host the first
``k`` ranks form the mesh, as JAX takes the first ``k`` devices of one
process: with ``size`` the world the count could never fall below it).
The parameters are gathered on the old mesh, given to the ranks that
join (a broadcast over the world from rank 0), placed by ``shard_tree``
on a module built again over the new mesh, and the optimizer restarts, as
in JAX. A rank outside the mesh skips the steps and the validation of an
epoch but reaches every broadcast and barrier; the ``parallelism`` history
reads the mesh's size.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as tdist

from ..api.errors import KubeMLError
from ..api.types import History, JobState, MetricUpdate, TrainRequest
from ..interop.from_flax import from_flax, gather_tree, shard_tree, to_flax
from ..models.layers import fold_in, load_tree
from ..parallel import distributed
from ..parallel.mesh import make_mesh, mesh_shape_for
from ..parallel.trainer import SPMDTrainer
from ..storage.checkpoint import FINAL_TAG, CheckpointStore
from ..storage.history import HistoryStore
from ..storage.sharded_checkpoint import ShardedCheckpointStore
from ..storage.store import ShardStore
from ..utils.device import resolve_device
from ..utils.profiler import tree_nbytes
from ..utils.tracing import get_tracer

log = logging.getLogger("kubeml.spmdjob")


def spmd_elastic_device_count(new_p: int, n_devices: int, model: int,
                              size: int = 1) -> int:
    """The legal device count for an elastic SPMD level (JAX :53): a
    multiple of ``model * size`` at most ``n_devices``, at least one such
    block."""
    base = max(1, model) * max(1, size)
    return max(base, (min(new_p, n_devices) // base) * base)


class SPMDJob:
    """The TrainJob surface (``train``/``stop``/``preempt``/``state``/
    ``infer``/``generate``) over the SPMD engine, on one device or over
    ranks (see the module docstring)."""

    def __init__(
        self,
        job_id: str,
        request: TrainRequest,
        model,
        store: Optional[ShardStore] = None,
        history_store: Optional[HistoryStore] = None,
        checkpoint_store: Optional[CheckpointStore] = None,
        on_epoch_end: Optional[Callable[[JobState], int]] = None,
        on_metrics: Optional[Callable[[MetricUpdate], None]] = None,
        device=None,
        seed: int = 0,
        dist=None,
    ):
        if dist is None and distributed.process_count() > 1:
            dist = distributed.get_dist_context()
        self.dist = dist
        self._multi = dist is not None and dist.size > 1
        self._leader = dist is None or dist.is_leader
        world = dist.size if self._multi else 1
        request.options.check_ported(world)
        self.job_id = job_id
        self.request = request
        self.model = model
        self.store = store or ShardStore()
        self.history_store = history_store or HistoryStore()
        self._checkpoint_store = checkpoint_store
        self.on_epoch_end = on_epoch_end
        self.on_metrics = on_metrics
        self.seed = seed
        self._shape = mesh_shape_for(world,
                                     **(request.options.mesh_shape or {}))
        # the model axes are fixed for the job's life; elasticity moves dp
        self._model_axes = {ax: s for ax, s in self._shape.items()
                            if ax != "dp"}
        self.mesh = None
        self.trainer: Optional[SPMDTrainer] = None
        if self._multi:
            # the mesh's process groups connect the ranks: they are made in
            # train(), which every rank enters together (a follower builds
            # its job only once the leader has announced it)
            self.device = distributed.local_device()
        else:
            self.device = resolve_device(device)
            self._setup()
        self.history = History(id=job_id, task={"request": request.to_dict()})
        self.stop_event = threading.Event()
        # checkpoint-and-yield: preempt() rides the stop machinery, but the
        # job then writes a resume checkpoint instead of the final export
        self.preempt_event = threading.Event()
        self.preempt_requested_at: Optional[float] = None
        # progress stamp for the stall watchdog; heartbeat_cold doubles its
        # allowance while the first step runs (it builds the kernels)
        self.heartbeat: Optional[float] = time.time()
        self.heartbeat_cold = True
        self.tracer = get_tracer()
        self.exit_error: Optional[str] = None
        self._dataset_handle = None
        self._initialized = False
        # live infer/generate and a train step never run at once
        self._step_lock = threading.Lock()
        # this rank's last sharded save ({"bytes", "seconds"}), the stored
        # bytes its last sharded restore read, each remesh's seconds
        self.last_save: Optional[dict] = None
        self.last_restore_bytes: Optional[int] = None
        self.remesh_seconds: list = []

    def _setup(self) -> None:
        """The job's mesh (over every rank, or this one device) and a
        trainer over the module the function builds on it."""
        if self._multi:
            self.mesh = make_mesh(shape=self._shape)
        else:
            self.mesh = make_mesh(shape=self._shape, devices=[self.device])
        # the user's build() may read self.mesh
        self.model.mesh = self.mesh
        self.trainer = self._make_trainer()

    def _make_trainer(self) -> SPMDTrainer:
        """A trainer over the module the function builds on ``self.mesh``
        (a fresh optimizer)."""
        module = self.model.module.to(self.device)
        return SPMDTrainer(module, self.mesh,
                           optimizer=self.model.configure_optimizers,
                           precision=self.request.options.precision,
                           input_transform=self.model.preprocess)

    # --- TrainJob surface ---

    def stop(self) -> None:
        self.stop_event.set()

    def preempt(self) -> None:
        """Checkpoint-and-yield: leave at the next step (epoch over ranks),
        write a resume checkpoint, report ``preempted``. Idempotent."""
        if self.preempt_requested_at is None:
            self.preempt_requested_at = time.time()
        self.preempt_event.set()
        self.stop_event.set()

    @property
    def preempted(self) -> bool:
        return self.preempt_event.is_set()

    @property
    def state(self) -> JobState:
        return JobState(parallelism=(self.mesh.size if self.mesh is not None
                                     else self.dist.size))

    @property
    def checkpoint_store(self) -> CheckpointStore:
        if self._checkpoint_store is None:
            self._checkpoint_store = CheckpointStore()
        return self._checkpoint_store

    # --- data ---

    @property
    def _handle(self):
        if self._dataset_handle is None:
            self._dataset_handle = self.store.get(self.request.dataset)
        return self._dataset_handle

    def _token_batches(self, split: str, batch: int):
        """Global ``[batch, L]`` int64 token slabs; the remainder rows are
        dropped (a batch tiles the mesh's dp axis)."""
        n = self._handle.num_samples(split)
        x = self._handle.raw(split, "data")
        dp = int(self.mesh.shape.get("dp", 1))
        batch = max(dp, (batch // dp) * dp)
        for a in range(0, n - batch + 1, batch):
            yield torch.from_numpy(
                np.ascontiguousarray(x[a:a + batch]).astype(np.int64))

    # --- main loop ---

    def train(self) -> History:
        req = self.request
        opts = req.options
        multi = self._multi
        try:
            if self.mesh is None:
                self._setup()
            first = next(self._token_batches("train", req.batch_size), None)
            if first is None:
                raise KubeMLError(
                    f"dataset {req.dataset!r} has fewer than one dp-divisible "
                    f"batch of {req.batch_size}")
            self.trainer.init(first)
            self._initialized = True
            log.info("%s: SPMD job on mesh %s", self.job_id, self.mesh.shape)
            start_epoch = self._restore_latest() if opts.resume else 0
            for epoch in range(start_epoch, req.epochs):
                stop = self.stop_event.is_set()
                if multi:
                    # the leader's decision: no rank leaves the lockstep
                    # loop while the others still issue collectives
                    stop, _ = self.dist.broadcast_flags(stop=stop)
                    if stop:
                        self.stop_event.set()
                if stop:
                    break
                t0 = time.time()
                member = self.mesh.member
                if not member:
                    # waiting for the members is no stall
                    self.heartbeat = None
                losses = []
                with self.tracer.span("job.epoch", service="worker",
                                      job=self.job_id, epoch=epoch,
                                      engine="spmd"):
                    for i, batch in enumerate(
                            self._token_batches("train", req.batch_size)
                            if member else ()):
                        if self.stop_event.is_set() and not multi:
                            break
                        with self._step_lock:
                            losses.append(self.trainer.train_step(
                                batch, rng=fold_in(self.seed,
                                                   epoch * 100003 + i)))
                        self.heartbeat = time.time()
                        self.heartbeat_cold = False
                if member and not losses:
                    break  # stopped before the epoch's first step
                # the epoch's one device->host read of its losses
                train_loss = (float(torch.stack(losses).float().mean())
                              if losses else None)
                elapsed = time.time() - t0
                used = self.mesh.size
                # validation is collective over ranks: it is never skipped
                # on one side (a preempt may reach the leader mid-epoch)
                val_loss = acc_pct = None
                if (member and opts.validate_every > 0
                        and not (self.preempt_event.is_set() and not multi)
                        and (epoch + 1) % opts.validate_every == 0):
                    val_loss, token_acc = self._validate()
                    if token_acc is not None:
                        acc_pct = token_acc * 100.0
                if multi:
                    # the leader's numbers on every rank: the histories and
                    # the goal checks below agree, members or not
                    got = self.dist.broadcast_obj(
                        [train_loss, val_loss, acc_pct] if self._leader
                        else None)
                    train_loss, val_loss, acc_pct = got
                    self.heartbeat = time.time()
                self.history.append_epoch(
                    train_loss=train_loss, parallelism=used,
                    duration=elapsed, validation_loss=val_loss,
                    accuracy=acc_pct)
                if self._leader:
                    self._push_metrics(train_loss, val_loss, acc_pct,
                                       elapsed, used, epoch + 1)
                log.info("%s: epoch %d/%d loss=%.4f val=%s acc=%s %.2fs",
                         self.job_id, epoch + 1, req.epochs, train_loss,
                         f"{val_loss:.4f}" if val_loss is not None else "-",
                         f"{acc_pct:.2f}%" if acc_pct is not None else "-",
                         elapsed)
                if (opts.checkpoint_every > 0
                        and (epoch + 1) % opts.checkpoint_every == 0):
                    self._save_checkpoint(epoch)
                if acc_pct is not None and acc_pct >= opts.goal_accuracy:
                    log.info("%s: goal accuracy %.2f%% reached (%.2f%%)",
                             self.job_id, opts.goal_accuracy, acc_pct)
                    break
                if (opts.goal_loss > 0.0 and val_loss is not None
                        and val_loss <= opts.goal_loss):
                    log.info("%s: goal eval loss %.4f reached (%.4f)",
                             self.job_id, opts.goal_loss, val_loss)
                    break
                # the elastic level: the leader asks the scheduler, every
                # rank remeshes to the broadcast answer
                if not opts.static_parallelism and (
                        self.on_epoch_end is not None or multi):
                    new_p = None
                    if self._leader and self.on_epoch_end is not None:
                        new_p = self.on_epoch_end(
                            JobState(parallelism=used, elapsed_time=elapsed))
                    if multi:
                        _, p = self.dist.broadcast_flags(
                            parallelism=new_p or 0)
                        new_p = p or None
                    if new_p:
                        self._remesh(new_p)
            # the save branches hold collectives: every rank takes the
            # leader's branch (a preempt reaches the leader alone)
            preempted = self.preempt_event.is_set()
            if multi:
                preempted = bool(self.dist.broadcast_obj(
                    preempted if self._leader else None))
                if preempted:
                    self.preempt_event.set()
            if preempted:
                # the final export belongs to a finished job only
                if self.history.train_loss:
                    self._save_checkpoint(len(self.history.train_loss) - 1)
            elif opts.save_model and self.history.train_loss:
                completed = len(self.history.train_loss)
                if opts.sharded_checkpoints:
                    self._save_checkpoint_sharded(completed, tag=FINAL_TAG)
                else:
                    final = self._host_params()  # collective over ranks
                    if self._leader:
                        self.checkpoint_store.save(
                            self.job_id, to_flax(final), epoch=completed,
                            tag=FINAL_TAG, meta=self._meta())
        except KubeMLError as e:
            self.exit_error = e.message
            raise
        except Exception as e:
            self.exit_error = str(e)
            raise KubeMLError(f"job {self.job_id} failed: {e}") from e
        finally:
            if (self.exit_error is not None
                    and isinstance(self.history.task, dict)):
                self.history.task["error"] = self.exit_error
            if self._leader:
                self.history_store.save(self.history)
        return self.history

    # --- the elastic remesh ---

    def _remesh_ranks(self, new_p: int):
        """(rank count, the ranks, model-axis product) of an elastic
        level: each host gives its first ``count / hosts`` ranks."""
        model = max(1, int(np.prod(list(self._model_axes.values()))))
        if not self._multi:
            return spmd_elastic_device_count(new_p, 1, model), [0], model
        hosts = distributed.rank_hosts()
        order = list(dict.fromkeys(hosts))
        n = spmd_elastic_device_count(new_p, len(hosts), model, len(order))
        per = n // len(order)
        chosen = sorted(r for h in order
                        for r in [i for i, x in enumerate(hosts)
                                  if x == h][:per])
        return n, chosen, model

    def _remesh(self, new_p: int) -> None:
        """Resize ``dp`` between epochs (JAX :464-494). Collective over
        ranks: the parameters are gathered on the old mesh, broadcast from
        rank 0 to the ranks that join, and placed on a module built again
        over the new mesh; the optimizer restarts."""
        n, chosen, model = self._remesh_ranks(new_p)
        if n == self.mesh.size:
            if n != new_p:
                log.info("%s: scheduler asked for %d devices; the job keeps "
                         "its %d", self.job_id, new_p, n)
            return
        t0 = time.perf_counter()
        log.info("%s: elastic remesh %d -> %d ranks (dp=%d, model axes %s)",
                 self.job_id, self.mesh.size, n, n // model,
                 self._model_axes or "{}")
        host = self._host_params()
        if set(chosen) - set(self.mesh.ranks):
            box = [host]
            tdist.broadcast_object_list(box, src=0)
            host = box[0]
        mesh = make_mesh(shape=dict(self._model_axes, dp=n // model),
                         ranks=chosen)
        with self._step_lock:
            self.mesh = mesh
            self.model.rebind_mesh(mesh)
            self.trainer = None
            if mesh.member:
                self.trainer = self._make_trainer()
                self._load(host)
                self.trainer.init()
        self.remesh_seconds.append(time.perf_counter() - t0)

    # --- internals ---

    def _validate(self):
        """(mean eval loss, mean next-token accuracy) over the test
        split's batches, (None, None) with none."""
        self.heartbeat = time.time()
        losses, accs = [], []
        with self.tracer.span("job.validate", service="worker",
                              job=self.job_id, engine="spmd"):
            for batch in self._token_batches("test",
                                             self.request.batch_size):
                with self._step_lock:
                    l, a = self.trainer.eval_metrics(batch)
                self.heartbeat = time.time()
                losses.append(l)
                accs.append(a)
        if not losses:
            return None, None
        return float(np.mean(losses)), float(np.mean(accs))

    def _host_params(self) -> Optional[dict]:
        """``{dotted name: CPU tensor}``, every leaf whole; collective over
        the mesh's ranks (the ``tp`` shards, ``pp`` stages and ``ep`` expert
        parts gathered).
        None off the mesh."""
        if not self.mesh.member:
            return None
        with self._step_lock:
            flat = gather_tree(dict(self.model.module.named_parameters()),
                               self.mesh)
            return {name: t.detach().cpu().clone()
                    for name, t in flat.items()}

    def _flax_params(self) -> dict:
        """This rank's parameters (its shards over ranks) on the host in
        the Flax layout (``{"params": nested tree}``); {} off the mesh."""
        if not self.mesh.member:
            return {}
        with self._step_lock:
            return to_flax({name: p.detach().cpu().clone() for name, p
                            in self.model.module.named_parameters()})

    def _meta(self) -> dict:
        h = self.history
        return {"request": self.request.to_dict(), "history": {
            key: list(getattr(h, key)) for key in (
                "train_loss", "validation_loss", "accuracy", "parallelism",
                "epoch_duration")}}

    def _sharded_store(self) -> ShardedCheckpointStore:
        return ShardedCheckpointStore(root=self.checkpoint_store.root)

    def _save_checkpoint(self, epoch: int) -> None:
        """The epoch checkpoint (flat or sharded). The flat gather is
        collective and stays outside the guard; only the leader's disk
        write is non-fatal, as in JAX. A failed sharded write raises."""
        self.heartbeat = time.time()
        if self.request.options.sharded_checkpoints:
            self._save_checkpoint_sharded(epoch)
            return
        with self.tracer.span("job.checkpoint", service="worker",
                              job=self.job_id, epoch=epoch) as span:
            variables = self._host_params()
            if not self._leader:
                return
            if span is not None:
                span.attrs["bytes"] = tree_nbytes(variables)
            try:
                self.checkpoint_store.save(self.job_id, to_flax(variables),
                                           epoch=epoch, meta=self._meta())
                self.checkpoint_store.prune_epochs(
                    self.job_id, self.request.options.checkpoint_keep)
            except Exception:
                log.exception("%s: checkpoint save failed (non-fatal)",
                              self.job_id)

    def _save_checkpoint_sharded(self, epoch: int,
                                 tag: Optional[str] = None) -> None:
        """A sharded checkpoint under the epoch tag (or ``tag``; the final
        export passes ``FINAL_TAG`` with the completed-epoch count): every
        rank writes the slices it owns, behind world barriers over ranks."""
        barrier = None
        if self._multi:
            barrier = lambda t: self.dist.barrier(f"{t}/{epoch}")  # noqa: E731
        store = self._sharded_store()
        with self.tracer.span("job.checkpoint", service="worker",
                              job=self.job_id, epoch=epoch,
                              sharded=True) as span:
            store.save(self.job_id, self._flax_params(), epoch=epoch,
                       tag=tag or f"ep{epoch:05d}", meta=self._meta(),
                       mesh=self.mesh, barrier=barrier)
            if span is not None and store.last_save:
                span.attrs["bytes"] = int(store.last_save["bytes"])
        self.last_save = store.last_save

    def _load(self, flat) -> None:
        """Load whole leaves (``{dotted name: tensor}``) as this rank's
        shards."""
        load_tree(self.model.module, shard_tree(flat, self.mesh))

    def _restore_latest(self) -> int:
        """Restore the newest checkpoint into the module with its history;
        returns the epoch to go on from (0: none). Over ranks the leader
        picks the checkpoint and every rank reads the same one. The
        optimizer state restarts, as in JAX."""
        from .resume import extend_history, select_resume_checkpoint

        if self.request.options.sharded_checkpoints:
            start = self._restore_sharded()
            if start >= 0:
                return start
            # a job may turn sharded checkpoints on and resume from an
            # older flat one
        if self._multi:
            sel = None
            if self._leader:
                best = select_resume_checkpoint(self.checkpoint_store,
                                                self.job_id)
                if best is not None:
                    sel = [best[0], best[1].tag]
            sel = self.dist.broadcast_obj(sel)
            if sel is None:
                return 0
            start_epoch = int(sel[0])
            ck = self.checkpoint_store.restore(self.job_id, tag=sel[1])
        else:
            best = select_resume_checkpoint(self.checkpoint_store,
                                            self.job_id)
            if best is None:
                return 0
            start_epoch, ck = best
        with self._step_lock:
            self._load(from_flax(ck.variables))
        extend_history(self.history, ck)
        log.info("%s: resumed from checkpoint %s (epoch %d)", self.job_id,
                 ck.tag, start_epoch)
        return start_epoch

    def _sharded_pick(self):
        """(start epoch, tag) of the newest sharded checkpoint: an epoch
        tag ``epN`` starts at N + 1, the final export at its recorded
        epoch, the further one wins (JAX :589-607); None when there is
        none."""
        store = self._sharded_store()
        tags = store.tags(self.job_id)
        candidates = []
        ep_tags = sorted(t for t in tags if t.startswith("ep"))
        if ep_tags:
            last = ep_tags[-1]
            candidates.append(
                (int(store.read_manifest(self.job_id, last)["epoch"]) + 1,
                 last))
        if FINAL_TAG in tags:
            candidates.append(
                (int(store.read_manifest(self.job_id, FINAL_TAG)["epoch"]),
                 FINAL_TAG))
        return max(candidates) if candidates else None

    def _restore_sharded(self) -> int:
        """Resume from the newest sharded checkpoint onto this job's mesh,
        which may differ from the writer's: each rank reads only the
        stored slices its blocks overlap (JAX :576-615). -1 when there is
        none."""
        from .resume import extend_history

        pick = self._sharded_pick() if self._leader else None
        if self._multi:
            pick = self.dist.broadcast_obj(pick)
        if pick is None:
            return -1
        start, tag = pick
        ck = self._sharded_store().restore(self.job_id, tag, mesh=self.mesh)
        with self._step_lock:
            load_tree(self.model.module, from_flax(ck.variables))
        self.last_restore_bytes = ck.bytes_read
        extend_history(self.history, ck)
        log.info("%s: resumed from sharded checkpoint %s (epoch %d, %d "
                 "bytes read)", self.job_id, tag, start, ck.bytes_read)
        return int(start)

    def _push_metrics(self, train_loss, val_loss, acc_pct, elapsed,
                      parallelism, epochs_done: int) -> None:
        if self.on_metrics is None:
            return
        try:
            over = self.trainer.last_moe_overflow
            self.on_metrics(MetricUpdate(
                job_id=self.job_id, train_loss=float(train_loss),
                validation_loss=(float(val_loss) if val_loss is not None
                                 else 0.0),
                accuracy=float(acc_pct) if acc_pct is not None else 0.0,
                parallelism=parallelism, epoch=int(epochs_done),
                epoch_duration=float(elapsed), moe_overflow=float(over)))
        except Exception:
            log.exception("%s: metrics push failed (non-fatal)", self.job_id)

    # --- live serving ---

    def _live(self, what: str) -> None:
        """Raise unless the live model can serve ``what`` now."""
        if self._multi:
            # serving mid-training would need collectives the other ranks
            # are not at; the finished model serves from its checkpoint
            raise KubeMLError(
                f"job {self.job_id} is training over {self.dist.size} "
                f"ranks; {what} is served from its checkpoint after it "
                f"finishes", 409)
        if not self._initialized:
            raise KubeMLError(f"job {self.job_id} has no model yet", 400)

    def infer(self, x: np.ndarray):
        """Greedy next-token ids for each position of a token batch."""
        self._live("inference")
        module = self.model.module
        with self._step_lock, torch.no_grad():
            tokens = torch.as_tensor(np.asarray(x), dtype=torch.int64,
                                     device=self.device)
            logits = module(self.model.preprocess(tokens), train=False)
            return logits.argmax(dim=-1).cpu().numpy()

    def generate(self, req) -> dict:
        """Serve a ``GenerateRequest`` from the live model (the one-shot
        ``generate_from_request``), between train steps."""
        self._live("generation")
        from ..models.generation import generate_from_request

        with self._step_lock:
            return generate_from_request(self.model.module, req)

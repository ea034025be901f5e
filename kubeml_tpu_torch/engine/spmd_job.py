"""SPMDJob, the control-plane job over the SPMD engine: the port of
``kubeml_tpu/engine/spmd_job.py`` on one card.

``kubeml train --engine spmd`` deploys the same kind of function file as
a K-AVG job; its dataset is token ids ``[N, L]`` in the shard store (the
labels are ignored: language modelling trains on the tokens). The job
builds a one-device mesh (``parallel.mesh``; the user's ``build()`` may
read ``self.mesh``), trains the module with
:class:`~kubeml_tpu_torch.parallel.trainer.SPMDTrainer` and the next-token
loss, and reports per epoch the mean train loss, the eval loss and the
next-token top-1 accuracy.

* Batches are consecutive ``[batch_size, L]`` slabs; the remainder rows
  are dropped. Step ``i`` of epoch ``e`` draws its dropout from the seed
  ``fold_in(seed, e * 100003 + i)`` (JAX's derivation with
  ``models.layers.fold_in``). Each step stamps ``heartbeat``.
* ``goal_accuracy`` (%) and ``goal_loss`` (eval loss; a perplexity target
  P is ``ln P``) stop the job early after a validated epoch.
* The scheduler's ``on_epoch_end`` is asked after each epoch unless
  ``static_parallelism``; on one device every answer maps to the one
  device (:func:`spmd_elastic_device_count`), so the mesh stays and the
  answer is logged.
* Checkpoints every ``checkpoint_every`` epochs, flat (``storage.
  checkpoint``, keeping ``checkpoint_keep``) or sharded under
  ``sharded_checkpoints`` (``storage.sharded_checkpoint``), weights in the
  Flax layout (``interop.from_flax.to_flax``); ``resume`` continues from
  the newest of them (``engine.resume``; a sharded job falls back to a
  flat checkpoint). ``preempt()`` leaves at the next step and writes a
  resume checkpoint in place of the final export, which a finished job
  writes flat, or sharded under ``sharded_checkpoints``.
* ``infer`` and ``generate`` serve the live model between steps (under
  the step lock).

Not ported (ROADMAP Queue 1 item 1): a job over several ranks (the SPMD
job over ranks with followers, ``engine/follower.py``, its elastic remesh
and sharded saves from several processes; ``check_ported`` refuses its
mesh with a 400), multi-host ``dist``, and tracer spans. The trainer
itself runs over ranks (``parallel.trainer``).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..api.errors import KubeMLError
from ..api.types import History, JobState, MetricUpdate, TrainRequest
from ..interop.from_flax import from_flax, to_flax
from ..models.layers import fold_in, load_tree
from ..parallel.mesh import make_mesh, mesh_shape_for
from ..parallel.trainer import SPMDTrainer
from ..storage.checkpoint import FINAL_TAG, CheckpointStore
from ..storage.history import HistoryStore
from ..storage.sharded_checkpoint import ShardedCheckpointStore
from ..storage.store import ShardStore
from ..utils.device import resolve_device

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
    ``infer``/``generate``) over the SPMD engine on one device."""

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
    ):
        request.options.check_ported()
        self.job_id = job_id
        self.request = request
        self.model = model
        self.store = store or ShardStore()
        self.history_store = history_store or HistoryStore()
        self._checkpoint_store = checkpoint_store
        self.on_epoch_end = on_epoch_end
        self.on_metrics = on_metrics
        self.seed = seed
        self.device = resolve_device(device)
        shape = mesh_shape_for(1, **(request.options.mesh_shape or {}))
        self._model_axes = {ax: s for ax, s in shape.items() if ax != "dp"}
        self.mesh = make_mesh(shape=shape, devices=[self.device])
        # the user's build() may read self.mesh
        model.mesh = self.mesh
        model.module.to(self.device)
        self.trainer = SPMDTrainer(
            model.module, self.mesh,
            optimizer=model.configure_optimizers,
            precision=request.options.precision,
            input_transform=model.preprocess)
        self.history = History(id=job_id, task={"request": request.to_dict()})
        self.stop_event = threading.Event()
        # checkpoint-and-yield: preempt() rides the stop machinery, but the
        # job then writes a resume checkpoint instead of the final export
        self.preempt_event = threading.Event()
        self.preempt_requested_at: Optional[float] = None
        self.heartbeat = time.time()
        self.exit_error: Optional[str] = None
        self._dataset_handle = None
        self._initialized = False
        # live infer/generate and a train step never run at once
        self._step_lock = threading.Lock()

    # --- TrainJob surface ---

    def stop(self) -> None:
        self.stop_event.set()

    def preempt(self) -> None:
        """Checkpoint-and-yield: leave at the next step, write a resume
        checkpoint, report ``preempted``. Idempotent."""
        if self.preempt_requested_at is None:
            self.preempt_requested_at = time.time()
        self.preempt_event.set()
        self.stop_event.set()

    @property
    def preempted(self) -> bool:
        return self.preempt_event.is_set()

    @property
    def state(self) -> JobState:
        return JobState(parallelism=len(self.mesh.devices))

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
        """``[batch, L]`` int64 token slabs; the remainder rows are
        dropped (a batch tiles the mesh's dp axis, 1 here)."""
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
        try:
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
                if self.stop_event.is_set():
                    break
                t0 = time.time()
                losses = []
                for i, batch in enumerate(
                        self._token_batches("train", req.batch_size)):
                    if self.stop_event.is_set():
                        break
                    with self._step_lock:
                        losses.append(self.trainer.train_step(
                            batch, rng=fold_in(self.seed,
                                               epoch * 100003 + i)))
                    self.heartbeat = time.time()
                if not losses:
                    break  # stopped before the epoch's first step
                # the epoch's one device->host read of its losses
                train_loss = float(torch.stack(losses).float().mean())
                elapsed = time.time() - t0
                used = len(self.mesh.devices)
                val_loss = acc_pct = None
                if (opts.validate_every > 0
                        and not self.preempt_event.is_set()
                        and (epoch + 1) % opts.validate_every == 0):
                    val_loss, token_acc = self._validate()
                    if token_acc is not None:
                        acc_pct = token_acc * 100.0
                self.history.append_epoch(
                    train_loss=train_loss, parallelism=used,
                    duration=elapsed, validation_loss=val_loss,
                    accuracy=acc_pct)
                self._push_metrics(train_loss, val_loss, acc_pct, elapsed,
                                   used, epoch + 1)
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
                if (not opts.static_parallelism
                        and self.on_epoch_end is not None):
                    new_p = self.on_epoch_end(
                        JobState(parallelism=used, elapsed_time=elapsed))
                    if new_p:
                        self._remesh(new_p)
            if self.preempt_event.is_set():
                # the final export belongs to a finished job only
                if self.history.train_loss:
                    self._save_checkpoint(len(self.history.train_loss) - 1)
            elif opts.save_model and self.history.train_loss:
                completed = len(self.history.train_loss)
                if opts.sharded_checkpoints:
                    self._save_checkpoint_sharded(completed, tag=FINAL_TAG)
                else:
                    self.checkpoint_store.save(
                        self.job_id, self._flax_params(), epoch=completed,
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
            self.history_store.save(self.history)
        return self.history

    # --- internals ---

    def _remesh(self, new_p: int) -> None:
        """The elastic level the scheduler asked for, on this job's
        devices: with one device it is that device, so the mesh stays."""
        model = max(1, int(np.prod(list(self._model_axes.values()))))
        n = spmd_elastic_device_count(new_p, len(self.mesh.devices), model)
        if n != new_p:
            log.info("%s: scheduler asked for %d devices; the job keeps its "
                     "%d", self.job_id, new_p, n)

    def _validate(self):
        """(mean eval loss, mean next-token accuracy) over the test
        split's batches, (None, None) with none."""
        self.heartbeat = time.time()
        losses, accs = [], []
        for batch in self._token_batches("test", self.request.batch_size):
            with self._step_lock:
                l, a = self.trainer.eval_metrics(batch)
            self.heartbeat = time.time()
            losses.append(l)
            accs.append(a)
        if not losses:
            return None, None
        return float(np.mean(losses)), float(np.mean(accs))

    def _flax_params(self) -> dict:
        """The module's parameters on the host in the Flax layout
        (``{"params": nested tree}``), the checkpoints' tree."""
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
        """The epoch checkpoint (flat or sharded). A failed flat write is
        logged, as in JAX; a failed sharded write raises."""
        self.heartbeat = time.time()
        if self.request.options.sharded_checkpoints:
            self._save_checkpoint_sharded(epoch)
            return
        variables = self._flax_params()
        try:
            self.checkpoint_store.save(self.job_id, variables, epoch=epoch,
                                       meta=self._meta())
            self.checkpoint_store.prune_epochs(
                self.job_id, self.request.options.checkpoint_keep)
        except Exception:
            log.exception("%s: checkpoint save failed (non-fatal)",
                          self.job_id)

    def _save_checkpoint_sharded(self, epoch: int,
                                 tag: Optional[str] = None) -> None:
        """A sharded checkpoint under the epoch tag (or ``tag``; the final
        export passes ``FINAL_TAG`` with the completed-epoch count)."""
        self._sharded_store().save(
            self.job_id, self._flax_params(), epoch=epoch,
            tag=tag or f"ep{epoch:05d}", meta=self._meta())

    def _load(self, variables) -> None:
        with self._step_lock:
            load_tree(self.model.module, from_flax(variables))

    def _restore_latest(self) -> int:
        """Restore the newest checkpoint into the module with its history;
        returns the epoch to go on from (0: none). The optimizer state
        restarts, as in JAX."""
        from .resume import extend_history, select_resume_checkpoint

        if self.request.options.sharded_checkpoints:
            start = self._restore_sharded()
            if start >= 0:
                return start
            # a job may turn sharded checkpoints on and resume from an
            # older flat one
        best = select_resume_checkpoint(self.checkpoint_store, self.job_id)
        if best is None:
            return 0
        start_epoch, ck = best
        self._load(ck.variables)
        extend_history(self.history, ck)
        log.info("%s: resumed from checkpoint %s (epoch %d)", self.job_id,
                 ck.tag, start_epoch)
        return start_epoch

    def _restore_sharded(self) -> int:
        """Resume from the newest sharded checkpoint: an epoch tag ``epN``
        starts at N + 1, the final export at its recorded epoch, the
        further one wins (JAX :576-615). -1 when there is none."""
        from .resume import extend_history

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
        if not candidates:
            return -1
        start, tag = max(candidates)
        ck = store.restore(self.job_id, tag)
        self._load(ck.variables)
        extend_history(self.history, ck)
        log.info("%s: resumed from sharded checkpoint %s (epoch %d)",
                 self.job_id, tag, start)
        return start

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

    def infer(self, x: np.ndarray):
        """Greedy next-token ids for each position of a token batch."""
        if not self._initialized:
            raise KubeMLError(f"job {self.job_id} has no model yet", 400)
        module = self.model.module
        with self._step_lock, torch.no_grad():
            tokens = torch.as_tensor(np.asarray(x), dtype=torch.int64,
                                     device=self.device)
            logits = module(self.model.preprocess(tokens), train=False)
            return logits.argmax(dim=-1).cpu().numpy()

    def generate(self, req) -> dict:
        """Serve a ``GenerateRequest`` from the live model (the one-shot
        ``generate_from_request``), between train steps."""
        if not self._initialized:
            raise KubeMLError(f"job {self.job_id} has no model yet", 400)
        from ..models.generation import generate_from_request

        with self._step_lock:
            return generate_from_request(self.model.module, req)

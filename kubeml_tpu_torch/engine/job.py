"""TrainJob, the per-job K-AVG training engine: the port of
``kubeml_tpu/engine/job.py``.

Drives the epoch loop: init, per-epoch sync rounds fed by the round loader
through :class:`RoundPrefetcher`, health-based and elastic parallelism
changes between epochs, periodic validation, the goal-accuracy early stop,
metrics pushes and the persisted history. Two callbacks decouple it from
a control plane:

* ``on_epoch_end(JobState) -> new_parallelism``: the scheduler hook;
* ``on_metrics(MetricUpdate)``: the metrics push.

Checkpoints (``storage.checkpoint``, the JAX on-disk format, weights in the
Flax layout through ``interop.from_flax.to_flax_variables``):

* every ``checkpoint_every`` epochs the reference replica is copied to the
  host (training updates the replicas in place, so the writer must not
  hold a live tensor) and written by a background thread, at most one
  write in flight, keeping the newest ``checkpoint_keep``;
* ``resume`` restores the newest of the epoch checkpoints and the final
  export (``engine.resume``) with its recorded history and continues at
  the next epoch; nothing in an epoch draws from a stream earlier epochs
  advanced (the data order is fixed, and a round's dropout seed is
  ``fold_in(fold_in(seed, epoch + 1), round_index)``, JAX's derivation
  with ``models.layers.fold_in``), so a resumed run equals an
  uninterrupted one, except under chaos, whose job-wide mask stream
  starts over, as in the JAX engine;
* ``preempt()`` ends the job at the next round edge and writes a yield
  checkpoint (the current weights under the last completed epoch's tag)
  instead of the final export, which ``save_model`` writes at the end of
  a finished job.

``infer`` may be called from another thread while the job trains (the
parameter server's ``/infer`` on a live job): it answers from a copy of
replica 0 taken at the last round's edge, through a module of its own,
as the JAX engine answers from the variables it rebinds at a round's end.

**Over ranks** (``dist``, a ``parallel.distributed.DistContext`` of P
ranks; JAX :77-113, 236-312, 432-441, 454-456, 723-738, 767-862,
904-984): every rank runs the same job in lockstep, its trainer holding
and loading only its block of worker rows (``KAvgTrainer.local_rows``).

* The parallelism is a multiple of P: the request's, the health resize's
  and the scheduler's answer are rounded to ``max(P, p // P * P)``, the
  rounding noted in the history (JAX's notes).
* Rank 0 (the leader, whose job thread the parameter server runs) decides
  and broadcasts over the store: the stop at every epoch and round (a
  preempt reaches the leader alone, so the fast yield is one-rank only,
  and a preempted job over ranks leaves at the stop's next broadcast) and
  the scheduler's answer. Chaos masks are drawn in lockstep from the job
  id's seed on every rank; an injector passed in is one rank's and is
  refused over ranks (a ``ValueError``).
* The leader alone pushes metrics and writes the history, the
  checkpoints and the final export; every rank computes them (the round's
  results are global, so the histories agree). A resume restores the
  checkpoint the leader picks (broadcast), read by every rank from the
  checkpoint store, which the ranks must share.
* ``infer`` and ``generate`` during training serve the leader's newest
  checkpoint (serving the live replicas would need the other ranks), a
  409 before the first one; the finished job serves its final weights.
* ``heartbeat`` is stamped at construction, every round, every
  validation round and every checkpoint, so the stall watchdog of the
  parameter server and the followers reads progress.

Not ported yet (``ROADMAP.md``): the background compile of the next
parallelism level (eager PyTorch compiles nothing), tracer spans, and
the retry of a round on a transient accelerator error (a CUDA fault
poisons the context, so a retry in the same process cannot recover):
every round runs once, as JAX's rounds over several processes do.
"""

from __future__ import annotations

import logging
import threading
import time
import zlib
from typing import Callable, Optional

import numpy as np
import torch

from ..api.errors import KubeMLError, MergeError
from ..api.types import History, JobState, MetricUpdate, TrainRequest
from ..data.dataset import KubeDataset
from ..data.loader import RoundLoader, validation_loader
from ..data.sharding import plan_epoch
from ..interop.from_flax import from_flax_variables, to_flax_variables
from ..models.layers import fold_in
from ..runtime.model import KubeModel
from ..storage.checkpoint import FINAL_TAG, CheckpointStore
from ..storage.history import HistoryStore
from ..storage.store import ShardStore
from .failures import FailureInjector, WorkerHealth
from .kavg import KAvgTrainer, RoundPrefetcher

log = logging.getLogger("kubeml.job")


class TrainJob:
    def __init__(
        self,
        job_id: str,
        request: TrainRequest,
        model: KubeModel,
        store: Optional[ShardStore] = None,
        history_store: Optional[HistoryStore] = None,
        checkpoint_store: Optional[CheckpointStore] = None,
        on_epoch_end: Optional[Callable[[JobState], int]] = None,
        on_metrics: Optional[Callable[[MetricUpdate], None]] = None,
        device=None,
        seed: int = 0,
        chaos: Optional[FailureInjector] = None,
        health_threshold: int = 3,
        dist=None,
        on_epoch_weights: Optional[Callable[[dict, int], None]] = None,
    ):
        from ..parallel import distributed

        if dist is None and distributed.process_count() > 1:
            dist = distributed.get_dist_context()
        self.dist = dist
        world = dist.size if dist is not None else 1
        self._multi = world > 1
        self._leader = dist is None or dist.is_leader
        request.options.check_ported(world)
        if self._multi and chaos is not None:
            # an injector passed in lives in this process only; the one the
            # options make is seeded from the job id, so every rank draws
            # the same masks in lockstep
            raise ValueError("custom chaos injectors are single-process "
                             "only; use options.chaos_prob in multi-host mode")
        self.job_id = job_id
        self.request = request
        self.model = model
        self.store = store or ShardStore()
        self.history_store = history_store or HistoryStore()
        self._checkpoint_store = checkpoint_store
        self.on_epoch_end = on_epoch_end
        self.on_metrics = on_metrics
        # (reference weights on the host, epoch) after each epoch on one
        # rank: a standalone runner publishes them for live serving
        self.on_epoch_weights = on_epoch_weights
        self.seed = seed
        self.parallelism = request.options.default_parallelism
        notes = []
        if self._multi:
            # the worker axis splits evenly over the ranks
            requested = self.parallelism
            self.parallelism = self._round_to_world(requested)
            if self.parallelism != requested:
                note = (f"requested parallelism {requested} rounded to "
                        f"{self.parallelism} (must be a multiple of the "
                        f"{world} host processes)")
                log.warning("%s: %s", job_id, note)
                notes.append(note)
        self.trainer = KAvgTrainer(model, precision=request.options.precision,
                                   device=device,
                                   mesh_shape=request.options.mesh_shape,
                                   dist=dist)
        # the option-derived injector is seeded from the job id, as the JAX
        # package's, so the same job draws the same masks in either package
        if chaos is None and request.options.chaos_prob > 0.0:
            chaos = FailureInjector(prob=request.options.chaos_prob,
                                    seed=zlib.crc32(job_id.encode()) & 0x7FFFFFFF)
        self.chaos = chaos
        self.health = WorkerHealth(threshold=health_threshold)
        # per-epoch feeds of the metrics push, reset in _train_epoch
        self._last_round_times: list = []
        self._last_merge_s = -1.0
        self._epoch_round_stats: list = []
        self._last_divergence: list = []
        self._last_spread: list = []
        self._last_round_skew = -1.0
        self.history = History(id=job_id, task={"request": request.to_dict()})
        self.history.notes.extend(notes)
        self.stop_event = threading.Event()
        # checkpoint-and-yield: preempt() rides the stop machinery, but the
        # job then writes a resume checkpoint instead of the final export
        self.preempt_event = threading.Event()
        # progress stamp for the stall watchdog; heartbeat_cold doubles its
        # allowance until the first round is done
        self.heartbeat = time.time()
        self.heartbeat_cold = True
        self.exit_error: Optional[str] = None
        self._stacked_vars = None
        # replica 0 at the last round's edge, for infer from other threads
        self._published = None
        self._final_variables = None
        # over ranks: the leader's newest checkpointed weights (the port's
        # layout, on the host) and their epoch, which infer serves
        self._latest_snapshot: Optional[tuple] = None
        # the async periodic checkpoint write in flight (at most one)
        self._ckpt_thread: Optional[threading.Thread] = None

    def stop(self) -> None:
        self.stop_event.set()

    def preempt(self) -> None:
        """Checkpoint-and-yield: leave at the next round edge and write a
        resume checkpoint. Idempotent."""
        self.preempt_event.set()
        self.stop_event.set()

    @property
    def preempted(self) -> bool:
        return self.preempt_event.is_set()

    @property
    def checkpoint_store(self) -> CheckpointStore:
        if self._checkpoint_store is None:
            self._checkpoint_store = CheckpointStore()
        return self._checkpoint_store

    @property
    def state(self) -> JobState:
        return JobState(parallelism=self.parallelism)

    # --- main loop ---

    def train(self) -> History:
        req = self.request
        opts = req.options
        try:
            dataset: KubeDataset = self.model.dataset
            dataset._attach(self.store)
            handle = dataset.handle

            dataset.set_mode(True)
            sample_x, _ = handle.load_subset_range("train", 0, 1)
            sample_x, _ = dataset.transform(np.asarray(sample_x), None)
            self._stacked_vars = self.trainer.init_variables(
                torch.Generator().manual_seed(self.seed),
                sample_x[: req.batch_size], self.parallelism)

            start_epoch = self._restore_latest() if opts.resume else 0
            self._publish()

            val_acc = 0.0
            acc_pct = None
            epochs_run = 0
            for epoch in range(start_epoch, req.epochs):
                if self._sync_stop():
                    log.info("%s: stop requested, exiting at epoch %d",
                             self.job_id, epoch)
                    break
                t0 = time.time()
                used_parallelism = self.parallelism
                train_loss = self._train_epoch(epoch, handle, dataset)
                elapsed = time.time() - t0
                if self.stop_event.is_set() and np.isnan(train_loss):
                    break  # stopped mid-epoch before any round completed
                # a preempted job skips the resize, the scheduler's answer,
                # validation and the periodic checkpoint: it yields. One
                # rank only: over ranks those hold collectives and the
                # preempt reaches the leader alone, so the job leaves at
                # the stop's next broadcast
                yielding = self.preempt_event.is_set() and not self._multi

                # health-based resize: persistently dead workers shrink the
                # worker axis at the epoch boundary (the health state is
                # the same on every rank, and so is its rounding)
                if not opts.static_parallelism:
                    healthy_p = self.health.suggest_parallelism(self.parallelism)
                    if self._multi:
                        healthy_p = self._round_to_world(healthy_p)
                    if healthy_p < self.parallelism:
                        log.warning(
                            "%s: %d persistently failed worker(s); resizing "
                            "%d -> %d", self.job_id,
                            self.parallelism - healthy_p, self.parallelism,
                            healthy_p)
                        self._resize(healthy_p)

                # elastic re-evaluation: the scheduler answers with this
                # epoch's elapsed time unless parallelism is static; over
                # ranks the leader asks and every rank takes its answer,
                # rounded to the world
                if not opts.static_parallelism and not yielding and (
                        self.on_epoch_end is not None or self._multi):
                    new_p = None
                    if self._leader and self.on_epoch_end is not None:
                        new_p = self.on_epoch_end(JobState(
                            parallelism=self.parallelism,
                            elapsed_time=elapsed))
                    if self._multi:
                        _, p = self.dist.broadcast_flags(
                            parallelism=new_p or 0)
                        new_p = p or None
                        if new_p:
                            asked, new_p = new_p, self._round_to_world(new_p)
                            if new_p != asked:
                                note = (f"epoch {epoch + 1}: scheduler "
                                        f"parallelism {asked} rounded to "
                                        f"{new_p} (multiple of "
                                        f"{self.dist.size} host processes)")
                                log.warning("%s: %s", self.job_id, note)
                                self.history.notes.append(note)
                    if new_p and new_p != self.parallelism:
                        log.info("%s: parallelism %d -> %d", self.job_id,
                                 self.parallelism, new_p)
                        self._resize(new_p)

                val_loss = None
                acc_pct = None
                if (opts.validate_every > 0 and not yielding
                        and (epoch + 1) % opts.validate_every == 0):
                    val_acc, val_loss = self._validate(dataset, handle)
                    acc_pct = val_acc * 100.0

                epochs_run += 1
                self.history.append_epoch(
                    train_loss=train_loss,
                    parallelism=used_parallelism,
                    duration=elapsed,
                    validation_loss=val_loss,
                    accuracy=acc_pct,
                    # with round stats on, every epoch appends a value (NaN
                    # when it measured nothing), so the lists stay aligned
                    # with train_loss; with them off the lists stay empty
                    worker_divergence=self._epoch_signal(self._last_divergence),
                    loss_spread=self._epoch_signal(self._last_spread),
                    round_skew=(self._last_round_skew
                                if self._last_round_skew >= 0
                                else self._epoch_signal(())),
                )
                if self._leader:
                    self._push_metrics(train_loss, val_loss, acc_pct,
                                       elapsed, used_parallelism, epoch + 1)
                if (opts.checkpoint_every > 0 and not yielding
                        and (epoch + 1) % opts.checkpoint_every == 0):
                    self._save_checkpoint(epoch)
                if self.on_epoch_weights is not None and not self._multi:
                    try:
                        self.on_epoch_weights(
                            self.trainer.reference_variables(
                                self._stacked_vars), epoch)
                    except Exception:
                        log.exception("%s: epoch weights publish failed "
                                      "(non-fatal)", self.job_id)
                log.info(
                    "%s: epoch %d/%d loss=%.4f acc=%s parallelism=%d %.2fs",
                    self.job_id, epoch + 1, req.epochs, train_loss,
                    f"{acc_pct:.2f}%" if acc_pct is not None else "-",
                    used_parallelism, elapsed,
                )
                if acc_pct is not None and acc_pct >= opts.goal_accuracy:
                    log.info("%s: goal accuracy %.2f%% reached (%.2f%%)",
                             self.job_id, opts.goal_accuracy, acc_pct)
                    break

            # final validation if the last epoch did not run one;
            # validate_every == 0 opts out of validation entirely, and a
            # resume with nothing left to train keeps the restored history.
            # Over ranks the stop is the leader's (validation is collective)
            if (opts.validate_every > 0 and acc_pct is None and epochs_run > 0
                    and not self._sync_stop()):
                val_acc, val_loss = self._validate(dataset, handle)
                self.history.validation_loss.append(float(val_loss))
                self.history.accuracy.append(float(val_acc * 100.0))

            self._join_checkpoint()  # epoch writes land before the export
            self._final_variables = self.trainer.reference_variables(
                self._stacked_vars)
            # the final export; a no-op resume rewrites it only when it is
            # missing. A preempted job is parked, not done: it writes a
            # resume checkpoint instead
            if self.preempt_event.is_set():
                self._save_yield_checkpoint()
            elif self._leader and opts.save_model and (
                    epochs_run > 0
                    or FINAL_TAG not in self.checkpoint_store.tags(self.job_id)):
                self.checkpoint_store.save(
                    self.job_id, to_flax_variables(self._final_variables,
                                                   self.model.module),
                    epoch=len(self.history.train_loss), tag=FINAL_TAG,
                    meta=self._checkpoint_meta())
        except KubeMLError as e:
            self.exit_error = e.message
            raise
        except Exception as e:
            self.exit_error = str(e)
            raise KubeMLError(f"job {self.job_id} failed: {e}") from e
        finally:
            self._join_checkpoint()  # no writer outlives the job
            # a failed job records its error, so pollers see the outcome
            if self.exit_error is not None and isinstance(self.history.task, dict):
                self.history.task["error"] = self.exit_error
            if self._leader:
                self.history_store.save(self.history)
        return self.history

    # --- internals ---

    def _round_to_world(self, p: int) -> int:
        """``p`` rounded down to a multiple of the ranks, at least one a
        rank (JAX :97-108)."""
        size = self.dist.size
        return max(size, (p // size) * size)

    def _sync_stop(self) -> bool:
        """The stop decision every rank agrees on: the leader's, broadcast
        over ranks, so no rank leaves the lockstep loop while the others
        still issue collectives."""
        stop = self.stop_event.is_set()
        if self._multi:
            stop, _ = self.dist.broadcast_flags(stop=stop)
            if stop:
                self.stop_event.set()
        return stop

    def _resize(self, new_p: int) -> None:
        self._stacked_vars = self.trainer.resize(self._stacked_vars,
                                                 self.parallelism, new_p)
        self.parallelism = new_p
        # worker indices renumber: stale failure counts must not transfer
        self.health.reset()

    def _train_epoch(self, epoch: int, handle, dataset: KubeDataset) -> float:
        req = self.request
        dataset.set_mode(True)
        plan = plan_epoch(
            num_docs=handle.num_subsets("train"),
            n_workers=self.parallelism,
            batch_size=req.batch_size,
            k=req.options.k,
            subset_size=handle.subset_size,
            num_samples=handle.num_samples("train"),
        )
        loader = RoundLoader(handle, "train", plan, transform=dataset.transform,
                             worker_rows=self.trainer.local_rows(
                                 self.parallelism))
        epoch_seed = fold_in(self.seed, epoch + 1)
        losses = []
        skipped = 0
        self._last_round_times = []
        self._last_merge_s = -1.0
        self._epoch_round_stats = []
        self._last_divergence = []
        self._last_spread = []
        self._last_round_skew = -1.0
        for rb, staged in RoundPrefetcher(self.trainer, loader,
                                          self.parallelism):
            if self._sync_stop():
                break
            # the plan's, the same on every rank (a rank loads its rows only)
            data_bearing = plan.data_bearing(rb.round_index)
            worker_mask = None
            if self.chaos is not None:
                worker_mask = self.chaos.mask(self.parallelism)
                for w in self.health.update(worker_mask):
                    log.warning("%s: worker %d persistently failed",
                                self.job_id, w)
                if worker_mask.min() == 0.0:
                    log.info("%s: round %d injected failures on workers %s",
                             self.job_id, rb.round_index,
                             np.flatnonzero(worker_mask == 0.0).tolist())
                # no healthy data-bearing worker: skip the round here (the
                # weights keep their pre-round value), so a NaN loss from
                # the trainer always means real divergence
                if float((worker_mask * data_bearing).sum()) == 0.0:
                    skipped += 1
                    log.warning("%s: round %d skipped: no healthy "
                                "data-bearing worker", self.job_id,
                                rb.round_index)
                    continue
            t_round = time.time()
            self._stacked_vars, loss = self.trainer.sync_round(
                self._stacked_vars, *staged, lr=req.lr, epoch=epoch,
                worker_mask=worker_mask,
                rng=fold_in(epoch_seed, rb.round_index),
                data_bearing=data_bearing)
            self._publish()
            self.heartbeat = time.time()
            self.heartbeat_cold = False
            # host wall time of the round's dispatch (the card runs behind)
            self._last_round_times.append(time.time() - t_round)
            if self.trainer.last_round_stats is not None:
                self._epoch_round_stats.append(self.trainer.last_round_stats)
            losses.append(loss)
        if not losses:
            if self.stop_event.is_set():
                return float("nan")
            if skipped:
                raise MergeError(
                    f"job {self.job_id}: all {skipped} rounds this epoch had "
                    f"no healthy data-bearing worker")
            raise KubeMLError(f"job {self.job_id}: epoch produced no rounds")
        if skipped:
            log.warning("%s: %d round(s) skipped this epoch (no effective "
                        "participants)", self.job_id, skipped)
        # one blocking read per epoch: the host waits here for the rounds
        # (their merges included) to finish on the card
        t_merge = time.time()
        mean_loss = float(torch.stack(losses).mean())
        self._last_merge_s = time.time() - t_merge
        self._finalize_round_stats()
        return mean_loss

    def _epoch_signal(self, values):
        """The epoch's mean of a per-round signal: NaN when round stats are
        on but nothing was measured, None (no append) when they are off."""
        if values:
            return float(np.mean(values))
        return float("nan") if self.trainer.round_stats else None

    def _finalize_round_stats(self) -> None:
        """Read the epoch's round stats off the card and derive the epoch's
        signals: the finite per-round divergence and spread, and the
        round-time skew max/median (-1 with fewer than 2 rounds)."""
        self._last_divergence = []
        self._last_spread = []
        for s in self._epoch_round_stats:
            spread, div = (float(v) for v in s.cpu())
            if np.isfinite(spread):
                self._last_spread.append(spread)
            if np.isfinite(div):
                self._last_divergence.append(div)
        self._epoch_round_stats = []
        self._last_round_skew = -1.0
        if self.trainer.round_stats and len(self._last_round_times) >= 2:
            med = float(np.median(self._last_round_times))
            if med > 0:
                self._last_round_skew = float(
                    max(self._last_round_times) / med)

    def _validate(self, dataset: KubeDataset, handle):
        """(accuracy, loss) over the test split; stamps ``heartbeat`` at
        every evaluated round, so a sweep longer than the function timeout
        is no stall."""
        self.heartbeat = time.time()
        dataset.set_mode(False)
        loader = validation_loader(
            handle, self.parallelism, self.request.batch_size,
            transform=dataset.transform,
            worker_rows=self.trainer.local_rows(self.parallelism))

        def stamping(rounds):
            for rb in rounds:
                self.heartbeat = time.time()
                yield rb

        acc, loss = self.trainer.evaluate_rounds(self._stacked_vars,
                                                 stamping(loader))
        dataset.set_mode(True)
        return acc, loss

    # --- checkpoints ---

    def _checkpoint_meta(self) -> dict:
        h = self.history
        return {"request": self.request.to_dict(), "history": {
            key: list(getattr(h, key)) for key in (
                "train_loss", "validation_loss", "accuracy", "parallelism",
                "epoch_duration", "worker_divergence", "loss_spread",
                "round_skew", "notes")}}

    def _join_checkpoint(self) -> None:
        if self._ckpt_thread is not None:
            self._ckpt_thread.join()
            self._ckpt_thread = None

    def _save_checkpoint(self, epoch: int) -> None:
        """The periodic checkpoint: the host copy of this epoch's weights
        is taken here (training goes on updating the replicas in place);
        the write and the retention prune run on a background thread, at
        most one in flight. A failure is logged, not raised. Over ranks
        the leader alone writes, and keeps the weights for ``infer``."""
        self.heartbeat = time.time()
        if not self._leader:
            return
        try:
            self._join_checkpoint()
            host = self.trainer.reference_variables(self._stacked_vars)
            if self._multi:
                self._latest_snapshot = (host, epoch)
            variables = to_flax_variables(host, self.model.module)
            meta = self._checkpoint_meta()

            def write():
                try:
                    self.checkpoint_store.save(self.job_id, variables,
                                               epoch=epoch, meta=meta)
                    self.checkpoint_store.prune_epochs(
                        self.job_id, self.request.options.checkpoint_keep)
                except Exception:
                    log.exception("%s: checkpoint write failed (non-fatal)",
                                  self.job_id)

            self._ckpt_thread = threading.Thread(
                target=write, name=f"ckpt-{self.job_id}", daemon=True)
            self._ckpt_thread.start()
        except Exception:
            log.exception("%s: checkpoint save failed (non-fatal)",
                          self.job_id)

    def _save_yield_checkpoint(self) -> None:
        """A preempted job's resume checkpoint: the current weights under
        the last completed epoch's tag, written before the job returns
        (the atomic publish leaves the old or the new file, never a torn
        one). Nothing completed: nothing to write. The leader's only."""
        completed = len(self.history.train_loss)
        if completed <= 0 or not self._leader:
            return
        try:
            self.checkpoint_store.save(
                self.job_id, to_flax_variables(self._final_variables,
                                               self.model.module),
                epoch=completed - 1, meta=self._checkpoint_meta())
        except Exception:
            log.exception("%s: yield checkpoint failed (resume falls back "
                          "to the previous checkpoint)", self.job_id)

    def _restore_latest(self) -> int:
        """Restore the newest checkpoint onto every worker with its
        history; returns the epoch to go on from (0: nothing to
        restore). Over ranks the leader picks it and broadcasts its tag,
        and every rank reads that checkpoint (the store must be shared; a
        rank that lacks the file fails here)."""
        from .resume import extend_history, select_resume_checkpoint

        if self._multi:
            sel = None
            if self._leader:
                best = select_resume_checkpoint(self.checkpoint_store,
                                                self.job_id)
                if best is not None:
                    sel = {"epoch": best[0], "tag": best[1].tag}
            sel = self.dist.broadcast_obj(sel)
            if sel is None:
                return 0
            start_epoch = int(sel["epoch"])
            ck = self.checkpoint_store.restore(self.job_id, tag=sel["tag"])
        else:
            best = select_resume_checkpoint(self.checkpoint_store,
                                            self.job_id)
            if best is None:
                return 0
            start_epoch, ck = best
        self._stacked_vars = self.trainer.place_reference(
            from_flax_variables(ck.variables, self.model.module),
            self.parallelism)
        extend_history(self.history, ck)
        log.info("%s: resumed from checkpoint %s (epoch %d)", self.job_id,
                 ck.tag, start_epoch)
        return start_epoch

    def _push_metrics(self, train_loss, val_loss, acc_pct, elapsed,
                      parallelism, epochs_done: int) -> None:
        if self.on_metrics is None:
            return
        try:
            self.on_metrics(MetricUpdate(
                job_id=self.job_id,
                train_loss=float(train_loss),
                validation_loss=float(val_loss) if val_loss is not None else 0.0,
                accuracy=float(acc_pct) if acc_pct is not None else 0.0,
                parallelism=parallelism,
                epoch=int(epochs_done),
                epoch_duration=float(elapsed),
                round_seconds=[float(t) for t in self._last_round_times],
                merge_seconds=float(self._last_merge_s),
                round_divergence=[float(v) for v in self._last_divergence],
                round_loss_spread=[float(v) for v in self._last_spread],
                round_skew_ratio=float(self._last_round_skew),
            ))
        except Exception:
            log.exception("%s: metrics push failed (non-fatal)", self.job_id)

    # --- results ---

    @property
    def final_variables(self):
        """The trained reference model (numpy, in the port's layout), once
        ``train`` finished."""
        return self._final_variables

    def infer(self, x: np.ndarray):
        """The model's ``infer`` on the merged weights of the last
        completed round (of the init or restore before the first): the
        replicas change in place inside a round, so a call from another
        thread reads the copy published at the round's edge. Over ranks,
        the newest checkpoint's weights (see :meth:`_serving_weights`)."""
        return self.trainer.infer_replica(self._serving_weights(), x)

    def generate(self, req) -> dict:
        """Serve a ``GenerateRequest`` from the live model (JAX :909-930):
        the one-shot dense ``generate_from_request`` on the weights
        :meth:`infer` reads."""
        return self.trainer.generate_replica(
            self._serving_weights("generation needs one"), req)

    def _serving_weights(self, detail: Optional[str] = None):
        """The weights live serving reads: on one rank the published
        replica 0; over ranks (JAX :932-984) the final weights once the
        job finished, else the leader's newest checkpoint, from memory or
        from the store (serving the live replicas would need the other
        ranks, which are inside the round loop), and a 409 before the
        first, whose text ends with ``detail`` where given."""
        if not self._multi:
            published = self._published
            if published is None:
                raise KubeMLError(f"job {self.job_id} has no model yet", 400)
            return published
        if self._stacked_vars is None:
            raise KubeMLError(f"job {self.job_id} has no model yet", 400)
        if self._final_variables is not None:
            host = self._final_variables
        else:
            snap = self._latest_snapshot or self._restore_serving_snapshot()
            if snap is None:
                every = self.request.options.checkpoint_every
                detail = detail or (
                    f"retry after the first checkpoint (checkpoint_every="
                    f"{every})" if every > 0 else
                    "it runs without checkpoints (checkpoint_every=0), so "
                    "inference is available once it finishes")
                raise KubeMLError(
                    f"job {self.job_id} is training multi-host and has no "
                    f"checkpoint yet; {detail}", 409)
            host = snap[0]
        return {c: {k: torch.as_tensor(v).to(self.trainer.device)
                    for k, v in leaves.items()} for c, leaves in host.items()}

    def _restore_serving_snapshot(self):
        """The newest epoch checkpoint off the store, for serving during
        training after a restart (the leader's only); None without one."""
        if not self._leader:
            return None
        from .resume import select_resume_checkpoint

        try:
            best = select_resume_checkpoint(self.checkpoint_store,
                                            self.job_id)
            if best is None:
                return None
            ck = best[1]
            host = from_flax_variables(ck.variables, self.model.module)
            # a snapshot the training thread took meanwhile is newer
            if self._latest_snapshot is None:
                self._latest_snapshot = (host, ck.epoch)
            return self._latest_snapshot
        except Exception:
            log.exception("%s: serving-snapshot restore failed", self.job_id)
            return None

    def _publish(self) -> None:
        """Publish replica 0 of the (merged) replicas for ``infer`` (one
        rank: over ranks infer serves checkpoints)."""
        if not self._multi:
            self._published = self.trainer.snapshot(self._stacked_vars)

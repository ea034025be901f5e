"""K-AVG (local SGD with periodic weight averaging) on one card: the port of
``kubeml_tpu/engine/kavg.py``.

The semantics are the JAX engine's:

* N workers each run K local optimizer steps on their own slab
  (``[N, K, B, ...]``), then the weights of the workers that took part are
  averaged, mask-weighted in f32 and cast back (integer leaves rounded);
* optimizer state is re-initialised at every sync round: momentum does not
  survive an averaging barrier;
* a step whose mask sums to 0 changes neither weights nor optimizer state;
  the step loss is ``sum(pl * m) / max(sum(m), 1)``, a worker's loss the
  mean over its valid steps, the round's loss the mean over the workers
  that are healthy (``worker_mask``) and hold data, NaN when there are
  none, and then the weights keep their pre-round value;
* no healthy worker at all is a :class:`MergeError`.

Replicas are a leading ``[N, ...]`` axis on every leaf of the variables
tree. The JAX engine runs the N workers as one batched program (``vmap``
under ``lax.scan``); on one card the port loops over them in Python: a
worker's replica is bound into the model's module (its parameters and
BatchNorm buffers become views of row w of the stacked tensors, so the
optimizer updates the replica in place), and the average is a few fused
multi-tensor reductions over all leaves on the device. The mask decisions
(which steps and workers have data) are made on the host from the host
copy of the mask, so a round never waits on the card. Workers that do not
take part are not run: they add nothing to the average or the loss.

``sync_round`` updates the stacked variables in place (the JAX engine
donates them) and returns them with the round's loss as a 0-d tensor on
the device; reading it waits for the round.

**Over ranks** (``dist``, a ``parallel.distributed.DistContext`` of P
ranks; JAX :145-226, 239-371, 827-899): one rank stands for one JAX
process with one device. The global worker axis of N workers splits into
P contiguous blocks (:func:`worker_mesh`, :meth:`KAvgTrainer.local_rows`):
rank r holds rows ``local_worker_rows(N, r, P)``, so its stacked variables
and its slabs have N / P leading rows, while every method takes the
global N and ``worker_mask`` stays the global ``[N]`` host array. A round
is still one global round:

* the participants are ``worker_mask * data_bearing`` over all N workers
  (the job passes the plan's ``data_bearing``; without it the ranks sum
  their local flags), so the early returns (no healthy worker, no
  participant) are taken on every rank alike and no rank waits alone in
  a collective;
* each rank sums its participants' weighted replicas in f32 into one flat
  buffer that also holds every worker's loss at its global index; one
  all-reduce (SUM, span ``kubeml::kavg_merge``) gives every rank the
  global sums, which it divides by the global denominator and casts back,
  so every rank ends bit-equal to every other; the round loss and the
  loss spread read the global losses;
* the pre-merge divergence is measured against the merged mean, so with
  round statistics on its numerator is a second all-reduce of one number
  (``kubeml::kavg_stats``);
* dropout seeds take the global worker index;
* evaluation sums each rank's rows and all-reduces the three sums once.

``resize``, ``reference_variables`` and ``snapshot`` need no collective:
after a merge each rank's row 0 is the global replica 0.
"""

from __future__ import annotations

import copy
import math
import threading
from collections import deque
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from ..api.config import get_config
from ..api.errors import MergeError
from ..models.layers import fold_in, seed_of, takes_rng
from ..parallel import distributed
from ..parallel.collectives import _all_reduce, _span
from ..runtime.model import KubeModel, Variables, bind
from ..utils.device import resolve_device

# samples per forward in evaluation (BatchNorm runs on its statistics there,
# so splitting a validation round changes nothing but peak memory)
EVAL_CHUNK = 4096


def _tree_map(fn: Callable, tree: Variables) -> Variables:
    return {c: {k: fn(v) for k, v in leaves.items()}
            for c, leaves in tree.items()}


def _leaves(tree: Variables) -> List[torch.Tensor]:
    return [v for leaves in tree.values() for v in leaves.values()]


@dataclass(frozen=True)
class RankDevice:
    """The device of rank ``process_index`` (one card a rank), as JAX's
    device list carries each device's process."""

    process_index: int


def worker_mesh(n_workers: int, devices: Optional[List[RankDevice]] = None,
                n_procs: int = 1) -> List[RankDevice]:
    """The devices the 1-D ``worker`` axis spans (JAX :48): the largest
    count that divides N, process-major so that each rank feeds a
    contiguous block of worker rows, every rank an equal block. With one
    card a rank, the default ``devices`` are every rank's."""
    if devices is None:
        devices = [RankDevice(r) for r in range(distributed.process_count())]
    return distributed.pick_worker_devices(n_workers, devices, n_procs)


def _weighted_sums(tree: Variables, weights: np.ndarray,
                   extra: int = 0) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """``sum_w weights[w] * leaf[w]`` over the leading worker axis of every
    leaf, in f32, in one flat buffer of ``extra`` more zeros: (the buffer,
    a view of it shaped like one replica for each leaf). Summed with
    multi-tensor (``_foreach``) kernels, one pass per contributing
    worker."""
    leaves = _leaves(tree)
    sizes = [v[0].numel() for v in leaves]
    flat = torch.zeros(sum(sizes) + extra, device=leaves[0].device)
    views = _views(flat, leaves)
    for w in np.flatnonzero(weights):
        torch._foreach_add_(views, [v[int(w)].float() for v in leaves],
                            alpha=float(weights[w]))
    return flat, views


def _views(flat: torch.Tensor, leaves: List[torch.Tensor]
           ) -> List[torch.Tensor]:
    """Views of ``flat``, in order, shaped like one replica of each
    leaf."""
    out, at = [], 0
    for v in leaves:
        n = v[0].numel()
        out.append(flat[at:at + n].view(v.shape[1:]))
        at += n
    return out


def _means(tree: Variables, sums: List[torch.Tensor], denom: float
           ) -> Variables:
    """Each leaf's mean from its f32 sum: divided by ``denom`` and cast
    back to the leaf's dtype, integer leaves rounded."""
    leaves = _leaves(tree)
    floats = [i for i, v in enumerate(leaves) if v.is_floating_point()]
    out = {}
    if floats:
        for i, m in zip(floats, torch._foreach_div([sums[i] for i in floats],
                                                   denom)):
            out[id(leaves[i])] = m.to(leaves[i].dtype)
    for i, v in enumerate(leaves):
        if not v.is_floating_point():
            out[id(v)] = (sums[i] / denom).round().to(v.dtype)
    return _tree_map(lambda leaf: out[id(leaf)], tree)


def _mean_over_workers(tree: Variables, weights: np.ndarray) -> Variables:
    """Mask-weighted mean over the leading worker axis of every leaf:
    ``sum_w weights[w] * leaf[w] / max(sum(weights), 1)`` in f32, cast back
    to the leaf's dtype; integer leaves are rounded. ``weights`` is the
    host's ``[N]`` float array."""
    weights = np.asarray(weights, np.float32)
    _, sums = _weighted_sums(tree, weights)
    return _means(tree, sums, max(float(weights.sum()), 1.0))


def _sum_over_ranks(t: torch.Tensor, span: str) -> torch.Tensor:
    """``t`` summed over every rank (an all-reduce over the world),
    traced as ``span`` (under gloo the card's queue drains before it
    opens, as ``parallel.collectives`` traces its operations)."""
    with _span(span, t):
        return _all_reduce(t, None)


def _broadcast_to_workers(tree: Variables, n: int) -> Variables:
    """``n`` copies of one replica along a new leading axis, in new
    storage (detached from any autograd graph)."""
    return _tree_map(lambda v: v.detach().unsqueeze(0).expand(n, *v.shape)
                     .clone(memory_format=torch.contiguous_format), tree)


def _assign_workers(stacked: Variables, one: Variables) -> None:
    """Write the replica ``one`` into every row of ``stacked`` in place."""
    dst, src = _leaves(stacked), _leaves(one)
    for w in range(dst[0].shape[0]):
        torch._foreach_copy_([v[w] for v in dst], src)


def _as_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    # from_numpy shares memory; copy only a read-only or strided array
    return torch.from_numpy(np.require(a, requirements=["C", "W"]))


class RoundPrefetcher:
    """Stage round slabs one round ahead of the round computing.

    Iterates ``(round_batch, staged_slabs)`` over a RoundLoader-style
    iterable, keeping the next round's slabs in flight via
    ``trainer.stage_round``, which never waits on the card: on a CUDA
    trainer round i+1 crosses from pinned host memory on a side stream
    while round i computes (double buffering, the JAX engine's default
    depth). Parallelism must stay fixed while iterating (it does within an
    epoch)."""

    def __init__(self, trainer: "KAvgTrainer", rounds: Iterable,
                 n_workers: int):
        self.trainer = trainer
        self.rounds = rounds
        self.n_workers = n_workers

    def __iter__(self):
        buf: deque = deque()
        for rb in self.rounds:
            buf.append((rb, self.trainer.stage_round(rb.x, rb.y, rb.mask,
                                                     self.n_workers)))
            if len(buf) == 2:
                yield buf.popleft()
        while buf:
            yield buf.popleft()


class KAvgTrainer:
    """K-AVG sync rounds of one model on one device, or over ranks.

    ``device`` defaults to the current CUDA card (over ranks, the rank's
    device) and raises without one (``resolve_device``); the CPU runs
    only when asked for. ``precision`` "bf16" casts float inputs to bf16
    before ``model.preprocess`` (uint8 stays uint8); the model's own
    ``dtype`` sets its compute precision. ``mesh_shape``'s ``{"worker":
    d}`` caps the devices the worker axis may span, as in JAX; its other
    axes do not concern K-AVG. ``dist`` (a ``DistContext``; by default the
    process's when it runs over several ranks) runs the rounds over ranks
    (see the module docstring)."""

    def __init__(self, model: KubeModel, precision: str = "bf16",
                 device: Union[str, torch.device, None] = None,
                 mesh_shape: Optional[Dict[str, int]] = None, dist=None):
        if dist is None and distributed.process_count() > 1:
            dist = distributed.get_dist_context()
        self.dist = dist
        self.world = dist.size if dist is not None else 1
        self.rank = dist.rank if dist is not None else 0
        self._multi = self.world > 1
        if self._multi and device is None:
            device = distributed.local_device()
        self.model = model
        self.precision = precision
        self.device = resolve_device(device)
        self.devices = [RankDevice(r) for r in range(self.world)]
        if mesh_shape and "worker" in mesh_shape:
            cap = mesh_shape["worker"]
            if not isinstance(cap, int) or cap < 1:
                raise ValueError(f"mesh_shape['worker'] must be a positive "
                                 f"int, got {cap!r}")
            self.devices = self.devices[:cap]
        self._meshes: Dict[int, List[RankDevice]] = {}
        # per-round [worker-loss spread, pre-merge weight divergence]
        # (KUBEML_ROUND_STATS), a device tensor read at the epoch's end
        self.round_stats = get_config().round_stats
        self.last_round_stats: Optional[torch.Tensor] = None
        self._module = None
        self._dropout_gen: Optional[torch.Generator] = None
        # inference's own module (built at its first call) and its lock
        self._infer_model: Optional[KubeModel] = None
        self._infer_lock = threading.Lock()
        self._copy_stream = None
        # slabs staged on the side stream: (x, y, mask, ready event)
        self._in_flight: deque = deque(maxlen=16)

    @property
    def _generator(self) -> torch.Generator:
        """The dropout generator on the trainer's device, reseeded for
        every step that draws."""
        if self._dropout_gen is None:
            self._dropout_gen = torch.Generator(device=self.device)
        return self._dropout_gen

    @property
    def module(self) -> torch.nn.Module:
        """The model's module on the trainer's device."""
        if self._module is None:
            self._module = self.model.module.to(self.device)
        return self._module

    # --- the worker axis ---

    def mesh_for(self, n_workers: int) -> List[RankDevice]:
        """The devices the ``n_workers`` workers span (JAX :212); raises
        JAX's errors where the world cannot split them (a ``worker`` cap
        below the world, N not a multiple of the ranks)."""
        if n_workers not in self._meshes:
            self._meshes[n_workers] = worker_mesh(n_workers, self.devices,
                                                  self.world)
        return self._meshes[n_workers]

    def local_rows(self, n_workers: int) -> Tuple[int, int]:
        """[start, end) block of the ``n_workers`` worker rows this rank
        feeds and holds (JAX :218): all of them on one rank."""
        self.mesh_for(n_workers)
        return distributed.local_worker_rows(n_workers, self.rank,
                                             self.world)

    def _local_count(self, n_workers: int) -> int:
        start, end = self.local_rows(n_workers)
        return end - start

    # --- staging ---

    def _cast_input(self, x: torch.Tensor) -> torch.Tensor:
        if self.precision == "bf16" and x.is_floating_point():
            return x.to(torch.bfloat16)
        return x

    def stage_round(self, batch_x, batch_y, mask, n_workers: int):
        """Start one round's slabs toward the device without waiting.

        Casts f32 samples to bf16 on the host when ``precision="bf16"``
        (halving the bytes that cross), copies x, y and the mask into
        pinned memory and from there to the card with ``non_blocking``
        copies on a side stream, and records an event that
        :meth:`sync_round` orders the round's compute after. Returns
        ``(x, y, mask)`` for ``sync_round``: x and y on the device, the
        mask on the host (the round's step and worker decisions are made
        from it there). On the CPU a plain pass-through."""
        x = self._cast_input(_as_tensor(batch_x))
        y = _as_tensor(batch_y)
        m = _as_tensor(mask).float()
        if self.device.type != "cuda":
            return x.to(self.device), y.to(self.device), m
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        pinned = [t.pin_memory() for t in (x, y, m)]
        with torch.cuda.stream(self._copy_stream):
            xd, yd, md = (t.to(self.device, non_blocking=True)
                          for t in pinned)
        ready = torch.cuda.Event()
        ready.record(self._copy_stream)
        self._in_flight.append((xd, yd, md, ready))
        return xd, yd, m

    def _on_device(self, batch_x, batch_y, mask):
        """(x, y, mask) on the device, ordered on the current stream, and
        the mask as a host numpy array."""
        m_host = (mask.detach().cpu() if isinstance(mask, torch.Tensor)
                  else torch.from_numpy(np.asarray(mask, np.float32))).float()
        for i, (sx, sy, sm, ready) in enumerate(self._in_flight):
            if sx is batch_x:
                del self._in_flight[i]
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(ready)
                for t in (sx, sy, sm):
                    t.record_stream(stream)
                return sx, sy, sm, m_host.numpy()
        x = self._cast_input(_as_tensor(batch_x)).to(self.device)
        y = _as_tensor(batch_y).to(self.device)
        # a host->device copy from pageable memory: the CUDA runtime stages it,
        # no wait on the card's queue
        m = m_host.to(self.device, non_blocking=True)
        return x, y, m, m_host.numpy()

    # --- lifecycle ---

    def place_reference(self, variables, n_workers: int) -> Variables:
        """Broadcast one replica (tensors or numpy arrays, e.g. from
        ``interop.from_flax.from_flax_variables``) across this rank's rows
        of ``n_workers`` on the device: the inverse of
        :meth:`reference_variables`. Over ranks every rank must pass the
        same replica."""
        one = _tree_map(lambda v: torch.as_tensor(v).to(self.device),
                        variables)
        return _broadcast_to_workers(one, self._local_count(n_workers))

    def init_variables(self, generator: Union[torch.Generator, int],
                       sample_x, n_workers: int) -> Variables:
        """Initialise one replica from ``generator`` (or an integer seed)
        on the CPU, so the weights do not depend on the device (nor on the
        rank: every rank draws the same), and broadcast it across this
        rank's rows of the worker axis on the device."""
        if not isinstance(generator, torch.Generator):
            generator = torch.Generator().manual_seed(int(generator))
        return self.place_reference(self.model.init(generator, sample_x),
                                    n_workers)

    def resize(self, stacked_vars: Variables, old_n: int, new_n: int
               ) -> Variables:
        """Elastic resize between epochs: replicas are identical after a
        sync, so replica 0 is broadcast to this rank's rows of ``new_n``
        (no collective over ranks: every rank holds replica 0)."""
        if old_n == new_n:
            return stacked_vars
        return _broadcast_to_workers(self._replica0(stacked_vars),
                                     self._local_count(new_n))

    def reference_variables(self, stacked_vars: Variables):
        """Replica 0 of the (post-sync) variables as numpy arrays: the
        reference model. Always a copy: training updates the replicas in
        place, and on the CPU ``Tensor.numpy()`` would share their
        storage."""
        return _tree_map(lambda v: v[0].detach().to("cpu", copy=True)
                         .numpy(), stacked_vars)

    @staticmethod
    def _replica0(stacked_vars: Variables) -> Variables:
        return _tree_map(lambda v: v[0], stacked_vars)

    # --- the sync round ---

    def sync_round(self, stacked_vars: Variables, batch_x, batch_y, mask,
                   lr: float, epoch: int = 0,
                   worker_mask: Optional[np.ndarray] = None,
                   rng: Union[int, torch.Generator, None] = None,
                   data_bearing: Optional[np.ndarray] = None
                   ) -> Tuple[Variables, torch.Tensor]:
        """Run one K-step-and-average round. Returns (stacked variables,
        updated in place; mean loss as a 0-d device tensor).

        ``worker_mask`` (float [N] over the global worker axis, 1.0 =
        healthy) leaves failed workers out of the average and the loss;
        with no healthy worker the round raises :class:`MergeError`.
        ``data_bearing`` (bool [N], the plan's) names the workers that
        hold data this round; without it, it is read from the mask (over
        ranks: each rank's flags summed over the ranks).

        ``rng`` (an int seed or a ``torch.Generator``; the JAX round's
        dropout key) seeds the dropout of a module whose forward takes a
        generator: worker w's step s draws from one generator on the
        trainer's device seeded with ``fold_in(fold_in(seed_of(rng), w),
        s)`` (``models.layers.fold_in``; w the global worker index), the
        counterpart of JAX's ``fold_in(split(rng, N)[w], s)``. The masks
        are not JAX's, but the same seed draws the same masks, workers and
        steps draw different ones, and a worker that does not take part
        draws nothing. Without ``rng`` no generator is passed."""
        n, steps = batch_x.shape[0], batch_x.shape[1]
        start, total_n = self.rank * n, self.world * n
        wm = (np.ones(total_n, np.float32) if worker_mask is None
              else np.asarray(worker_mask, np.float32))
        if wm.shape != (total_n,):
            raise ValueError(f"worker_mask holds {wm.shape} entries for "
                             f"{total_n} workers")
        if float(wm.sum()) == 0.0:
            raise MergeError("no healthy workers responded in this sync round")
        x, y, m, m_host = self._on_device(batch_x, batch_y, mask)
        valid = m_host.reshape(n, steps, -1).sum(-1) > 0  # [n, steps]
        # healthy AND holding data, over the global worker axis: every
        # rank takes the same decisions from it
        weights = wm * self._data_bearing(valid.any(axis=1), data_bearing,
                                          start)
        self.model.lr, self.model.epoch = lr, epoch
        if float(weights.sum()) == 0.0:
            # no effective participant: the pre-round weights (replica 0)
            # stay, and the NaN loss marks the skipped round
            _assign_workers(stacked_vars, self._replica0(stacked_vars))
            nan = torch.full((), math.nan, device=self.device)
            self.last_round_stats = (torch.stack([nan, nan])
                                     if self.round_stats else None)
            return stacked_vars, nan
        local = weights[start:start + n]
        x = self.model.preprocess(self._cast_input(x))
        module = self.module
        round_seed = (seed_of(rng) if rng is not None and takes_rng(module)
                      else None)
        workers = [int(w) for w in np.flatnonzero(local)]
        losses = []
        for w in workers:
            bind(module, _tree_map(lambda v: v[w], stacked_vars))
            opt = self.model.configure_optimizers(list(module.parameters()))
            valid_steps = np.flatnonzero(valid[w])
            total = torch.zeros((), device=self.device)
            for s in valid_steps.tolist():
                kw = {}
                if round_seed is not None:
                    kw["rng"] = self._generator.manual_seed(
                        fold_in(fold_in(round_seed, start + w), s))
                logits = module(x[w, s], train=True, **kw)
                pl = self.model.per_sample_loss(logits, y[w, s])
                mb = m[w, s]
                loss = (pl * mb).sum() / mb.sum().clamp_min(1.0)
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
                total = total + loss.detach()
            losses.append(total / len(valid_steps))
        # the merge: this rank's weighted sums and every worker's loss at
        # its global index in one buffer, summed over the ranks at once
        flat, sums = _weighted_sums(stacked_vars, local, extra=total_n)
        at = flat.numel() - total_n
        for w, loss in zip(workers, losses):
            flat[at + start + w] = loss
        if self._multi:
            flat = _sum_over_ranks(flat, "kubeml::kavg_merge")
            sums = _views(flat, _leaves(stacked_vars))
        worker_losses = flat[at:]
        denom = max(float(weights.sum()), 1.0)
        part = [int(w) for w in np.flatnonzero(weights)]
        # weights are host numbers: no host-to-device copy, which would
        # wait for the round to finish on the card
        mean_loss = torch.stack([worker_losses[w] * float(weights[w])
                                 for w in part]).sum() / denom
        mean = _means(stacked_vars, sums, denom)
        self.last_round_stats = (
            self._round_stats(stacked_vars, mean, local, workers,
                              torch.stack([worker_losses[w] for w in part]),
                              denom) if self.round_stats else None)
        _assign_workers(stacked_vars, mean)
        return stacked_vars, mean_loss

    def _data_bearing(self, local: np.ndarray, given: Optional[np.ndarray],
                      start: int) -> np.ndarray:
        """The global [N] data-bearing flags as floats: ``given``, checked
        against this rank's own rows, or the local flags (summed over the
        ranks when there are several)."""
        if given is not None:
            given = np.asarray(given, bool)
            if not np.array_equal(given[start:start + len(local)], local):
                raise ValueError(
                    f"data_bearing {given.tolist()} disagrees with the mask "
                    f"of rows [{start}, {start + len(local)})")
            return given.astype(np.float32)
        if not self._multi:
            return local.astype(np.float32)
        flags = torch.zeros(self.world * len(local), device=self.device)
        flags[start:start + len(local)] = torch.from_numpy(
            local.astype(np.float32)).to(self.device)
        flags = _sum_over_ranks(flags, "kubeml::kavg_flags")
        return (flags.cpu().numpy() > 0).astype(np.float32)

    def _round_stats(self, stacked: Variables, mean: Variables,
                     weights: np.ndarray, workers: List[int],
                     worker_losses: torch.Tensor, denom: float
                     ) -> torch.Tensor:
        """[worker-loss spread, pre-merge weight divergence] over the
        round's participants (``worker_losses``: every rank's): max - min
        of their losses, and the participant-weighted Frobenius norm of
        (replica - mean) over the float leaves, relative to the mean's
        norm. ``weights`` and ``workers`` are this rank's rows; over ranks
        the divergence's numerator is summed over the ranks."""
        spread = worker_losses.max() - worker_losses.min()
        pairs = [(v, mv.float()) for v, mv in zip(_leaves(stacked),
                                                  _leaves(mean))
                 if v.is_floating_point()]
        means = [mv for _, mv in pairs]
        num = torch.zeros((), device=spread.device)
        for w in workers:
            d = torch._foreach_sub([v[w].float() for v, _ in pairs], means)
            num = num + float(weights[w]) * torch.stack(
                torch._foreach_norm(d)).pow(2).sum()
        if self._multi:
            num = _sum_over_ranks(num, "kubeml::kavg_stats")
        den = torch.stack(torch._foreach_norm(means)).pow(2).sum()
        divergence = ((num / denom).sqrt() / den.sqrt().clamp_min(1e-12))
        return torch.stack([spread, divergence])

    # --- validation / inference ---

    @torch.no_grad()
    def _eval_sums(self, variables: Variables, batch_x, batch_y, mask):
        x, y, m, _ = self._on_device(batch_x, batch_y, mask)
        x = self.model.preprocess(self._cast_input(x))
        x = x.reshape((-1,) + tuple(x.shape[3:]))
        y = y.reshape((-1,) + tuple(y.shape[3:]))
        m = m.reshape(-1)
        correct = loss = torch.zeros((), device=self.device)
        for i in range(0, x.shape[0], EVAL_CHUNK):
            xc, yc, mc = (t[i:i + EVAL_CHUNK] for t in (x, y, m))
            logits, _ = self.model.forward(variables, xc, train=False)
            # masked SUMS: streamed rounds accumulate sample-weighted
            correct = correct + (self.model.per_sample_correct(logits, yc)
                                 * mc).sum()
            loss = loss + (self.model.per_sample_loss(logits, yc) * mc).sum()
        return correct, loss, m.sum()

    def evaluate(self, stacked_vars: Variables, batch_x, batch_y, mask
                 ) -> Tuple[float, float]:
        """Masked (accuracy, loss) of replica 0 over one ``[N, steps, B,
        ...]`` validation slab (this rank's rows of it over ranks),
        sample-weighted."""
        return self.evaluate_rounds(
            stacked_vars, [SimpleNamespace(x=batch_x, y=batch_y, mask=mask)])

    def evaluate_rounds(self, stacked_vars: Variables, rounds
                        ) -> Tuple[float, float]:
        """Streamed evaluation: masked sums accumulated over an iterable
        of RoundBatches (peak memory is one round). Over ranks each rank
        sums its own rows, and the three sums are summed over the ranks
        (every rank must evaluate)."""
        variables = self._replica0(stacked_vars)
        csum = lsum = msum = 0.0
        for rb in rounds:
            c, l, m = self._eval_sums(variables, rb.x, rb.y, rb.mask)
            csum += float(c)
            lsum += float(l)
            msum += float(m)
        if self._multi:
            sums = torch.tensor([csum, lsum, msum], dtype=torch.float64,
                                device=self.device)
            csum, lsum, msum = _sum_over_ranks(
                sums, "kubeml::kavg_eval").cpu().tolist()
        denom = max(msum, 1.0)
        return csum / denom, lsum / denom

    def snapshot(self, stacked_vars: Variables) -> Variables:
        """A device copy of replica 0: after a sync every replica holds
        the merged weights, and the copy keeps them while the next round
        updates the replicas in place."""
        return _tree_map(lambda v: v[0].detach().clone(), stacked_vars)

    def infer(self, stacked_vars: Variables, x) -> np.ndarray:
        """``model.infer`` on replica 0 for a host batch ``x``."""
        return self.infer_replica(self._replica0(stacked_vars), x)

    @torch.no_grad()
    def infer_replica(self, variables: Variables, x) -> np.ndarray:
        """``model.infer`` on one replica's ``variables`` for a host batch
        ``x``, through a module of its own: training binds the worker
        replicas into the trainer's module, and a request thread must not
        swap that module's tensors while a round runs on it."""
        with self._infer_lock:
            model = self._serving_model()
            xd = self._cast_input(_as_tensor(x)).to(self.device)
            out = model.infer(variables, model.preprocess(xd))
            return out.cpu().numpy()

    @torch.no_grad()
    def generate_replica(self, variables: Variables, req) -> dict:
        """``models.generation.generate_from_request`` on one replica's
        ``variables`` (a causal LM's ``GenerateRequest``), through the same
        module of its own as :meth:`infer_replica`, bound to them for the
        call."""
        from ..models.generation import generate_from_request

        with self._infer_lock:
            module = self._serving_model().module
            bind(module, variables)
            return generate_from_request(module, req)

    def _serving_model(self) -> KubeModel:
        """The request threads' copy of the model (caller holds
        ``_infer_lock``)."""
        if self._infer_model is None:
            model = copy.copy(self.model)
            model._module = self.model.build().to(self.device)
            self._infer_model = model
        return self._infer_model


"""Round loader: the host-side data pipeline feeding the K-AVG engine; the
port's copy of ``kubeml_tpu/data/loader.py`` (numpy packing path).

Each round's zero-copy mmap slices are assembled into one uniform
``[N, steps, B, ...]`` slab, built on a background thread one round ahead
of the consumer. Workers own sample ranges of slightly different sizes;
ragged tails are zero-padded to the plan's shape and a ``[N, steps, B]``
float mask (1.0 = real sample) marks the real samples. Over ranks a
rank assembles only its block of worker rows (``worker_rows``), exactly
those rows of the full slab.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..storage.store import DatasetHandle
from .sharding import RoundPlan, plan_eval


@dataclass
class RoundBatch:
    """One sync round of data: all N workers, or over ranks this rank's
    ``worker_rows`` block of the worker axis."""

    x: np.ndarray  # [rows, steps, B, ...]
    y: np.ndarray  # [rows, steps, B, ...]
    mask: np.ndarray  # [rows, steps, B] float32
    round_index: int
    worker_rows: Tuple[int, int] = (0, 0)  # [start, end) of the worker axis


def _worker_round_slice(handle: DatasetHandle, split: str, plan: RoundPlan,
                        worker: int, round_index: int
                        ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """The real (unpadded) samples worker ``worker`` consumes in this
    round; ``(None, None)`` once its shard is exhausted."""
    start_doc, end_doc = plan.worker_ranges[worker]
    n_total = handle.num_samples(split)
    lo = start_doc * plan.subset_size
    hi = min(end_doc * plan.subset_size, n_total)
    per_round = plan.samples_per_worker_round
    a = lo + round_index * per_round
    b = min(a + per_round, hi)
    if a >= b:
        return None, None
    return handle.raw(split, "data")[a:b], handle.raw(split, "labels")[a:b]


def _pack(dst: np.ndarray, srcs: List[Optional[np.ndarray]],
          counts: List[int]) -> None:
    """Fill ``dst [N, per_round, ...]``: worker w gets
    ``srcs[w][:counts[w]]``, then zeros."""
    per_round = dst.shape[1]
    for w, (s, c) in enumerate(zip(srcs, counts)):
        c = min(int(c), per_round) if s is not None else 0
        if c > 0:
            dst[w, :c] = s[:c]
        if c < per_round:
            dst[w, c:] = 0


def build_round(handle: DatasetHandle, split: str, plan: RoundPlan,
                round_index: int, transform=None,
                worker_rows: Optional[Tuple[int, int]] = None) -> RoundBatch:
    """Assemble the uniform padded ``[rows, steps, B, ...]`` slabs of one
    round (``transform`` applied to each worker's real samples first).

    ``worker_rows`` ([start, end) of the worker axis) restricts the slab
    to one rank's block: only those workers' samples are read. A block
    whose workers are all exhausted while another rank's still hold data
    is a slab of zeros with a zero mask (its shapes probed with one
    sample through ``transform``), so every rank runs the same rounds."""
    ws, we = worker_rows if worker_rows is not None else (0, plan.n_workers)
    n, steps, bsz = we - ws, plan.steps_per_round, plan.batch_size
    per_round = steps * bsz
    xs, ys, counts = [], [], []
    x0 = y0 = None
    for w in range(ws, we):
        x, y = _worker_round_slice(handle, split, plan, w, round_index)
        if x is None:
            xs.append(None)
            ys.append(None)
            counts.append(0)
            continue
        if transform is not None:
            x, y = transform(np.asarray(x), np.asarray(y))
        x0, y0 = np.asarray(x), np.asarray(y)
        xs.append(x0)
        ys.append(y0)
        counts.append(len(x0))
    if x0 is None:
        if worker_rows is None:
            raise ValueError(f"round {round_index}: no worker has data")
        x0 = np.asarray(handle.raw(split, "data")[:1])
        y0 = np.asarray(handle.raw(split, "labels")[:1])
        if transform is not None:
            x0, y0 = (np.asarray(a) for a in transform(x0, y0))
    X = np.empty((n, per_round, *x0.shape[1:]), x0.dtype)
    Y = np.empty((n, per_round, *y0.shape[1:]), y0.dtype)
    _pack(X, xs, counts)
    _pack(Y, ys, counts)
    M = np.zeros((n, per_round), np.float32)
    for w, c in enumerate(counts):
        M[w, : min(c, per_round)] = 1.0
    return RoundBatch(
        x=X.reshape(n, steps, bsz, *x0.shape[1:]),
        y=Y.reshape(n, steps, bsz, *y0.shape[1:]),
        mask=M.reshape(n, steps, bsz),
        round_index=round_index,
        worker_rows=(ws, we),
    )


class RoundLoader:
    """Iterates an epoch's RoundBatches, built ``prefetch`` rounds ahead on
    a background thread; ``worker_rows`` as :func:`build_round`'s."""

    def __init__(self, handle: DatasetHandle, split: str, plan: RoundPlan,
                 transform=None, prefetch: int = 2,
                 worker_rows: Optional[Tuple[int, int]] = None):
        self.handle = handle
        self.split = split
        self.plan = plan
        self.transform = transform
        self.prefetch = max(1, prefetch)
        self.worker_rows = worker_rows

    def __len__(self) -> int:
        return self.plan.num_rounds

    def __iter__(self) -> Iterator[RoundBatch]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_or_abort(item) -> bool:
            # an abandoned consumer sets `stop`: never park on a full queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for r in range(self.plan.num_rounds):
                    if stop.is_set():
                        return
                    if not put_or_abort(build_round(
                            self.handle, self.split, self.plan, r,
                            self.transform, self.worker_rows)):
                        return
                put_or_abort(None)
            except Exception as e:  # surfaced in the consumer
                put_or_abort(e)

        t = threading.Thread(target=producer, name="round-loader", daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()


def validation_loader(handle: DatasetHandle, n_workers: int, batch_size: int,
                      transform=None, max_steps_per_round: int = 32,
                      worker_rows: Optional[Tuple[int, int]] = None
                      ) -> RoundLoader:
    """Stream the test split in rounds of at most ``max_steps_per_round``
    steps, so peak memory stays one round; ``worker_rows`` as
    :func:`build_round`'s."""
    plan = plan_eval(
        num_docs=handle.num_subsets("test"),
        n_workers=n_workers,
        batch_size=batch_size,
        subset_size=handle.subset_size,
        num_samples=handle.num_samples("test"),
        max_steps_per_round=max_steps_per_round,
    )
    return RoundLoader(handle, "test", plan, transform=transform,
                       worker_rows=worker_rows)

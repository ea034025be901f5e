"""Shard-range and K-interval math: the port's copy of
``kubeml_tpu/data/sharding.py``.

* each of N workers owns a balanced *contiguous* range of 64-sample logical
  docs (``split_minibatches``);
* training proceeds in *sync rounds*: each worker runs K local optimizer
  steps of batch size B (consuming ``ceil(B*K/64)`` docs), then the
  workers' weights are averaged; ``K == -1`` means one sync per epoch.

Each round's data is one uniform ``[N, steps, B, ...]`` slab. Ragged tails
(shards differing by a doc, final partial batches) are padded and masked:
padded samples carry zero loss weight and zero gradient.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..api.types import STORAGE_SUBSET_SIZE


def split_minibatches(num_docs: int, n_workers: int) -> List[Tuple[int, int]]:
    """Balanced contiguous doc ranges ``[(start, end), ...]`` per worker —
    numpy.array_split semantics like the reference (util.py:46-56). Workers beyond
    ``num_docs`` get empty ranges."""
    if n_workers <= 0:
        raise ValueError("n_workers must be positive")
    base, extra = divmod(num_docs, n_workers)
    out = []
    start = 0
    for w in range(n_workers):
        size = base + (1 if w < extra else 0)
        out.append((start, start + size))
        start += size
    return out


def subset_period(k: int, batch_size: int, subset_size: int = STORAGE_SUBSET_SIZE) -> int:
    """Docs consumed per sync round: ``ceil(B*K/subset)`` (util.py:59-81).
    ``k == -1`` (sparse averaging) is handled by the caller as "whole shard"."""
    if k < 1:
        raise ValueError("subset_period requires k >= 1; k == -1 is whole-shard")
    return max(1, math.ceil(batch_size * k / subset_size))


@dataclass(frozen=True)
class RoundPlan:
    """Static shape plan for one epoch of lockstep K-AVG training.

    ``steps_per_round`` local optimizer steps of ``batch_size`` samples run per
    worker per sync round; the last round (and last worker shards) may be padded.
    """

    n_workers: int
    batch_size: int
    k: int  # -1 => single round covering the whole shard
    num_docs: int
    subset_size: int
    worker_ranges: List[Tuple[int, int]]  # contiguous doc ranges
    num_rounds: int
    steps_per_round: int  # uniform across rounds/workers (padding fills the tail)
    # true dataset length (the last doc may be partial); num_docs*subset_size
    # when the caller didn't know better
    num_samples: int = 0

    @property
    def samples_per_worker_round(self) -> int:
        return self.steps_per_round * self.batch_size

    def worker_samples(self) -> List[int]:
        """Real (unpadded) sample count of each worker's shard."""
        cap = self.num_samples or self.num_docs * self.subset_size
        return [
            max(0, min(e * self.subset_size, cap) - s * self.subset_size)
            for s, e in self.worker_ranges
        ]

    def data_bearing(self, round_index: int) -> np.ndarray:
        """[n_workers] bool: which workers have ANY real sample in this
        round (plan math, no data read)."""
        spr = self.samples_per_worker_round
        return np.asarray(
            [ws > round_index * spr for ws in self.worker_samples()], bool
        )


def plan_epoch(
    num_docs: int,
    n_workers: int,
    batch_size: int,
    k: int,
    subset_size: int = STORAGE_SUBSET_SIZE,
    num_samples: Optional[int] = None,
) -> RoundPlan:
    """Lay out an epoch: worker doc ranges, number of sync rounds, steps per round.

    The largest worker shard determines the round count; smaller shards pad their
    final rounds. With ``k == -1`` there is exactly one round spanning the whole
    shard (one weight average per epoch). ``num_samples`` is the true dataset
    length (the last doc may be partial); rounds are counted in *samples actually
    consumed* (``steps_per_round * batch_size`` per round), so non-divisor batch
    sizes never plan empty trailing rounds."""
    if num_docs < 1:
        raise ValueError("dataset has no docs")
    if batch_size < 1:
        raise ValueError("batch_size must be >= 1")
    if num_samples is None:
        num_samples = num_docs * subset_size
    ranges = split_minibatches(num_docs, n_workers)
    max_worker_samples = max(
        max(0, min(e * subset_size, num_samples) - s * subset_size) for s, e in ranges
    )
    if max_worker_samples == 0:
        raise ValueError(f"more workers ({n_workers}) than docs ({num_docs})")
    if k == -1:
        steps = math.ceil(max_worker_samples / batch_size)
        num_rounds = 1
    else:
        period = subset_period(k, batch_size, subset_size)
        # the reference loads `period` docs per round and steps over EVERY batch
        # in them (network.py:278-307), so local steps are doc-granular: with
        # B=16, K=1 one 64-sample doc still yields 4 local steps.
        steps = math.ceil(period * subset_size / batch_size)
        num_rounds = math.ceil(max_worker_samples / (steps * batch_size))
    return RoundPlan(
        n_workers=n_workers,
        batch_size=batch_size,
        k=k,
        num_docs=num_docs,
        subset_size=subset_size,
        worker_ranges=ranges,
        num_rounds=num_rounds,
        steps_per_round=steps,
        num_samples=num_samples,
    )


def plan_eval(
    num_docs: int,
    n_workers: int,
    batch_size: int,
    subset_size: int = STORAGE_SUBSET_SIZE,
    num_samples: Optional[int] = None,
    max_steps_per_round: int = 32,
) -> RoundPlan:
    """Plan a streamed evaluation pass: like a ``k == -1`` epoch but with rounds
    capped at ``max_steps_per_round`` steps so the whole test split is never
    materialized as one slab (peak memory stays bounded for large datasets)."""
    if num_samples is None:
        num_samples = num_docs * subset_size
    ranges = split_minibatches(num_docs, n_workers)
    max_worker_samples = max(
        max(0, min(e * subset_size, num_samples) - s * subset_size) for s, e in ranges
    )
    if max_worker_samples == 0:
        raise ValueError(f"more workers ({n_workers}) than docs ({num_docs})")
    total_steps = math.ceil(max_worker_samples / batch_size)
    steps = min(total_steps, max_steps_per_round)
    num_rounds = math.ceil(max_worker_samples / (steps * batch_size))
    return RoundPlan(
        n_workers=n_workers,
        batch_size=batch_size,
        k=-1,
        num_docs=num_docs,
        subset_size=subset_size,
        worker_ranges=ranges,
        num_rounds=num_rounds,
        steps_per_round=steps,
        num_samples=num_samples,
    )

"""KubeDataset, the user-facing dataset handle: the port's copy of
``kubeml_tpu/data/dataset.py``.

The user names a stored dataset; the runtime attaches the store's handle
and flips a train/validation mode flag the user's ``transform`` can branch
on. ``transform`` works on whole numpy arrays (a sync round's slab at a
time), on the host."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..api.errors import DatasetNotFoundError
from ..storage.store import DatasetHandle, ShardStore


@dataclass
class TrainParams:
    """Per-invocation parameters of a training task."""

    job_id: str
    n_workers: int
    k: int
    task: str
    func_id: int = 0
    lr: float = 0.01
    batch_size: int = 64
    epoch: int = 0


class KubeDataset:
    """User-facing dataset: subclass and override :meth:`transform` if
    needed::

        class Cifar(KubeDataset):
            def __init__(self):
                super().__init__("cifar10")
    """

    def __init__(self, dataset_name: str):
        self.dataset = dataset_name
        self._handle: Optional[DatasetHandle] = None
        self._training = True

    def _attach(self, store: ShardStore) -> None:
        if not store.exists(self.dataset):
            raise DatasetNotFoundError(self.dataset)
        self._handle = store.get(self.dataset)

    @property
    def handle(self) -> DatasetHandle:
        if self._handle is None:
            raise RuntimeError(
                "KubeDataset is not attached to a store; it must be run by "
                "the runtime (or call _attach() in tests)"
            )
        return self._handle

    def set_mode(self, training: bool) -> None:
        self._training = training

    def is_training(self) -> bool:
        return self._training

    @property
    def num_train(self) -> int:
        return self.handle.num_samples("train")

    @property
    def num_test(self) -> int:
        return self.handle.num_samples("test")

    def transform(self, x: np.ndarray, y: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Whole-array preprocessing hook; default identity. Called on host
        numpy arrays for each sync round's slab (train) or validation
        round."""
        return x, y

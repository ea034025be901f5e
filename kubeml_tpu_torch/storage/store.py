"""Sharded dataset store: the port's copy of ``kubeml_tpu/storage/store.py``.

Same on-disk format, so either package reads a dataset the other wrote::

    <root>/<name>/manifest.json
    <root>/<name>/train/{data,labels}.npy
    <root>/<name>/test/{data,labels}.npy

Each split is a pair of contiguous ``.npy`` arrays opened memory-mapped; a
worker's contiguous range is a zero-copy slice. The 64-sample logical
"subset" (``STORAGE_SUBSET_SIZE``) stays the unit of the K-interval and
shard-range math (``data/sharding.py``). Numpy only.
"""

from __future__ import annotations

import json
import math
import shutil
import time
import uuid
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ..api.config import Config, get_config
from ..api.errors import (DataError, DatasetExistsError, DatasetNotFoundError,
                          StorageError)
from ..api.types import STORAGE_SUBSET_SIZE, DatasetSummary

MANIFEST = "manifest.json"
SPLITS = ("train", "test")


class DatasetHandle:
    """Read handle on one stored dataset: mmap arrays + subset-range slicing."""

    def __init__(self, name: str, path: Path, manifest: dict):
        self.name = name
        self.path = path
        self.manifest = manifest
        self.subset_size = int(manifest.get("subset_size", STORAGE_SUBSET_SIZE))
        self._arrays: dict = {}

    def _load(self, split: str, kind: str) -> np.ndarray:
        key = (split, kind)
        if key not in self._arrays:
            f = self.path / split / f"{kind}.npy"
            if not f.exists():
                raise StorageError(f"missing {split}/{kind}.npy for dataset {self.name!r}")
            self._arrays[key] = np.load(f, mmap_mode="r")
        return self._arrays[key]

    def raw(self, split: str, kind: str = "data") -> np.ndarray:
        """The whole split as a memory-mapped array (zero-copy; callers
        slice). ``kind`` is "data" or "labels"."""
        return self._load(split, kind)

    def num_samples(self, split: str) -> int:
        return int(self.manifest["splits"][split]["samples"])

    def num_subsets(self, split: str) -> int:
        """Number of logical 64-sample docs."""
        return math.ceil(self.num_samples(split) / self.subset_size)

    def load_subset_range(self, split: str, start: int, end: int
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """Samples of logical docs ``[start, end)`` as a zero-copy slice."""
        n = self.num_samples(split)
        lo = max(0, start * self.subset_size)
        hi = min(n, end * self.subset_size)
        if lo >= hi:
            raise DataError(
                f"empty subset range [{start}, {end}) for split {split!r} of {self.name!r}"
            )
        x = self._load(split, "data")[lo:hi]
        y = self._load(split, "labels")[lo:hi]
        # the dataset bytes entering the input pipeline (mmap slices fault
        # lazily: bytes only, no blocking time to make a bandwidth of)
        from ..utils import profiler

        profiler.account("dataset.read", x.nbytes + y.nbytes)
        return x, y

    def summary(self) -> DatasetSummary:
        return DatasetSummary(
            name=self.name,
            train_set_size=self.num_samples("train"),
            test_set_size=self.num_samples("test"),
        )


class ShardStore:
    """Filesystem dataset store: create/get/list/delete + summaries."""

    def __init__(self, root: Optional[Path] = None, config: Optional[Config] = None):
        cfg = config or get_config()
        self.root = Path(root) if root is not None else cfg.datasets_dir
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, name: str) -> Path:
        if not name or "/" in name or name.startswith("."):
            raise DataError(f"invalid dataset name {name!r}")
        return self.root / name

    def exists(self, name: str) -> bool:
        return (self._path(name) / MANIFEST).exists()

    def create(
        self,
        name: str,
        x_train: np.ndarray,
        y_train: np.ndarray,
        x_test: np.ndarray,
        y_test: np.ndarray,
        meta: Optional[dict] = None,
    ) -> DatasetSummary:
        """Ingest a dataset: both splits written under a hidden staging
        directory, then published by one atomic rename."""
        if self.exists(name):
            raise DatasetExistsError(name)
        arrays = {
            "train": (np.asarray(x_train), np.asarray(y_train)),
            "test": (np.asarray(x_test), np.asarray(y_test)),
        }
        for split, (x, y) in arrays.items():
            if len(x) != len(y):
                raise DataError(
                    f"{split}: data/labels length mismatch ({len(x)} vs {len(y)})"
                )
            if len(x) == 0:
                raise DataError(f"{split}: empty split")
            # object arrays would be saved as pickles, which the mmap read
            # path refuses
            if x.dtype == object or y.dtype == object:
                raise DataError(
                    f"{split}: arrays must have a uniform numeric dtype "
                    f"(got data={x.dtype}, labels={y.dtype})"
                )
        path = self._path(name)
        staging_root = self.root / ".staging"
        staging_root.mkdir(exist_ok=True)
        tmp = staging_root / f"{name}-{uuid.uuid4().hex[:8]}"
        try:
            for split, (x, y) in arrays.items():
                d = tmp / split
                d.mkdir(parents=True)
                np.save(d / "data.npy", x)
                np.save(d / "labels.npy", y)
            manifest = {
                "name": name,
                "subset_size": STORAGE_SUBSET_SIZE,
                "created_at": time.time(),
                **({"meta": meta} if meta else {}),
                "splits": {
                    split: {
                        "samples": len(x),
                        "data_shape": list(x.shape[1:]),
                        "data_dtype": str(x.dtype),
                        "labels_dtype": str(y.dtype),
                    }
                    for split, (x, y) in arrays.items()
                },
            }
            (tmp / MANIFEST).write_text(json.dumps(manifest, indent=1))
            try:
                tmp.rename(path)  # atomic publish
            except OSError:
                # lost a concurrent-create race for the same name
                raise DatasetExistsError(name)
        except Exception:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        return DatasetSummary(name=name, train_set_size=len(arrays["train"][0]),
                              test_set_size=len(arrays["test"][0]))

    def get(self, name: str) -> DatasetHandle:
        path = self._path(name)
        mf = path / MANIFEST
        if not mf.exists():
            raise DatasetNotFoundError(name)
        return DatasetHandle(name, path, json.loads(mf.read_text()))

    def delete(self, name: str) -> None:
        path = self._path(name)
        if not (path / MANIFEST).exists():
            raise DatasetNotFoundError(name)
        shutil.rmtree(path)

    def list(self) -> List[DatasetSummary]:
        out = []
        for p in sorted(self.root.iterdir()):
            if p.is_dir() and not p.name.startswith(".") and (p / MANIFEST).exists():
                out.append(self.get(p.name).summary())
        return out

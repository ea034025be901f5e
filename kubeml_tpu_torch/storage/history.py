"""Training-history store: the port's copy of
``kubeml_tpu/storage/history.py``. One JSON file per job under the
config's history directory, written by an atomic rename; the same format
as the JAX package's."""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional

from ..api.config import Config, get_config
from ..api.errors import JobNotFoundError
from ..api.types import History


class HistoryStore:
    def __init__(self, root: Optional[Path] = None, config: Optional[Config] = None):
        cfg = config or get_config()
        self.root = Path(root) if root is not None else cfg.history_path
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, job_id: str) -> Path:
        if not job_id or "/" in job_id or job_id.startswith("."):
            raise JobNotFoundError(job_id)
        return self.root / f"{job_id}.json"

    def save(self, history: History) -> None:
        path = self._path(history.id)
        tmp = path.with_suffix(".tmp")
        tmp.write_text(history.to_json())
        os.replace(tmp, path)

    def get(self, job_id: str) -> History:
        path = self._path(job_id)
        if not path.exists():
            raise JobNotFoundError(job_id)
        return History.from_json(path.read_text())

    def delete(self, job_id: str) -> None:
        path = self._path(job_id)
        if not path.exists():
            raise JobNotFoundError(job_id)
        path.unlink()

    def list(self) -> List[History]:
        return [
            History.from_json(p.read_text()) for p in sorted(self.root.glob("*.json"))
        ]

    def prune(self) -> int:
        """Delete all histories."""
        n = 0
        for p in self.root.glob("*.json"):
            p.unlink()
            n += 1
        return n

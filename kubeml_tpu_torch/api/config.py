"""The port's configuration: the settings its K-AVG and serving paths read.

A small own copy of ``kubeml_tpu/api/config.py``'s ``Config``, read from
the same environment variables with the same defaults: the data root
(``KUBEML_DATA_ROOT``, default ``~/.kubeml``) with the dataset and history
directories under it, whether the K-AVG round also returns its
statistical-efficiency signals (``KUBEML_ROUND_STATS``, default on), and
the paged engine's admission limit, shed policy, drain grace, snapshot
directory and pool-audit interval.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional


def _env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.lower() not in ("0", "false", "no", "")


@dataclass
class Config:
    data_root: Path = field(default_factory=lambda: Path(
        os.environ.get("KUBEML_DATA_ROOT", "~/.kubeml")).expanduser())
    # per-round [worker-loss spread, pre-merge weight divergence]
    round_stats: bool = field(
        default_factory=lambda: _env_bool("KUBEML_ROUND_STATS", True))
    # queued rows past this limit are refused with 429 (0 = unbounded)
    serving_queue_limit: int = field(default_factory=lambda: int(
        os.environ.get("KUBEML_SERVING_QUEUE_LIMIT") or 256))
    # at the limit: "reject" refuses the NEW request, "oldest" sheds the
    # longest-queued request (its waiter gets the 429) and admits the new
    serving_shed_policy: str = field(default_factory=lambda: os.environ.get(
        "KUBEML_SERVING_SHED", "reject"))
    # seconds drain() gives live rows to finish before snapshotting them
    drain_grace: float = field(default_factory=lambda: float(
        os.environ.get("KUBEML_DRAIN_GRACE", "20")))
    # where drained KMS1 frames land ("" = no cross-process hop)
    snap_dir: str = field(default_factory=lambda: os.environ.get(
        "KUBEML_SNAP_DIR", ""))
    # seconds between KVPool.check() audits of the engine loop (0 = off)
    pool_audit_interval: float = field(default_factory=lambda: float(
        os.environ.get("KUBEML_POOL_AUDIT_INTERVAL", "0")))

    @property
    def datasets_dir(self) -> Path:
        return self.data_root / "datasets"

    @property
    def history_path(self) -> Path:
        return self.data_root / "history"


_default_config: Optional[Config] = None


def get_config() -> Config:
    """Process-wide default config (constructed from the environment at
    first use)."""
    global _default_config
    if _default_config is None:
        _default_config = Config()
    return _default_config


def set_config(cfg: Config) -> None:
    global _default_config
    _default_config = cfg

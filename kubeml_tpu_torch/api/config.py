"""The port's configuration: the few settings its K-AVG path reads.

A small own copy of ``kubeml_tpu/api/config.py``'s ``Config``, read from
the same environment variables: the data root (``KUBEML_DATA_ROOT``,
default ``~/.kubeml``) with the dataset and history directories under it,
and whether the K-AVG round also returns its statistical-efficiency
signals (``KUBEML_ROUND_STATS``, default on).
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

"""Dataset and history stores of the port (numpy and JSON on disk, in the
JAX package's formats)."""

from .history import HistoryStore
from .store import DatasetHandle, ShardStore

__all__ = ["DatasetHandle", "ShardStore", "HistoryStore"]

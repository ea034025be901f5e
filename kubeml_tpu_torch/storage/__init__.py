"""Dataset, history and checkpoint stores of the port (numpy and JSON on
disk, in the JAX package's formats)."""

from .checkpoint import FINAL_TAG, Checkpoint, CheckpointStore
from .history import HistoryStore
from .store import DatasetHandle, ShardStore

__all__ = ["DatasetHandle", "ShardStore", "HistoryStore", "CheckpointStore",
           "Checkpoint", "FINAL_TAG"]

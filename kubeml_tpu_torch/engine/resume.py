"""Which checkpoint a resumed job starts from: the port of
``kubeml_tpu/engine/resume.py``.

The newest of (latest epoch checkpoint, final export) wins: the final
export records its completed-epoch count as ``epoch`` (the next epoch
index), an epoch checkpoint ``epNNNNN`` resumes at ``N + 1``, and after a
crash mid-run the newest epoch checkpoint can be ahead of an older run's
final export, so the larger start epoch wins.
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..storage.checkpoint import FINAL_TAG, Checkpoint, CheckpointStore


def select_resume_checkpoint(store: CheckpointStore, job_id: str
                             ) -> Optional[Tuple[int, Checkpoint]]:
    """(start_epoch, checkpoint) to resume from, or None when nothing
    exists. The choice is made from metadata; only the winner's weights
    are read."""
    tags = store.tags(job_id)
    if not tags:
        return None
    last = store.latest_epoch(job_id)
    if FINAL_TAG in tags:
        final_epoch = int(store.read_meta(job_id, FINAL_TAG).get("epoch", 0))
        if last is None or final_epoch > last + 1:
            return (final_epoch, store.restore(job_id, tag=FINAL_TAG))
    if last is None:
        return None
    return (last + 1, store.restore(job_id, epoch=last))


def extend_history(history, ck: Checkpoint) -> None:
    """Splice the checkpoint's recorded history lists onto a fresh
    History (setup notes the resumed job records again are not
    doubled)."""
    for key, vals in ck.meta.get("history", {}).items():
        if not hasattr(history, key):
            continue
        target = getattr(history, key)
        if key == "notes":
            target.extend(v for v in vals if v not in target)
        else:
            target.extend(vals)

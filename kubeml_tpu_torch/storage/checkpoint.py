"""Checkpoints and the final model export: the port of
``kubeml_tpu/storage/checkpoint.py``, in its on-disk format.

One ``.npz`` per (job, tag) under ``<root>/<job_id>/<tag>.npz`` holds the
flattened leaves of a nested-dict tree under their slash paths
(``params/block_0/attn/query/kernel``) plus a ``__meta__`` JSON record
(``job_id``, ``tag``, ``epoch``, ``saved_at``, ``dtypes`` per path and the
caller's ``meta``). A file either package writes loads in the other: the
port saves its weights in the Flax layout (``interop.from_flax.to_flax``)
and reads them back through ``from_flax``.

Leaves may be numpy arrays or torch tensors (copied to the host). bfloat16
leaves, which numpy cannot hold, are stored as their 16-bit patterns
(uint16) under the dtype string ``"bfloat16"``, through a torch bitcast
(no ``ml_dtypes``). Writes stage into ``<root>/.staging`` and publish with
``os.replace``, which atomically replaces an existing same-tag file.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import time
import uuid
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..api.config import Config, get_config
from ..api.errors import CheckpointNotFoundError, StorageError

META_KEY = "__meta__"
FINAL_TAG = "final"
SUFFIX = ".npz"
_EPOCH_RE = re.compile(r"^ep(\d{5})$")
_BF16 = "bfloat16"


def _host_leaf(leaf) -> Tuple[np.ndarray, str]:
    """(numpy array to store, dtype string) of one leaf; bfloat16 becomes
    its uint16 bit patterns."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            bits = t.contiguous().view(torch.int16).numpy()
            return bits.view(np.uint16), _BF16
        a = t.numpy()
        return a, str(a.dtype)
    a = np.asarray(leaf)
    dt = str(a.dtype)
    if dt == _BF16:  # an ml_dtypes array handed in by a caller
        return a.view(np.uint16), dt
    return a, dt


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """Flatten a nested-dict tree into sorted ('a/b/c', leaf) pairs."""
    out: List[Tuple[str, Any]] = []
    if isinstance(tree, dict):
        for k in sorted(tree):
            if "/" in str(k):
                raise StorageError(f"checkpoint key {k!r} may not contain '/'")
            out.extend(_flatten(tree[k], f"{prefix}{k}/"))
        return out
    if prefix == "":
        raise StorageError("checkpoint root must be a dict pytree")
    return [(prefix[:-1], tree)]


def _unflatten(pairs: Dict[str, Any]) -> Dict[str, Any]:
    root: Dict[str, Any] = {}
    for path, leaf in pairs.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return root


@dataclass
class Checkpoint:
    """One restored checkpoint. ``variables`` is the nested tree of numpy
    arrays, except bfloat16 leaves, which come back as CPU
    ``torch.bfloat16`` tensors (numpy has no bfloat16)."""

    job_id: str
    tag: str
    variables: Dict[str, Any]
    epoch: int = 0
    meta: Dict[str, Any] = field(default_factory=dict)


def _tag_for_epoch(epoch: int) -> str:
    return f"ep{epoch:05d}"


def normalize_npz(dest: Path) -> Path:
    """A checkpoint destination with the .npz suffix (np.savez would append
    it, and the path reported would not be the file's)."""
    dest = Path(dest)
    return dest if dest.suffix == SUFFIX else dest.with_name(dest.name + SUFFIX)


def _read_file(path: Path, job_id: str, tag: str) -> Checkpoint:
    with np.load(path) as z:
        record = json.loads(bytes(z[META_KEY]).decode())
        pairs = {}
        for p, dt in record["dtypes"].items():
            leaf = z[p]
            if dt == _BF16:
                leaf = torch.from_numpy(leaf.view(np.int16)).view(
                    torch.bfloat16)
            pairs[p] = leaf
    return Checkpoint(
        job_id=record.get("job_id", job_id),
        tag=record.get("tag", tag),
        variables=_unflatten(pairs),
        epoch=int(record.get("epoch", 0)),
        meta=record.get("meta", {}),
    )


class CheckpointStore:
    """Filesystem checkpoint store.

    Layout::

        <root>/<job_id>/ep00003.npz
        <root>/<job_id>/final.npz
    """

    def __init__(self, root: Optional[Path] = None,
                 config: Optional[Config] = None):
        cfg = config or get_config()
        self.root = Path(root) if root is not None else cfg.checkpoints_dir
        self.root.mkdir(parents=True, exist_ok=True)

    def _job_dir(self, job_id: str) -> Path:
        if not job_id or "/" in job_id or job_id.startswith("."):
            raise StorageError(f"invalid job id {job_id!r}")
        return self.root / job_id

    def _tag_path(self, job_id: str, tag: str) -> Path:
        if not tag or "/" in tag or tag.startswith("."):
            raise StorageError(f"invalid checkpoint tag {tag!r}")
        return self._job_dir(job_id) / f"{tag}{SUFFIX}"

    # --- write ---

    def save(self, job_id: str, variables: Dict[str, Any], *,
             epoch: int = 0, tag: Optional[str] = None,
             meta: Optional[Dict[str, Any]] = None) -> Path:
        """Persist one replica of a nested-dict tree. ``tag`` defaults to
        the epoch tag; ``FINAL_TAG`` is the end-of-job export. A same-tag
        save atomically replaces the previous file."""
        tag = tag or _tag_for_epoch(epoch)
        record: Dict[str, Any] = {
            "job_id": job_id,
            "tag": tag,
            "epoch": int(epoch),
            "saved_at": time.time(),
            "dtypes": {},
            "meta": meta or {},
        }
        blobs: Dict[str, np.ndarray] = {}
        for path, leaf in _flatten(variables):
            blobs[path], record["dtypes"][path] = _host_leaf(leaf)
        blobs[META_KEY] = np.frombuffer(json.dumps(record).encode(), np.uint8)

        dest = self._tag_path(job_id, tag)
        staging = self.root / ".staging"
        staging.mkdir(exist_ok=True)
        tmp = staging / f"{uuid.uuid4().hex}{SUFFIX}"
        try:
            np.savez(tmp, **blobs)
            dest.parent.mkdir(exist_ok=True)
            os.replace(tmp, dest)  # atomic publish, atomic overwrite
        except Exception:
            tmp.unlink(missing_ok=True)
            raise
        return dest

    # --- read ---

    def epochs(self, job_id: str) -> List[int]:
        out = []
        for tag in self.tags(job_id):
            m = _EPOCH_RE.match(tag)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def tags(self, job_id: str) -> List[str]:
        d = self._job_dir(job_id)
        if not d.exists():
            return []
        return sorted(p.stem for p in d.glob(f"*{SUFFIX}"))

    def latest_epoch(self, job_id: str) -> Optional[int]:
        eps = self.epochs(job_id)
        return eps[-1] if eps else None

    def restore(self, job_id: str, epoch: Optional[int] = None,
                tag: Optional[str] = None) -> Checkpoint:
        """Load a checkpoint: explicit ``tag`` > explicit ``epoch`` > final
        > latest epoch (the resolution of :meth:`export_path`)."""
        path = self.export_path(job_id, epoch=epoch, tag=tag)
        return _read_file(path, job_id, path.stem)

    def prune_epochs(self, job_id: str, keep: int) -> int:
        """Keep only the newest ``keep`` epoch checkpoints (the final
        export is never touched); returns how many were deleted. ``keep
        <= 0`` keeps all."""
        if keep <= 0:
            return 0
        eps = self.epochs(job_id)
        n = 0
        for epoch in eps[:-keep] if len(eps) > keep else []:
            try:
                self.delete(job_id, tag=_tag_for_epoch(epoch))
                n += 1
            except CheckpointNotFoundError:
                pass  # deleted meanwhile; retention is best effort
        return n

    def read_meta(self, job_id: str, tag: str) -> Dict[str, Any]:
        """The checkpoint's ``__meta__`` record, without reading any weight
        array (npz members load lazily)."""
        path = self._tag_path(job_id, tag)
        if not path.exists():
            raise CheckpointNotFoundError(f"{job_id}/{tag}")
        with np.load(path) as z:
            return json.loads(bytes(z[META_KEY]).decode())

    def list_jobs(self) -> List[str]:
        return sorted(
            p.name for p in self.root.iterdir()
            if p.is_dir() and not p.name.startswith(".") and self.tags(p.name))

    def delete(self, job_id: str, tag: Optional[str] = None) -> None:
        if tag is not None:
            path = self._tag_path(job_id, tag)
            if not path.exists():
                raise CheckpointNotFoundError(f"{job_id}/{tag}")
            path.unlink()
            return
        d = self._job_dir(job_id)
        if not d.exists():
            raise CheckpointNotFoundError(job_id)
        shutil.rmtree(d)

    def sharded_mtime(self, job_id: str, tag: str) -> Optional[int]:
        """The mtime (ns) of the sharded checkpoint of the same tag under
        this root (``storage.sharded_checkpoint``: the manifest of
        ``<job_id>/<tag>.shards``), None without one: the serving path,
        the quantizer and the controller serve whichever of the flat and
        the sharded form is newer."""
        try:
            path = self._job_dir(job_id) / f"{tag}.shards" / "manifest.json"
            return path.stat().st_mtime_ns
        except (StorageError, OSError):
            return None

    def final_form(self, job_id: str, tag: str):
        """(form, mtime_ns) of the newer of the flat and the sharded
        checkpoint of ``tag`` (``"flat"`` on a tie), or (None, None)
        without either; a malformed id finds nothing."""
        try:
            flat = self.export_path(job_id, tag=tag).stat().st_mtime_ns
        except (CheckpointNotFoundError, StorageError, OSError):
            flat = None
        sharded = self.sharded_mtime(job_id, tag)
        if sharded is None or (flat is not None and flat >= sharded):
            return ("flat" if flat is not None else None), flat
        return "sharded", sharded

    # --- single-file export (the stored file is the portable format) ---

    def export_path(self, job_id: str, epoch: Optional[int] = None,
                    tag: Optional[str] = None) -> Path:
        """The file of a checkpoint (explicit tag > epoch > final > latest
        epoch)."""
        ck_tag = tag
        if ck_tag is None:
            if epoch is not None:
                ck_tag = _tag_for_epoch(epoch)
            elif FINAL_TAG in self.tags(job_id):
                ck_tag = FINAL_TAG
            else:
                last = self.latest_epoch(job_id)
                if last is None:
                    raise CheckpointNotFoundError(job_id)
                ck_tag = _tag_for_epoch(last)
        path = self._tag_path(job_id, ck_tag)
        if not path.exists():
            raise CheckpointNotFoundError(f"{job_id}/{ck_tag}")
        return path

    def export(self, job_id: str, dest: Path, epoch: Optional[int] = None,
               tag: Optional[str] = None) -> Path:
        """Copy a checkpoint to ``dest`` as one portable ``.npz``."""
        src = self.export_path(job_id, epoch=epoch, tag=tag)
        dest = normalize_npz(dest)
        dest.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(src, dest)
        return dest

    @staticmethod
    def load_export(path: Path) -> Checkpoint:
        path = Path(path)
        if not path.exists():
            raise CheckpointNotFoundError(str(path))
        return _read_file(path, "", "")
